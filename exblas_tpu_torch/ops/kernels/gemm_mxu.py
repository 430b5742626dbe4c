"""ExGEMM on the int8 tensor cores: exact Ozaki-Kulisch slices (CUDA,
``csrc/gemm_mxu.cu``), their host-side preparation and the plain version.

Counterpart of ``exblas_tpu/ops/kernels/gemm_mxu.py`` (``gemm_bits_mxu``
and its XLA-level preparation):

* anchors ``E_i`` (max exponent of row i of A) and ``F_j`` (of column j of
  B) and the operands' spreads (:func:`analyze_gemm_operands`);
* each element recoded into ``n_slices + 1`` balanced signed base-256
  digits aligned to its anchor (:func:`make_digits`): digit u has weight
  ``2^(anchor + 1 - 8u)``, u = 0 the carry digit in {-1, 0, 1}.  An element
  is covered iff its lsb lies within ``8 * n_slices`` bits of the anchor;
  the dispatcher (``ops/exgemm.py``) checks coverage, and uncovered data
  must never reach these functions;
* the digit-pair products ``M_st = A_s @ B_t`` summed per class
  ``c = s + t`` and rounded once per element:
  ``sum_c M_c * 2^(E_i + F_j + 2 - 8c)`` (+ the exact ``beta * c``).

:func:`gemm_bits_mxu_cuda` is the port of ``gemm_bits_mxu``: on CUDA
bit tensors it launches the digit kernel (the preparation the JAX package
left to XLA) and, at rung (8, 8) and at the rungs of :data:`WG_RUNGS`, a
wgmma class kernel that rounds in its epilogue, one launch a chunk of
:func:`wg_chunk` k elements; at the wider rungs the mma.sync class kernel
and the rounding kernel.  No fallback; it counts one launch per call.
:func:`gemm_bits_mxu_torch` is its plain version: :func:`mxu_operands`,
then the class sums chunk by chunk by float64 matrix products of the digit
planes, which are exact (every partial sum is an integer below 2^53:
``|M_c| < 2^14 * 49 * k``), then the same combination and rounding.
:func:`excess_digits` is the plain model of the kernels' recode
(``csrc/mxu.cuh``), held against :func:`make_digits`.
"""

from __future__ import annotations

import dataclasses

import torch

from ...core import deposit as dep
from ...core.ieee import FRAC_MASK, decode_fields
from ...core.rounding import canonicalize_digits, round_digits_to_f64_bits
from ...core.types import DOT_FORMAT, LIMB_BITS, LIMB_MASK
from ...utils import profiling
from . import _build
from ._build import ptr, stream_of
from .gemm_kernel import _beta_code, check_cuda_bits

__all__ = ["analyze_gemm_operands", "make_digits", "excess_digits",
           "exact_chunk", "wg_chunk", "wg_chunks", "wg_words", "MXU_LADDER",
           "WG_RUNGS", "mxu_l_rel", "MXU_BETA_HEAD", "MxuOperands",
           "mxu_operands", "mxu_operands_cuda", "gemm_bits_mxu_cuda",
           "gemm_bits_mxu_torch"]

TILE = 32           # output tile of the class kernel; k step of one mma
ROW_TILE = 64       # rows of the rung (8, 8) class kernel's tile
MAX_REL_LIMBS = 48  # kMaxRel in csrc/gemm_mxu.cu
# int64 class sums the other rungs hold at once; more rows run in turns
CLS_BYTES = 1 << 32


def exact_chunk(sa: int, sb: int) -> int:
    """The most k elements (a power of two) over which rung (sa, sb)'s
    int32 class sums are exact: a class takes at most min(sa, sb) + 1
    digit pairs of |d_s d_t| <= 2^14 per k element, so
    ``kc * (min(sa, sb) + 1) * 2^14 < 2^31``."""
    allowed = ((1 << 31) - 1) // ((min(sa, sb) + 1) << 14)
    return 1 << (allowed.bit_length() - 1)


# k elements a launch of the rung (8, 8) class kernel covers: its class
# sums stay in int32 registers over one chunk.  No bit depends on it; the
# tests shrink it to show that.
K_CHUNK = exact_chunk(8, 8)

# (sa, sb) slice-count rungs of the dispatcher (ops/exgemm.py), ordered by
# cost (sa+1)*(sb+1).
MXU_LADDER = ((8, 8), (8, 12), (12, 8), (8, 16), (16, 8),
              (12, 12), (12, 16), (16, 12), (16, 16),
              (16, 20), (20, 16), (20, 20), (24, 24), (28, 28), (32, 32),
              (40, 40), (48, 48))

# The rungs besides (8, 8) whose class sums a wgmma kernel holds in
# registers and rounds in its epilogue (csrc/gemm_mxu.cu wgw::wide_kernel,
# one instance a rung of EXBLAS_WG_RUNGS, in this order); the wider rungs
# run the mma.sync class kernel, an int64 class-sum buffer and the rounding
# kernel.
WG_RUNGS = tuple(r for r in MXU_LADDER if r != (8, 8) and max(r) <= 16)


def wg_chunk(sa: int, sb: int) -> int:
    """k elements a launch of the wgmma kernel of rung (sa, sb) covers:
    the rung's exact chunk, or :data:`K_CHUNK` if that is smaller."""
    return min(K_CHUNK, exact_chunk(sa, sb))


def wg_chunks(sa: int, sb: int, k_pad: int) -> list[tuple[int, int]]:
    """(k0, k_len) of each launch of the wgmma kernel of rung (sa, sb)
    over k_pad (a multiple of TILE) k elements: chunks of
    :func:`wg_chunk`, the last one shorter."""
    chunk = wg_chunk(sa, sb)
    if chunk % TILE or chunk <= 0:
        raise ValueError(f"gemm_bits_mxu_cuda: chunk {chunk} is not a "
                         f"positive multiple of {TILE}")
    return [(k0, min(chunk, k_pad - k0)) for k0 in range(0, k_pad, chunk)]


def wg_words(sa: int, sb: int) -> int:
    """64-bit words that hold an element's exact value at rung (sa, sb) in
    units of 2^(e_base - 8(sa+sb)): below 2^(8(sa+sb) + 38), since k is
    below 2^22 and beta*c reaches at most :data:`MXU_BETA_HEAD` bits above
    the anchor, plus a sign bit (the kernels' ``kWords``)."""
    return (8 * (sa + sb) + 39 + 63) // 64

# Bits of headroom above the anchor that beta*C products may occupy (the
# three extra limbs of mxu_l_rel minus two limbs' carry slack).
MXU_BETA_HEAD = 36


def _exp_msb(bits):
    """(e, valid, special): the exponent of each element's leading bit
    (int64), whether the element is finite and nonzero, and whether it is
    NaN or Inf.  A subnormal's leading bit is found exactly through the
    float64 exponent of its integer fraction (< 2^52, exact in float64)."""
    expf = (bits >> 52) & 0x7FF
    frac = bits & FRAC_MASK
    special = expf == 0x7FF
    valid = ~special & ((expf != 0) | (frac != 0))
    msb = (frac.to(torch.float64).view(torch.int64) >> 52) - 1023
    return torch.where(expf == 0, msb - 1074, expf - 1023), valid, special


def _anchor_spread(bits, dim: int):
    """Anchors along ``dim`` (largest leading-bit exponent; -10000 where
    every element is zero or special) and the operand's spread: the
    largest anchor - element lsb + 1, i.e. anchor - smallest exponent + 53
    over the rows (or columns) that hold a finite nonzero element."""
    e, valid, special = _exp_msb(bits)
    anchor = torch.where(valid, e, -10000).amax(dim=dim)
    low = torch.where(valid, e, 10000).amin(dim=dim)
    spread = torch.where(anchor > -10000, anchor - low + 53, 0).amax()
    return anchor, spread, special.any()


def analyze_gemm_operands(a_bits, b_bits):
    """Anchors and coverage spreads of A (m, k) and B (k, n): (ea (m,),
    fb (n,), spread_a, spread_b, has_special), int64/bool tensors.
    spread_x is the largest (anchor - element lsb exponent + 1) over x's
    nonzero finite elements (lsb taken as e_msb - 52, conservative for
    trailing zeros); rung (sa, sb) covers spread_a <= 8 sa and
    spread_b <= 8 sb."""
    ea, spread_a, spec_a = _anchor_spread(a_bits, 1)
    fb, spread_b, spec_b = _anchor_spread(b_bits, 0)
    return ea, fb, spread_a, spread_b, spec_a | spec_b


def _extract8(mant, s):
    """Bits [s, s + 8) of the 53-bit significands ``mant``; 0 past bit 60."""
    up = ((mant << (-s).clamp(0, 62)) & 0xFF)
    down = ((mant >> s.clamp(0, 62)) & 0xFF)
    return torch.where(s < 0, up, down)


def make_digits(bits, anchors, n_slices: int, axis: int):
    """Balanced signed base-256 digits as int8 (n_slices + 1, *bits.shape).

    Digit u holds weight 2^(anchor + 1 - 8u); u = 0 is the carry digit in
    {-1, 0, 1}, u >= 1 the recoded bytes, each in [-128, 127].  The recode
    is exact for covered elements; zeros and specials give zero digits.
    axis=0: one anchor per row ((m,)); axis=1: one per column ((k,))."""
    sign, expf, mant = decode_fields(bits)
    e_lsb = expf.clamp(min=1) - 1075
    anc = anchors[:, None] if axis == 0 else anchors[None, :]
    sgn = 1 - 2 * sign
    valid = (expf != 0x7FF) & ((expf != 0) | (mant != 0))
    out = [None] * (n_slices + 1)
    carry = torch.zeros_like(sgn)
    for s in reversed(range(n_slices)):  # least significant slice first
        cut = anc + 1 - 8 * (s + 1)
        byte = torch.where(valid, _extract8(mant, cut - e_lsb), 0)
        t = sgn * byte + carry               # in [-256, 256]
        d = ((t + 128) & 255) - 128          # in [-128, 127]
        carry = (t - d) >> 8                 # in {-1, 0, 1}
        out[s + 1] = d.to(torch.int8)
    out[0] = carry.to(torch.int8)
    return torch.stack(out)


def _excess_limb(nb, i: int):
    """Limb i (bytes 4i..4i+3) of sum_{j < nb} 128 * 256^j, per element."""
    limb = torch.zeros_like(nb)
    for j in range(4):
        limb = limb + torch.where(4 * i + j < nb, 0x80 << (8 * j), 0)
    return limb


def _sext8(byte):
    return byte - ((byte >> 7) << 8)


def excess_digits(bits, anchors, n_slices: int, axis: int):
    """The kernels' recode (``csrc/mxu.cuh``), in plain PyTorch: the
    digits of :func:`make_digits` as int8 (n_slices + 1, *bits.shape).

    V, the element's window integer (x over its lowest digit weight,
    truncated toward zero below the window), plus sum_{u=1..ns} 128 *
    256^(ns - u) is W: byte j of W XOR 0x80 is digit ns - j, and
    W >> 8 ns is the carry digit.  W is formed on a frame of at most 15
    bytes from the byte b0 where the significand's lowest bit lands (here
    as four 32-bit limbs with carries); outside it every byte is 0x80."""
    sign, expf, mant = decode_fields(bits)
    anc = (anchors[:, None] if axis == 0 else anchors[None, :]).to(torch.int64)
    sh = expf.clamp(min=1) + (8 * n_slices - 1076) - anc
    f = torch.where(expf == 0x7FF, 0, mant)
    up = sh >= 0
    b0 = torch.where(up, sh >> 3, 0)
    f = torch.where(up, f << (sh & 7), f >> (-sh).clamp(0, 63))
    beyond = b0 >= n_slices
    f = torch.where(beyond, 0, f)
    b0 = torch.where(beyond, 0, b0)
    nb = (n_slices - b0).clamp(max=15)
    sgn = 1 - 2 * sign
    limbs, carry = [], torch.zeros_like(f)
    for i in range(4):
        fl = (f >> (32 * i)) & 0xFFFFFFFF if i < 2 else 0
        t = _excess_limb(nb, i) + sgn * fl + carry
        limbs.append(t & 0xFFFFFFFF)
        carry = t >> 32
    w = torch.stack(limbs, dim=-1)

    def byte(j):  # byte j (0 <= j < 16) of W's two's complement
        jj = j.clamp(0, 15)
        limb = w.gather(-1, (jj >> 2).unsqueeze(-1)).squeeze(-1)
        return (limb >> (8 * (jj & 3))) & 0xFF

    out = []
    for u in range(n_slices + 1):
        if u == 0:
            d = torch.where(b0 + nb == n_slices, _sext8(byte(nb)), 0)
        else:
            i = n_slices - u - b0
            d = torch.where((i >= 0) & (i < nb), _sext8(byte(i) ^ 0x80), 0)
        out.append(d.to(torch.int8))
    return torch.stack(out)


def _spill_run(sa: int, sb: int) -> int:
    """The JAX package's k elements between spills of its int32 class sums
    (``run * (min(sa, sb) + 1) <= 36000`` keeps them below 2^29.2); the
    class kernel of the rungs other than (8, 8) widens on it too."""
    allowed = 36000 // (min(sa, sb) + 1)
    return max(256, 1 << (allowed.bit_length() - 1))


def mxu_l_rel(sa: int, sb: int, beta_mode: str, k_pad: int) -> int:
    """Relative-accumulator depth (limbs) for a digit configuration.

    Class deposits land in [0, rel0 + 42] bits; the exact value is below
    k * 2^e_base, i.e. relative bit rel0 + ceil(log2 k).  beta*C products
    may reach MXU_BETA_HEAD bits above the anchor (coverage-checked by the
    dispatcher), so the beta modes carry three extra limbs."""
    rel0 = 8 * (sa + sb)
    klog = max(k_pad - 1, 1).bit_length()
    l_rel = (rel0 + max(klog + 1, 8) + 2) // LIMB_BITS + 2
    if beta_mode != "zero":
        l_rel += 3
    return l_rel


@dataclasses.dataclass
class MxuOperands:
    """Digit planes of one rung, padded for the class kernel: ``ad`` int8
    (sa+1, m_pad, k_pad) and ``bd`` int8 (sb+1, n_pad, k_pad) (B transposed,
    k contiguous), the row and column anchors ``ea`` (m,) and ``fb`` (n,)
    as int32, and the true sizes."""

    ad: torch.Tensor
    bd: torch.Tensor
    ea: torch.Tensor
    fb: torch.Tensor
    sa: int
    sb: int
    m: int
    n: int
    k: int


def _pad_to(x: int, step: int) -> int:
    return max(step, -(-x // step) * step)


def _anchors(z_bits, b_bits, ea, fb):
    """The anchors with all-zero rows and columns set to 0 (the
    dispatcher's, when it passes them)."""
    if ea is None or fb is None:
        ea, fb, _, _, _ = analyze_gemm_operands(z_bits, b_bits)
        ea = torch.where(ea < -9000, 0, ea)
        fb = torch.where(fb < -9000, 0, fb)
    return ea, fb


def _operands(z_bits, b_bits, sa, sb, ea, fb, digits) -> MxuOperands:
    m, k = z_bits.shape
    n = b_bits.shape[1]
    ea, fb = _anchors(z_bits, b_bits, ea, fb)
    m_pad, n_pad = _pad_to(m, ROW_TILE), _pad_to(n, TILE)
    k_pad = _pad_to(k, TILE)
    return MxuOperands(ad=digits(z_bits, ea, m_pad, k_pad, sa),
                       bd=digits(b_bits.t(), fb, n_pad, k_pad, sb),
                       ea=ea.to(torch.int32).contiguous(),
                       fb=fb.to(torch.int32).contiguous(),
                       sa=sa, sb=sb, m=m, n=n, k=k)


def _digits_torch(x, anchors, rows_pad, k_pad, slices):
    dev = x.device
    xp = torch.zeros((rows_pad, k_pad), dtype=torch.int64, device=dev)
    xp[:x.shape[0], :x.shape[1]] = x
    ap = torch.zeros(rows_pad, dtype=torch.int64, device=dev)
    ap[:anchors.shape[0]] = anchors
    return make_digits(xp, ap, slices, axis=0)


@profiling.spanned("exblas.launch.mxu_digits_cuda")
def _digits_cuda(x, anchors, rows_pad, k_pad, slices):
    x = x.contiguous()
    anchors = anchors.to(torch.int64).contiguous()
    out = torch.empty((slices + 1, rows_pad, k_pad), dtype=torch.int8,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().mxu_digits_cuda(
            ptr(x), x.shape[0], x.shape[1], ptr(anchors), slices, rows_pad,
            k_pad, ptr(out), stream_of(x.device))
    _build.check(err, "mxu_digits_cuda")
    return out


def mxu_operands(z_bits, b_bits, sa: int, sb: int, ea=None,
                 fb=None) -> MxuOperands:
    """The plain preparation of rung (sa, sb) for z (m, k) and b (k, n)
    bits (:func:`make_digits` on zero-padded copies)."""
    return _operands(z_bits, b_bits, sa, sb, ea, fb, _digits_torch)


def mxu_operands_cuda(z_bits, b_bits, sa: int, sb: int, ea=None,
                      fb=None) -> MxuOperands:
    """:func:`mxu_operands` on CUDA tensors, the digit planes written by
    the digit kernel of ``csrc/gemm_mxu.cu`` (one launch per operand)."""
    return _operands(z_bits, b_bits, sa, sb, ea, fb, _digits_cuda)


def _rel_layout(ops: MxuOperands, beta_mode: str):
    """(rel0, n_cls, limbs of the rounding accumulator)."""
    rel0 = 8 * (ops.sa + ops.sb)
    nl = mxu_l_rel(ops.sa, ops.sb, beta_mode, ops.ad.shape[2]) + 3
    return rel0, ops.sa + ops.sb + 1, nl


def _wg_launches(launch, rung_args: tuple, ops: MxuOperands, c_bits,
                 mode: int, beta: int, out) -> int:
    """The wgmma class kernels' chunk loop: the C entry ``launch`` (its
    rung's arguments ``rung_args`` after the digit planes) once a chunk of
    wg_chunks(sa, sb); more than one chunk carries each element's
    wg_words(sa, sb) exact words in device memory.  Returns the launches."""
    _, m_pad, k_pad = ops.ad.shape
    n_pad = ops.bd.shape[1]
    m, n = ops.m, ops.n
    chunks = wg_chunks(ops.sa, ops.sb, k_pad)
    dev = out.device
    words = (torch.empty((wg_words(ops.sa, ops.sb), m, n), dtype=torch.int64,
                         device=dev) if len(chunks) > 1 else None)
    stream = stream_of(dev)
    for k0, k_len in chunks:
        err = launch(
            ptr(ops.ad), ptr(ops.bd), *rung_args, m_pad, n_pad, k_pad, k0,
            k_len, ptr(ops.ea), ptr(ops.fb), ptr(c_bits) if mode else None,
            beta, mode, m, n, ptr(words) if words is not None else None,
            int(k0 == 0), int(k0 + k_len == k_pad), ptr(out), stream)
        _build.check(err, launch.__name__)
    return len(chunks)


@profiling.spanned("exblas.launch.mxu_gemm88_cuda")
def _gemm88_cuda(ops: MxuOperands, c_bits, mode: int, beta: int,
                 out) -> None:
    """Rung (8, 8): the wgmma class kernel rounds in its epilogue, one
    launch a chunk of K_CHUNK k elements (:func:`_wg_launches`)."""
    _wg_launches(_build.library().mxu_gemm88_cuda, (), ops, c_bits, mode,
                 beta, out)


@profiling.spanned("exblas.launch.mxu_classes_cuda")
def _classes_turn(ops: MxuOperands, r0: int, rr: int, cls) -> None:
    """The class kernel on rows [r0, r0 + rr) of the padded A."""
    _, m_pad, k_pad = ops.ad.shape
    n_pad = ops.bd.shape[1]
    err = _build.library().mxu_classes_cuda(
        ops.ad.data_ptr() + r0 * k_pad, ptr(ops.bd), ops.sa, ops.sb,
        m_pad * k_pad, n_pad * k_pad, rr, n_pad, k_pad,
        _spill_run(ops.sa, ops.sb), ptr(cls), stream_of(cls.device))
    _build.check(err, "mxu_classes_cuda")


@profiling.spanned("exblas.launch.mxu_round_cuda")
def _round_turn(ops: MxuOperands, r0: int, rr: int, cls, c_bits, mode: int,
                beta: int, nl: int, rel0: int, out) -> None:
    """The rounding kernel on the class sums of rows [r0, r0 + rr)."""
    m, n = ops.m, ops.n
    err = _build.library().mxu_round_cuda(
        ptr(cls), cls.shape[0], rr, cls.shape[2], ops.ea.data_ptr() + 4 * r0,
        ptr(ops.fb), c_bits.data_ptr() + 8 * r0 * n if mode else None,
        beta, mode, min(rr, m - r0), n, nl, rel0,
        out.data_ptr() + 8 * r0 * n, stream_of(cls.device))
    _build.check(err, "mxu_round_cuda")
    gemm_bits_mxu_cuda.round_launches += 1


@profiling.spanned("exblas.launch.mxu_gemm_wide_cuda")
def _gemm_wide_cuda(ops: MxuOperands, c_bits, mode: int, beta: int,
                    out) -> None:
    """The rungs of WG_RUNGS: the wgmma class kernel rounds in its
    epilogue, one launch a chunk of wg_chunk(sa, sb) k elements
    (:func:`_wg_launches`), counted in ``wg_launches``."""
    gemm_bits_mxu_cuda.wg_launches += _wg_launches(
        _build.library().mxu_gemm_wide_cuda, (ops.sa, ops.sb), ops, c_bits,
        mode, beta, out)


def _gemm_classes_cuda(ops: MxuOperands, c_bits, mode: int, beta: int,
                       beta_mode: str, out) -> None:
    """The rungs wider than (16, 16): int64 class sums in device memory,
    taken in turns of rows below CLS_BYTES, then the rounding kernel."""
    rel0, n_cls, nl = _rel_layout(ops, beta_mode)
    if nl > MAX_REL_LIMBS:
        raise ValueError(f"gemm_bits_mxu_cuda: {nl} accumulator limbs "
                         f"exceed {MAX_REL_LIMBS}")
    m_pad, n_pad = ops.ad.shape[1], ops.bd.shape[1]
    rows = min(m_pad, max(ROW_TILE, CLS_BYTES // (8 * n_cls * n_pad)
                          // ROW_TILE * ROW_TILE))
    cls = torch.empty((n_cls, rows, n_pad), dtype=torch.int64,
                      device=out.device)
    gemm_bits_mxu_cuda.class_buffers += 1
    for r0 in range(0, ops.m, rows):
        rr = min(rows, m_pad - r0)
        _classes_turn(ops, r0, rr, cls)
        _round_turn(ops, r0, rr, cls, c_bits, mode, beta, nl, rel0, out)


def gemm_bits_mxu_cuda(z_bits, b_bits, c_bits, beta_bits: int,
                       beta_mode: str, sa: int, sb: int, ea=None,
                       fb=None) -> torch.Tensor:
    """Exact ExGEMM of covered CUDA bit tensors z (m, k), b (k, n), c (m, n)
    at rung (sa, sb) -> (m, n) int64 bits: the digit kernel, then at rung
    (8, 8) and the rungs of WG_RUNGS a wgmma class kernel that rounds in
    its epilogue, at the wider rungs the mma.sync class kernel and the
    rounding kernel.  No specials: the dispatcher overrides those elements.
    ``ea``/``fb``: the dispatcher's anchors, if any.  Besides ``launches``,
    the wrapper counts the launches of the WG_RUNGS kernel
    (``wg_launches``), the int64 class-sum buffers it allocates
    (``class_buffers``) and the rounding kernel's launches
    (``round_launches``): the rungs up to (16, 16) need neither of the
    last two."""
    m, k = z_bits.shape
    n = b_bits.shape[1]
    check_cuda_bits(z_bits, "gemm_bits_mxu_cuda", (m, k))
    check_cuda_bits(b_bits, "gemm_bits_mxu_cuda", (k, n))
    mode, beta = _beta_code(beta_bits, beta_mode)
    if mode:
        check_cuda_bits(c_bits, "gemm_bits_mxu_cuda", (m, n))
    with profiling.annotate("exblas.gemm.digits"):
        ops = mxu_operands_cuda(z_bits, b_bits, sa, sb, ea, fb)
    out = torch.empty((m, n), dtype=torch.int64, device=z_bits.device)
    if m * n == 0:
        return out
    with torch.cuda.device(z_bits.device), profiling.annotate(
            "exblas.gemm.classes"):
        if (sa, sb) == (8, 8):
            _gemm88_cuda(ops, c_bits, mode, beta, out)
        elif (sa, sb) in WG_RUNGS:
            _gemm_wide_cuda(ops, c_bits, mode, beta, out)
        else:
            _gemm_classes_cuda(ops, c_bits, mode, beta, beta_mode, out)
    gemm_bits_mxu_cuda.launches += 1
    return out


gemm_bits_mxu_cuda.launches = 0
gemm_bits_mxu_cuda.wg_launches = 0
gemm_bits_mxu_cuda.class_buffers = 0
gemm_bits_mxu_cuda.round_launches = 0


def class_sums_torch(ops: MxuOperands) -> torch.Tensor:
    """int64 (n_cls, m, n): M_c = sum_{s+t=c} A_s @ B_t, by float64
    matrix products of the digit planes (exact, see the module doc), one
    chunk of K_CHUNK k elements at a time, as the rung (8, 8) kernel
    takes them."""
    m, n, k, sa, sb = ops.m, ops.n, ops.k, ops.sa, ops.sb
    cls = torch.zeros((sa + sb + 1, m, n), dtype=torch.int64,
                      device=ops.ad.device)
    for k0 in range(0, k, K_CHUNK):
        k1 = min(k, k0 + K_CHUNK)
        ad = ops.ad[:, :m, k0:k1].to(torch.float64)
        bstack = ops.bd[:, :n, k0:k1].to(torch.float64).reshape(
            (sb + 1) * n, k1 - k0)
        part = torch.zeros((sa + sb + 1, m, n), dtype=torch.float64,
                           device=ad.device)
        for s in range(sa + 1):
            p = (ad[s] @ bstack.t()).reshape(m, sb + 1, n).permute(1, 0, 2)
            part[s:s + sb + 1] += p
        cls += part.to(torch.int64)
    return cls


def gemm_bits_mxu_torch(z_bits, b_bits, c_bits, beta_bits: int,
                        beta_mode: str, sa: int, sb: int, ea=None,
                        fb=None) -> torch.Tensor:
    """Plain version of :func:`gemm_bits_mxu_cuda` on any device."""
    ops = mxu_operands(z_bits, b_bits, sa, sb, ea, fb)
    m, n = ops.m, ops.n
    rel0, n_cls, nl = _rel_layout(ops, beta_mode)
    cls = class_sums_torch(ops).reshape(n_cls, m * n)
    limbs = torch.zeros((m * n, nl), dtype=torch.int64, device=cls.device)
    for c in range(n_cls):  # class c sits at relative bit rel0 - 8c
        q, r = divmod(rel0 - 8 * c, LIMB_BITS)
        w = cls[c] * (1 << r)  # |w| < 2^62
        limbs[:, q] += w & LIMB_MASK
        limbs[:, q + 1] += (w >> LIMB_BITS) & LIMB_MASK
        limbs[:, q + 2] += w >> (2 * LIMB_BITS)
    e_base = (ops.ea.to(torch.int64)[:, None]
              + ops.fb.to(torch.int64)[None, :] + 2).reshape(-1)
    if beta_mode != "zero":
        _, beta = _beta_code(beta_bits, beta_mode)
        c = c_bits.reshape(-1)
        t = dep.product_terms(torch.full_like(c, beta), c, rel0 - e_base)
        seg = torch.arange(m * n, device=c.device) * nl
        dep.segment_deposit_products(limbs.view(-1), t, seg)
    digits, negative = canonicalize_digits(limbs)
    bits = round_digits_to_f64_bits(digits, negative, DOT_FORMAT,
                                    offset_bits=rel0 - e_base)
    return bits.reshape(m, n)
