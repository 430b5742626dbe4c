"""ExGEMV on the int8 tensor cores: the row analysis B8 and the byte-plane
kernel B9 (CUDA, ``csrc/gemv_mxu.cu``), their host-side preparation and
their plain versions.

Counterparts of ``exblas_tpu/ops/kernels/gemv_mxu.py``:

* :func:`analyze_gemv_rows_cuda` <- ``_analyze_rows_stats`` (via
  ``analyze_gemv_rows``): per row of A the anchor ``ea`` (the largest
  ``max(expf, 1) - 1023`` over its non-special elements, zeros included;
  -10000 when there is none), and over A the spread (the largest
  ``ea - (max(expf, 1) - 1075) + 1`` over finite nonzero elements) and
  whether any element is NaN or Inf.  The JAX package reads only the high
  words first and touches the low words in a second pass for elements
  whose high word is all zero; with the whole 64-bit word in hand that
  second pass adds nothing, so this is one pass.
* :func:`analyze_z`: the z anchor ``f`` (the largest leading-bit exponent),
  z's spread and special flag (host-side, as in the JAX package).
* :func:`gemv_bits_mxu_cuda` <- ``gemv_bits_mxu``: the exact A @ z of data
  the dispatcher found covered by rung (nwa, nwz).  Each A element is
  recoded into ``4*nwa + 1`` balanced signed base-256 digits anchored at
  its row's ``ea`` and z into ``4*nwz + 1`` anchored at ``f``
  (``gemm_mxu.make_digits``'s recode): digit s of A has weight
  ``2^(ea + 1 - 8s)``, digit t of z ``2^(f + 1 - 8t)``, so

      y_i = sum_c M_c[i] * 2^(e_base_i - 8c),   e_base_i = ea_i + f + 2,
      M_c[i] = sum_{s+t=c} sum_k A_s[i,k] * Z_t[k],

  rounded once per row (beta == 0), or moved into the absolute DOT_FORMAT
  accumulator with the exact ``beta * y_i`` and rounded there
  (``_apply_beta_rows``, ``round_rows``): beta*y needs no coverage.

The TPU kernel's sign-mask matmul, f32 byte-lane fold and int32 limb
spills served its int32-only vector unit and are gone; its excess-128
recode stays, as the kernels' way to the balanced digits
(``gemm_mxu.excess_digits`` is its plain model).  The digit recode, the
class sums and the rounding are what is left.
``gemv_bits_mxu_torch`` is the plain version: :func:`make_digits`, the
digit-pair sums by float64 matrix products (exact: every partial sum is an
integer below 2^53), the same combination and rounding.  The data must be
covered and free of specials' influence: NaN/Inf elements give zero
digits, and the dispatcher overrides those rows.
"""

from __future__ import annotations

import torch

from ...core.rounding import (canonicalize_digits, rel_limbs_to_abs_limbs,
                              round_digits_to_f64_bits)
from ...core.types import DOT_FORMAT, LIMB_BITS, LIMB_MASK, N_SPECIAL
from ...utils import profiling
from ..exgemv import _GEMV_RUNGS, _apply_beta_rows, round_rows
from . import _build
from ._build import ptr, stream_of
from .gemm_kernel import _beta_code, check_cuda_bits
from .gemm_mxu import _digits_cuda, _exp_msb, make_digits

__all__ = ["analyze_gemv_rows_cuda", "analyze_gemv_rows_torch", "analyze_z",
           "make_z_digits", "gemv_bits_mxu_cuda", "gemv_bits_mxu_torch",
           "MAX_K_MXU"]

# The JAX package's cap on the padded k (1024 spills of 32768 columns),
# kept so that both packages route alike.  The int64 class sums here hold
# far more.
SPILL_K = 32768
MAX_K_MXU = 1024 * SPILL_K
KS = 64             # k step of the class kernel (two mma k-steps of 32)
# k elements between widenings of the int32 digit-pair sums (a warp's own
# k at rung (2, 2), a block's at the others): a multiple of KS, at most
# 2^16 (|A_s Z_t| <= 2^14).  No bit depends on it; the tests shrink it to
# show that.
K_CHUNK = 1 << 16
MAX_REL_LIMBS = 48  # kMaxRel in csrc/gemv_mxu.cu
E_SENT = -10000     # row anchor of a row without a non-special element
LSB_SENT = 10000
# Digit planes of A the plain version holds at once, in elements.
DIGITS_PER_PASS = 1 << 24


def _rung_params(nwa: int, nwz: int, k_pad: int = SPILL_K):
    """The JAX package's static rung geometry (w_a, w_z, ns, nz, r0,
    l_rel): ns = 4*nwa digits of A below its carry digit, nz = 4*nwz + 1
    digits of z, r0 = w_a + w_z relative bits below e_base.  l_rel sizes
    the JAX kernel's int32 accumulator and is unused here."""
    w_a = 32 * nwa
    w_z = 32 * nwz
    ns = w_a // 8
    nz = w_z // 8 + 1
    r0 = w_a + w_z
    extra = max(0, (max(k_pad, 1) - 1).bit_length() - 15)
    top_bit = max(8 * (ns + nz - 2) + 30 + extra,
                  w_a + 8 * (nz - 1) + 23 + extra)
    l_rel = -(-(top_bit + 2) // LIMB_BITS) + 1
    return w_a, w_z, ns, nz, r0, l_rel


def rel_limbs_count(r0: int) -> int:
    """Limbs of the relative accumulator of a rung with r0 relative bits:
    class 0 deposits at bit r0 reach limb r0 // 20 + 3 (two pieces of 20
    bits, three limbs each), and the exact value, below k * 2^e_base
    (k <= 2^25), needs r0 + 27 bits with its sign."""
    return r0 // LIMB_BITS + 5


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------

def analyze_gemv_rows_torch(a_bits):
    """Plain version of :func:`analyze_gemv_rows_cuda` on any device:
    (ea int32 (m,), spread int32, has_special bool), 0-dim tensors for the
    last two.  a (m, k) int64 bits, k >= 1."""
    expf = (a_bits >> 52) & 0x7FF
    special = expf == 0x7FF
    eb = expf.clamp(min=1)
    ea = torch.where(special, E_SENT, eb - 1023).amax(dim=1)
    finite_nonzero = ~special & ((a_bits & ((1 << 63) - 1)) != 0)
    lsb = torch.where(finite_nonzero, eb - 1075, LSB_SENT).amin(dim=1)
    spread = torch.where(lsb < LSB_SENT, ea - lsb + 1, 0).amax()
    return (ea.to(torch.int32), spread.to(torch.int32), special.any())


@profiling.spanned("exblas.launch.gemv_analyze_cuda")
def analyze_gemv_rows_cuda(a_bits):
    """Kernel B8 on a contiguous CUDA int64 tensor a (m, k), k >= 1: one
    pass over A, then one over the rows.  Returns what
    :func:`analyze_gemv_rows_torch` returns, on the device."""
    m, k = a_bits.shape
    check_cuda_bits(a_bits, "analyze_gemv_rows_cuda", (m, k))
    dev = a_bits.device
    ea = torch.full((m,), E_SENT, dtype=torch.int32, device=dev)
    lsb = torch.full((m,), LSB_SENT, dtype=torch.int32, device=dev)
    flags = torch.zeros(m, dtype=torch.int32, device=dev)
    stats = torch.zeros(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().gemv_analyze_cuda(
            ptr(a_bits), m, k, ptr(ea), ptr(lsb), ptr(flags), ptr(stats),
            stream_of(dev))
    _build.check(err, "gemv_analyze_cuda")
    analyze_gemv_rows_cuda.launches += 1
    return ea, stats[0], stats[1] > 0


analyze_gemv_rows_cuda.launches = 0


def analyze_z(z_bits):
    """(f, spread, has_special) of z (k,) int64 bits, k >= 1: the largest
    leading-bit exponent over finite nonzero elements (-10000 if none),
    the largest f - lsb + 1 over them, and whether any element is NaN or
    Inf; int32 / int32 / bool 0-dim tensors."""
    e, valid, special = _exp_msb(z_bits)
    f = torch.where(valid, e, E_SENT).amax()
    lsb = ((z_bits >> 52) & 0x7FF).clamp(min=1) - 1075
    spread = torch.where(valid, f - lsb + 1, 0).amax()
    return f.to(torch.int32), spread.to(torch.int32), special.any()


def make_z_digits(z_bits, f, nwz: int):
    """The 4*nwz + 1 balanced signed base-256 digits of z (k,) anchored at
    f: int8 (4*nwz + 1, k), digit u of weight 2^(f + 1 - 8u), u = 0 the
    carry digit.  JAX's ``make_z_digits`` returns the same digits
    least significant first."""
    return make_digits(z_bits.reshape(1, -1),
                       f.to(torch.int64).reshape(1), 4 * nwz, axis=0)[:, 0]


# ---------------------------------------------------------------------------
# The byte-plane kernel
# ---------------------------------------------------------------------------

def class_sums_torch(a_bits, ea, zd, nwa: int):
    """int64 (m, 4*nwa + nz): M_c[i] = sum_{s+t=c} sum_k A_s[i,k] Z_t[k]
    for z digits ``zd`` (nz, k), by float64 matrix products of the digit
    planes over k chunks of ``K_CHUNK`` (exact, see the module doc)."""
    m, k = a_bits.shape
    ns1, nt = 4 * nwa + 1, zd.shape[0]
    dev = a_bits.device
    cls = torch.zeros((m, ns1 + nt - 1), dtype=torch.int64, device=dev)
    zf = zd.to(torch.float64)
    rows = max(1, DIGITS_PER_PASS // (max(k, 1) * ns1))
    for r0 in range(0, m, rows):
        r1 = min(m, r0 + rows)
        ad = make_digits(a_bits[r0:r1], ea[r0:r1].to(torch.int64), 4 * nwa,
                         axis=0)
        for k0 in range(0, k, K_CHUNK):
            k1 = min(k, k0 + K_CHUNK)
            p = torch.matmul(ad[:, :, k0:k1].to(torch.float64),
                             zf[:, k0:k1].t()).to(torch.int64)
            for s in range(ns1):
                cls[r0:r1, s:s + nt] += p[s]
    return cls


def _rel_limbs(cls, r0: int):
    """The class sums as relative limbs (m, rel_limbs_count(r0)): class c
    at relative bit r0 - 8c (|M_c| < 29 * 2^39, so M_c * 2^19 < 2^63)."""
    m, n_cls = cls.shape
    limbs = torch.zeros((m, rel_limbs_count(r0)), dtype=torch.int64,
                        device=cls.device)
    for c in range(n_cls):
        q, r = divmod(r0 - 8 * c, LIMB_BITS)
        w = cls[:, c] * (1 << r)
        limbs[:, q] += w & LIMB_MASK
        limbs[:, q + 1] += (w >> LIMB_BITS) & LIMB_MASK
        limbs[:, q + 2] += w >> (2 * LIMB_BITS)
    return limbs


def _check_rung(nwa: int, nwz: int, name: str) -> None:
    if (nwa, nwz) not in _GEMV_RUNGS:
        raise ValueError(f"{name}: no rung ({nwa}, {nwz}); the rungs are "
                         f"{_GEMV_RUNGS}")


def gemv_bits_mxu_torch(a_bits, z_bits, ea, f, y_bits, beta_bits: int,
                        beta_mode: str, nwa: int, nwz: int) -> torch.Tensor:
    """Plain version of :func:`gemv_bits_mxu_cuda` on any device."""
    _check_rung(nwa, nwz, "gemv_bits_mxu_torch")
    _, _, _, _, r0, _ = _rung_params(nwa, nwz)
    zd = make_z_digits(z_bits, f, nwz)
    cls = class_sums_torch(a_bits, ea, zd, nwa)
    limbs = _rel_limbs(cls, r0)
    e_base = ea.to(torch.int64) + f.to(torch.int64) + 2
    if beta_mode == "zero":
        digits, negative = canonicalize_digits(limbs)
        return round_digits_to_f64_bits(digits, negative, DOT_FORMAT,
                                        offset_bits=r0 - e_base)
    # every row value is a multiple of 2^-2148 (each product is), so the
    # shift into the absolute DOT_FORMAT frame is exact
    limbs = rel_limbs_to_abs_limbs(
        limbs, e_base - r0 + DOT_FORMAT.offset_bits, DOT_FORMAT)
    special = torch.zeros((limbs.shape[0], N_SPECIAL), dtype=torch.int64,
                          device=limbs.device)
    limbs, special = _apply_beta_rows(limbs, special, beta_bits, y_bits,
                                      beta_mode)
    return round_rows(limbs, special)


@profiling.spanned("exblas.launch.gemv_mxu_classes_cuda")
def _gemv_classes(a_bits, ea32, zd, k_pad: int, nwa: int, nwz: int,
                  cls) -> None:
    """The class kernel of :func:`gemv_bits_mxu_cuda`."""
    m, k = a_bits.shape
    err = _build.library().gemv_mxu_classes_cuda(
        ptr(a_bits), ptr(ea32), ptr(zd), m, k, k_pad, nwa, nwz, K_CHUNK,
        ptr(cls), stream_of(cls.device))
    _build.check(err, "gemv_mxu_classes_cuda")


@profiling.spanned("exblas.launch.gemv_mxu_round_cuda")
def _gemv_round(cls, ea32, f32, y_bits, beta: int, mode: int, nl: int,
                r0: int, out) -> None:
    """The rounding kernel of :func:`gemv_bits_mxu_cuda`."""
    err = _build.library().gemv_mxu_round_cuda(
        ptr(cls), cls.shape[1], ptr(ea32), ptr(f32),
        ptr(y_bits) if mode else None, beta, mode, cls.shape[0], nl, r0,
        ptr(out), stream_of(cls.device))
    _build.check(err, "gemv_mxu_round_cuda")


def gemv_bits_mxu_cuda(a_bits, z_bits, ea, f, y_bits, beta_bits: int,
                       beta_mode: str, nwa: int, nwz: int) -> torch.Tensor:
    """Exact y = A @ z (+ beta * y) of covered CUDA bit tensors a (m, k),
    z (k,), y (m,) at rung (nwa, nwz) -> (m,) int64 bits: the z digits
    (``csrc/gemm_mxu.cu``'s digit kernel), the class kernel (int8
    ``mma.sync``; A's digits never reach device memory: at rung (2, 2) they
    are made in registers straight into the mma fragments, at the others
    staged in shared memory) and the rounding kernel.  ``ea`` (m,) and
    ``f`` (0-dim) are the dispatcher's anchors, on the same device."""
    m, k = a_bits.shape
    check_cuda_bits(a_bits, "gemv_bits_mxu_cuda", (m, k))
    check_cuda_bits(z_bits, "gemv_bits_mxu_cuda", (k,))
    _check_rung(nwa, nwz, "gemv_bits_mxu_cuda")
    if (tuple(ea.shape) != (m,) or f.numel() != 1
            or ea.device != a_bits.device or f.device != a_bits.device):
        raise ValueError("gemv_bits_mxu_cuda: ea must be (m,) and f one "
                         "value, on the operands' device")
    if K_CHUNK % KS or not 0 < K_CHUNK <= 1 << 16:
        raise ValueError(f"gemv_bits_mxu_cuda: K_CHUNK {K_CHUNK} is not a "
                         f"multiple of {KS} in (0, 2^16]")
    mode, beta = _beta_code(beta_bits, beta_mode)
    if mode:
        check_cuda_bits(y_bits, "gemv_bits_mxu_cuda", (m,))
    _, _, ns, nz, r0, _ = _rung_params(nwa, nwz)
    nl = rel_limbs_count(r0)
    dev = a_bits.device
    out = torch.empty(m, dtype=torch.int64, device=dev)
    if m == 0:
        return out
    k_pad = max(KS, -(-k // KS) * KS)
    f64 = f.to(torch.int64).reshape(1)
    zd = _digits_cuda(z_bits.reshape(1, k), f64, 1, k_pad, 4 * nwz)
    ea32 = ea.to(torch.int32).contiguous()
    f32 = f.to(torch.int32).reshape(1)
    cls = torch.zeros((m, ns + nz), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _gemv_classes(a_bits, ea32, zd, k_pad, nwa, nwz, cls)
        _gemv_round(cls, ea32, f32, y_bits, beta, mode, nl, r0, out)
    gemv_bits_mxu_cuda.launches += 1
    return out


gemv_bits_mxu_cuda.launches = 0
