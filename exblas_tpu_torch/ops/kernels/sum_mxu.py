"""The anchored-window ExSUM: kernel B11 (CUDA, ``csrc/sum_mxu.cu``), its
plain version, the anchor estimates that route it, and the bits and
Superacc paths built on it.

Counterpart of ``exblas_tpu/ops/kernels/sum_mxu.py``:

* the routing helpers :func:`sample_anchor`, :func:`full_anchor`,
  :func:`resolve_anchor`, :func:`exact_anchor` and their constants, line
  by line (XLA reductions there, PyTorch reductions on the tensor's device
  here).  The JAX package branches on the device; the port on the host,
  so the first three return ints (one read of two reduced values each),
  and only ``exact_anchor``, on the retry path, stays on the device;
* :func:`sum_flat_cuda` <- ``_sum_epilogue_terms`` (``_sum_flat_kernel``):
  every finite element whose bits [e_lsb, e_lsb + 52] (e_lsb from the
  exponent field alone) lie in ONE global window of W = 32 * nwa bits
  below the anchor E + 1 is summed exactly.  The result ``rel`` is
  nwa + 1 int64 terms, term k at relative bit 32 k of the frame whose
  bit 0 has exponent E + 1 - W: the canonical digits of the exact sum,
  terms 0..nwa-1 in [0, 2^32) and term nwa the sum shifted right by W
  bits (floor), so they do not depend on how the kernel split its work.
  ``bad`` is set when a nonzero element is not covered, or any element is
  NaN/Inf; the caller then discards the result.  :func:`sum_flat_torch`
  is its plain version and returns the same terms;
* :func:`sum_bits_mxu` / :func:`sum_acc_limbs_mxu`: the terms rounded
  once, or shifted into absolute SUM_FORMAT limbs
  (``core.rounding.rel_limbs_to_abs_limbs``).  The kernel rounds them in
  its last block with B3's device code, so a window pass is one launch;
  the plain path rounds them with B3's plain version
  (``round_in_kernel.py``).  ``kernels`` picks the CUDA kernel or the
  plain versions, as ``gemm_mxu.py`` does.

The TPU kernel's byte planes, excess-128 compensation and int8 matmul
served its vector unit; the window, its coverage rule and the exact sum
are what is left.
"""

from __future__ import annotations

import torch

from ...core.ieee import f64_bits
from ...core.rounding import rel_limbs_to_abs_limbs
from ...core.types import SUM_FORMAT
from ...utils import profiling
from . import _build
from ._build import check_cuda_f64, ptr, stream_of
from .round_in_kernel import (round_scaled_terms_torch, term_limbs_count,
                              terms_to_limbs)

__all__ = ["sample_anchor", "full_anchor", "resolve_anchor", "exact_anchor",
           "device_anchor", "sum_flat_cuda", "sum_flat_torch",
           "canonical_terms", "sum_bits_mxu", "sum_acc_limbs_mxu",
           "MAX_N_MXU", "NWA_TIERS"]

# The JAX package's bound (int32 plane sums there; int64 word sums here
# hold n <= 2^31), kept so that both packages route alike.
MAX_N_MXU = 1 << 30
NWA_TIERS = (3, 4, 5)

_SAMPLE_CHUNK = 8192     # elements per sampled chunk
_SAMPLE_STRIDE = 8       # read every 8th chunk
_ANCHOR_SLACK = 8        # bits: tolerate a slightly-missed maximum
# A sampled spread this close below a tier boundary is ambiguous and is
# resolved by one exact pass (sum_mxu.py:141-149).
_GUARD_BITS = 16

_CHUNK = 1 << 22         # elements per pass of the plain versions
_M32 = (1 << 32) - 1


def _bits(x: torch.Tensor) -> torch.Tensor:
    return f64_bits(x).reshape(-1)


def _top16(x: torch.Tensor) -> torch.Tensor:
    """The top 16 bits (sign, exponent field, 4 fraction bits) of each
    double of a tensor whose last dimension is contiguous, as int16 (a
    view: the card and the host are little-endian)."""
    return x.view(torch.int16)[..., 3::4]


# ---------------------------------------------------------------------------
# Anchor estimation (sum_mxu.py:60-172)
#
# The reductions run on the tensor's device over the exponent fields only
# (2 bytes of each element's 8 are written); the host reads their two
# results at once and finishes the arithmetic, since it branches on the
# spread anyway.
# ---------------------------------------------------------------------------

_EXP16 = 0x7FF0          # the exponent field within the top 16 bits


def _anchor_spread(top16: torch.Tensor, cause: str):
    """(anchor, spread) as ints: anchor = the largest exponent field -
    1023 + slack; spread = anchor - the smallest lsb exponent over
    exponent fields >= 1, + 1, or 61 when every exponent field is 0 (zeros
    and subnormals fit any window).  One host synchronization, counted
    under ``cause``."""
    e16 = top16 & _EXP16
    # exponent field 0 maps to 2047 here, above every other field's - 1
    stats = torch.stack([e16.amax(), ((e16 - 16) & _EXP16).amin()])
    with profiling.host_sync(cause):
        stats = stats.tolist()
    emax, emin1 = (v >> 4 for v in stats)
    anchor = emax - 1023 + _ANCHOR_SLACK
    if emin1 == 2047:
        return anchor, 61
    return anchor, anchor - (emin1 + 1 - 1075) + 1


def sample_anchor(x: torch.Tensor):
    """Cheap (anchor, spread) estimate, as ints, from every 8th chunk of
    8192 elements plus the last chunk (when there are at least two
    chunks).  The anchor may miss the true maximum (the kernel's flag then
    sends the call to the exact-anchor retry), and a sampled spread can
    only underestimate the true one, so a sampled spread past every window
    proves that none covers the data."""
    x = x.reshape(-1)
    nch = x.numel() // _SAMPLE_CHUNK
    if nch >= 2:
        body = x[:nch * _SAMPLE_CHUNK].view(nch, _SAMPLE_CHUNK)
        x = torch.cat([body[::_SAMPLE_STRIDE],
                       x[-_SAMPLE_CHUNK:].view(1, _SAMPLE_CHUNK)])
    return _anchor_spread(_top16(x), "spread")


def full_anchor(x: torch.Tensor):
    """Exact (anchor, spread) in :func:`sample_anchor`'s convention: one
    pass over every element."""
    return _anchor_spread(_top16(x.reshape(-1)), "guard")


def resolve_anchor(x: torch.Tensor, e_est: int, spread_est: int,
                   boundaries):
    """(anchor, spread) ints for routing: the sampled pair, or the exact
    pair when ``spread_est`` lies in the guard band just below one of the
    tier ``boundaries`` (b - 16 < spread <= b): one more pass and one more
    synchronization."""
    if any(b - _GUARD_BITS < spread_est <= b for b in boundaries):
        return full_anchor(x)
    return e_est, spread_est


def exact_anchor(x: torch.Tensor) -> torch.Tensor:
    """Exact anchor: the max exponent field over every element - 1023, a
    0-dim int32 tensor on the device (no synchronization).  NaN/Inf drive
    it to 1024, which leaves every finite element uncovered."""
    e16 = (_top16(x.reshape(-1)) & _EXP16).amax()
    return ((e16 >> 4).to(torch.int32) - 1023)


def device_anchor(anchor: int, device) -> torch.Tensor:
    """An int anchor as the 0-dim int32 device tensor the kernels read."""
    return torch.full((), anchor, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Kernel B11
# ---------------------------------------------------------------------------

def _check_nwa(nwa: int, name: str) -> None:
    if nwa not in NWA_TIERS:
        raise ValueError(f"{name}: nwa must be one of {NWA_TIERS}, got {nwa}")


def _check_anchor(anchor, device: torch.device, name: str) -> None:
    if (not isinstance(anchor, torch.Tensor) or anchor.numel() != 1
            or anchor.dtype != torch.int32 or anchor.device != device):
        raise ValueError(f"{name}: the anchor must be a one-element int32 "
                         f"tensor on {device}")


@profiling.spanned("exblas.launch.sum_flat_cuda")
def _sum_flat_ws(x: torch.Tensor, anchor: torch.Tensor, nwa: int):
    """One launch of kernel B11; its workspace (nwa + 4 int64): the terms,
    the flag, the bits of the rounded sum, the ticket."""
    check_cuda_f64(x, "sum_flat_cuda")
    _check_nwa(nwa, "sum_flat_cuda")
    n = x.numel()
    if n > MAX_N_MXU:
        raise ValueError(f"sum_flat_cuda: n = {n} > MAX_N_MXU")
    _check_anchor(anchor, x.device, "sum_flat_cuda")
    ws = torch.zeros(nwa + 4, dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().sum_flat_cuda(
            ptr(x), n, ptr(anchor), nwa, ptr(ws), stream_of(x.device))
    _build.check(err, "sum_flat_cuda")
    sum_flat_cuda.launches += 1
    return ws


def ws_flag(ws: torch.Tensor, k: int) -> torch.Tensor:
    """The flag at ws[k], 0 or 1 in the low byte of an int64
    (little-endian), as a 0-dim bool view."""
    return ws.view(torch.bool)[8 * k]


def sum_flat_cuda(x: torch.Tensor, anchor: torch.Tensor, nwa: int):
    """Kernel B11 on a contiguous CUDA float64 tensor, n <= MAX_N_MXU, at
    a 0-dim int32 anchor on the same device: (rel int64 (nwa + 1,), bad
    0-dim bool), both on the device (see the module doc)."""
    ws = _sum_flat_ws(x, anchor, nwa)
    return ws[:nwa + 1], ws_flag(ws, nwa + 1)


sum_flat_cuda.launches = 0


def _shifted_words(limbs16, r, ny: int):
    """The ny 32-bit words (int64 tensors in [0, 2^32)) of
    (sum_k limbs16[k] * 2^(16 k)) * 2^r, per element, for limbs below
    2^35 and r in [0, 32)."""
    r0, r1 = r & 15, r >> 4
    digits, carry = [], 0
    for k in range(2 * ny):
        t = (limbs16[k] << r0 if k < len(limbs16) else 0) + carry
        digits.append(t & 0xFFFF)
        carry = t >> 16
    digits = [torch.where(r1 == 1, digits[k - 1] if k else 0, digits[k])
              for k in range(2 * ny)]
    return [digits[2 * j] | (digits[2 * j + 1] << 16) for j in range(ny)]


def _frame_terms(words, q, neg, nw: int) -> torch.Tensor:
    """rel terms (nw + 1,) of the elements' words placed at word q of an
    nw-word frame, two's complemented where ``neg`` (csrc/anchored.cuh
    add_to_frame): the word sums and minus the negative count."""
    carry = neg.to(torch.int64)
    flip = torch.where(neg, _M32, 0)
    sums = []
    for d in range(nw):
        w = sum(torch.where(q == d - j, y, 0)
                for j, y in enumerate(words) if d - j >= 0)
        t = (w ^ flip) + carry
        sums.append((t & _M32).sum())
        carry = t >> 32
    sums.append(-neg.sum())
    return torch.stack(sums)


def _decode(bits, e_base, w: int):
    """(m, sh, covered-and-nonzero, bad) of int64 bits against the window
    of w bits whose bit 0 has exponent ``e_base``."""
    expf = (bits >> 52) & 0x7FF
    special = expf == 0x7FF
    frac = bits & ((1 << 52) - 1)
    m = torch.where(special, 0, torch.where(expf != 0, frac | (1 << 52),
                                            frac))
    sh = expf.clamp(min=1) - 1075 - e_base
    nz = m != 0
    inside = (sh >= 0) & (sh <= w - 53)
    return m, sh, nz & inside, special | (nz & ~inside)


def canonical_terms(rel: torch.Tensor) -> torch.Tensor:
    """The canonical form of frame terms (term k at bit 32 k) of the same
    value: one carry pass, every term but the last in [0, 2^32) and the
    last the value >> 32 (len - 1) (floor), as the last blocks of kernels
    B11 and B12 write them (``round.cuh`` ``finish_frame``)."""
    out, carry = [], torch.zeros((), dtype=torch.int64, device=rel.device)
    for k in range(rel.numel() - 1):
        t = rel[k] + carry
        out.append(t & _M32)
        carry = t >> 32
    out.append(rel[-1] + carry)
    return torch.stack(out)


def sum_flat_torch(x: torch.Tensor, anchor, nwa: int):
    """Plain version of :func:`sum_flat_cuda` on any device: the same
    terms and flag (``anchor`` an int or a one-element tensor).  The sum
    is formed as W-bit two's-complement word sums and minus the negative
    count (:func:`_frame_terms`) and carried into canonical terms."""
    _check_nwa(nwa, "sum_flat_torch")
    bits = _bits(x)
    w = 32 * nwa
    e_base = torch.as_tensor(anchor, device=bits.device).to(
        torch.int64).reshape(()) + (1 - w)
    rel = torch.zeros(nwa + 1, dtype=torch.int64, device=bits.device)
    bad = torch.zeros((), dtype=torch.bool, device=bits.device)
    for c in range(0, bits.numel(), _CHUNK):
        b = bits[c:c + _CHUNK]
        m, sh, add, bad_c = _decode(b, e_base, w)
        m = torch.where(add, m, 0)
        sh = torch.where(add, sh, 0)
        words = _shifted_words([(m >> (16 * k)) & 0xFFFF for k in range(4)],
                               sh & 31, 3)
        rel += _frame_terms(words, sh >> 5, add & (b < 0), nwa)
        bad |= bad_c.any()
    return canonical_terms(rel), bad


# ---------------------------------------------------------------------------
# The bits and Superacc paths
# ---------------------------------------------------------------------------

def frame_positions(nw: int) -> tuple:
    """Relative bit positions of the nw + 1 frame terms."""
    return tuple(32 * k for k in range(nw + 1))


def sum_bits_mxu(x: torch.Tensor, anchor: torch.Tensor, nwa: int,
                 kernels: bool):
    """Correctly rounded exact sum of the elements covered at ``anchor``:
    (bits 0-dim int64, bad 0-dim bool), both on the device; the caller
    discards the bits when ``bad`` is set.  One launch of B11, which
    rounds in its last block, or the plain B11 and B3."""
    if kernels:
        ws = _sum_flat_ws(x, anchor, nwa)
        return ws[nwa + 2], ws_flag(ws, nwa + 1)
    rel, bad = sum_flat_torch(x, anchor, nwa)
    return round_scaled_terms_torch(rel, frame_positions(nwa), anchor,
                                    1 - 32 * nwa), bad


def sum_acc_limbs_mxu(x: torch.Tensor, anchor: torch.Tensor, nwa: int,
                      kernels: bool):
    """The exact sum as absolute SUM_FORMAT limbs: (limbs int64 (L_SUM,),
    bad).  Every covered element is a multiple of 2^-1074 (absolute bit
    0), so the shift is exact."""
    rel, bad = (sum_flat_cuda if kernels else sum_flat_torch)(x, anchor, nwa)
    pos = frame_positions(nwa)
    limbs = terms_to_limbs(rel, pos, term_limbs_count(pos))
    p0 = torch.as_tensor(anchor, device=rel.device).to(torch.int64).reshape(
        ()) + (1 - 32 * nwa + SUM_FORMAT.offset_bits)
    return rel_limbs_to_abs_limbs(limbs, p0, SUM_FORMAT), bad
