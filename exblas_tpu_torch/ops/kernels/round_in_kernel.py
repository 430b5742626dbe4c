"""Kernel B3: one correct rounding of a sum of int64 terms at fixed bit
positions (CUDA, ``csrc/round_terms.cu``), and its plain version.

Counterpart of ``exblas_tpu/ops/kernels/round_in_kernel.py``
(``round_scaled_terms``): the exact value

    V = sum_t vals[t] * 2^(bits_pos[t] + e_adjust)

rounded once to binary64 (nearest even, subnormals, overflow to +-Inf, +0
for an exact zero).  The TPU kernel spread the terms over 128 lanes and
folded them through a float32 matmul because its vector unit has no cheap
cross-lane integer sum; on Hopper one thread adds each term's two 32-bit
halves into int64 limbs (``round.cuh`` ``add_scaled``, shared with B6's
and B9's rounding kernels) and rounds them (``round_limbs``).  The
anchored sum and dot paths end in this rounding, but on the card it runs
inside the last blocks of their window kernels B11 and B12 (``round.cuh``
``finish_frame``), so :func:`round_scaled_terms_cuda` is off their main
path: it is the counterpart of the TPU kernel and the test bed of that
device code.  The plain paths end in :func:`round_scaled_terms_torch`.

``bits_pos`` is static (a tuple of ints) and passed by value; ``e_adjust``
is a 0-dim int32 tensor on the device, since the anchored paths compute
their frame's exponent from the data, and reading it on the host would
cost a synchronization.  The JAX kernel needs |vals| < 2^52; both versions
here take any int64 (each term is split into two 32-bit halves).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core.rounding import canonicalize_digits, round_digits_to_f64_bits
from ...core.types import LIMB_BITS, LIMB_MASK, SUM_FORMAT
from ...utils import profiling
from . import _build
from ._build import ptr, stream_of

__all__ = ["round_scaled_terms_cuda", "round_scaled_terms_torch",
           "terms_to_limbs", "term_limbs_count", "MAX_TERMS"]

MAX_TERMS = 128
MAX_TERM_LIMBS = 64   # kMaxTermLimbs in csrc/round_terms.cu
_M32 = (1 << 32) - 1


def term_limbs_count(bits_pos) -> int:
    """Limbs that hold sum_t v_t 2^(p_t) for any int64 v_t (at most 128
    terms, below 2^(max p + 71)) with its sign: the high half of the top
    term reaches limb (max p + 32) // 20 + 2."""
    return (max(bits_pos) + 72) // LIMB_BITS + 2


def _check_terms(vals: torch.Tensor, bits_pos, name: str) -> int:
    t = len(bits_pos)
    if tuple(vals.shape) != (t,) or vals.dtype != torch.int64:
        raise ValueError(f"{name}: vals must be int64 of shape ({t},), got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    if not 1 <= t <= MAX_TERMS or min(bits_pos) < 0:
        raise ValueError(f"{name}: 1 to {MAX_TERMS} terms at non-negative "
                         f"positions, got {t} terms")
    return t


def terms_to_limbs(vals: torch.Tensor, bits_pos, n_limbs: int):
    """sum_t vals[t] * 2^(bits_pos[t]) as int64 limbs (n_limbs,): each
    term's low and high 32-bit halves go to three limbs each (pieces below
    2^20, the top one signed), as ``round.cuh`` ``add_scaled`` does."""
    halves = torch.stack([vals & _M32, vals >> 32], 1).reshape(-1)
    pos = [p + 32 * h for p in bits_pos for h in (0, 1)]
    q = [p // LIMB_BITS for p in pos]
    shift = torch.tensor([p - LIMB_BITS * qq for p, qq in zip(pos, q)],
                         dtype=torch.int64, device=vals.device)
    w = halves << shift                                 # |w| < 2^52
    pieces = torch.stack([w & LIMB_MASK, (w >> LIMB_BITS) & LIMB_MASK,
                          w >> (2 * LIMB_BITS)], 1).reshape(-1)
    idx = torch.tensor([qq + k for qq in q for k in range(3)],
                       dtype=torch.int64, device=vals.device)
    limbs = torch.zeros(n_limbs, dtype=torch.int64, device=vals.device)
    return limbs.index_add_(0, idx, pieces)


@functools.lru_cache(maxsize=256)
def _c_positions(bits_pos: tuple):
    """The positions as the C entry's int array, built once a tuple."""
    return (ctypes.c_int * len(bits_pos))(*bits_pos)


def round_scaled_terms_torch(vals: torch.Tensor, bits_pos, e_adjust,
                             e_offset: int = 0) -> torch.Tensor:
    """Plain version of :func:`round_scaled_terms_cuda` on any device;
    ``e_adjust`` may also be an int."""
    bits_pos = tuple(int(p) for p in bits_pos)
    _check_terms(vals, bits_pos, "round_scaled_terms_torch")
    limbs = terms_to_limbs(vals, bits_pos, term_limbs_count(bits_pos))
    digits, negative = canonicalize_digits(limbs)
    e = torch.as_tensor(e_adjust, device=vals.device).to(torch.int64)
    e = e.reshape(()) + int(e_offset)
    return round_digits_to_f64_bits(digits, negative, SUM_FORMAT,
                                    offset_bits=-e)


@profiling.spanned("exblas.launch.round_terms_cuda")
def round_scaled_terms_cuda(vals: torch.Tensor, bits_pos, e_adjust,
                            e_offset: int = 0) -> torch.Tensor:
    """Kernel B3: the correctly rounded binary64 bits of sum_t vals[t] *
    2^(bits_pos[t] + e_adjust + e_offset) as a 0-dim int64 tensor on the
    device.  vals: contiguous CUDA int64 (T,), T <= 128; bits_pos: T
    non-negative ints; e_adjust: a 0-dim int32 tensor on the same device;
    e_offset: an int added to it in the kernel."""
    bits_pos = tuple(int(p) for p in bits_pos)
    t = _check_terms(vals, bits_pos, "round_scaled_terms_cuda")
    if vals.device.type != "cuda" or not vals.is_contiguous():
        raise ValueError("round_scaled_terms_cuda: expected a contiguous "
                         f"CUDA tensor, got {vals.device}")
    if (not isinstance(e_adjust, torch.Tensor) or e_adjust.numel() != 1
            or e_adjust.dtype != torch.int32
            or e_adjust.device != vals.device):
        raise ValueError("round_scaled_terms_cuda: e_adjust must be a "
                         "one-element int32 tensor on the device of vals")
    n_limbs = term_limbs_count(bits_pos)
    if n_limbs > MAX_TERM_LIMBS:
        raise ValueError(f"round_scaled_terms_cuda: positions up to "
                         f"{max(bits_pos)} need {n_limbs} limbs, more than "
                         f"{MAX_TERM_LIMBS}")
    pos = _c_positions(bits_pos)
    bits = torch.empty((), dtype=torch.int64, device=vals.device)
    with torch.cuda.device(vals.device):
        err = _build.library().round_terms_cuda(
            ptr(vals), pos, t, n_limbs, ptr(e_adjust), int(e_offset),
            ptr(bits), stream_of(vals.device))
    _build.check(err, "round_terms_cuda")
    round_scaled_terms_cuda.launches += 1
    return bits


round_scaled_terms_cuda.launches = 0
