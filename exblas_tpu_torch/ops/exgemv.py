"""Row helpers shared by the matrix routines (PyTorch).

Counterpart of the helpers of ``exblas_tpu/ops/exgemv.py`` that ExGEMM
uses: scalar bits, one exact double deposited per accumulator row, the
batched correctly rounded conversion of DOT_FORMAT rows, and the BLAS
leading-dimension view of a flat column-major buffer.  ExGEMV itself is
still to be ported; it will live here beside them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import deposit as dep
from ..core.rounding import (apply_specials, canonicalize_digits,
                             round_digits_to_f64_bits)
from ..core.types import DOT_FORMAT

__all__ = ["deposit_terms_rows", "round_rows"]


def _scalar_bits(v: float) -> int:
    """The binary64 bit pattern of ``v`` as a signed 64-bit Python int."""
    return int(np.float64(v).view(np.int64))


def deposit_terms_rows(limbs, special, bits):
    """Exactly deposit one double per row into (m, L) int64 limb rows and
    add its special counts to ``special`` (m, 3).  In place; returns both."""
    m, L = limbs.shape
    t = dep.sum_terms(bits.reshape(-1), DOT_FORMAT.offset_bits)
    base = torch.arange(m, device=limbs.device) * L + t["q"]
    flat = limbs.view(-1)
    for off, piece in enumerate(t["pieces"]):
        flat.index_add_(0, base + off, piece)
    special += torch.stack([t["nan"], t["pinf"], t["ninf"]], dim=-1)
    return limbs, special


def round_rows(limbs, special):
    """Batched correctly rounded conversion of DOT_FORMAT rows (..., L)
    with their special counts (..., 3) -> int64 bits (...,)."""
    digits, negative = canonicalize_digits(limbs)
    bits = round_digits_to_f64_bits(digits, negative, DOT_FORMAT)
    return apply_specials(bits, special)


def _apply_ld(a, m: int, n: int, lda: int):
    """Reinterpret a flat column-major buffer with leading dimension lda as
    the logical (m, n) matrix -- the BLAS convention of the reference
    signatures (include/blas2.hpp:57,95, blas3.hpp:56).  Takes a tensor
    (returns a view) or anything numpy reads."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a, np.float64)
    buf = a.reshape(-1)
    if lda < m or buf.shape[0] < lda * n:
        raise ValueError(f"lda={lda} too small for {m}x{n}")
    return buf[: lda * n].reshape(n, lda)[:, :m].T
