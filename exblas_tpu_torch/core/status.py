"""Accumulator status, derived from the exact state (PyTorch).

Counterpart of ``exblas_tpu/core/status.py``:

* NAN / POS_INF / NEG_INF from the special counters;
* OVERFLOW when all inputs were finite but the value rounds to an infinity;
* EXACT when the rounded double equals the accumulated value exactly,
  INEXACT otherwise.
"""

from __future__ import annotations

import enum

import torch

from . import deposit as _dep
from .rounding import canonicalize_digits, round_superacc_to_f64_bits
from .types import Superacc


class Status(enum.IntEnum):
    EXACT = 0
    INEXACT = 1
    OVERFLOW = 2
    POS_INF = 3
    NEG_INF = 4
    NAN = 5


def status_of(acc: Superacc) -> torch.Tensor:
    """Status codes (int32, batch-shaped) for a Superacc."""
    nan_c = acc.special[..., 0]
    pos_c = acc.special[..., 1]
    neg_c = acc.special[..., 2]

    bits = round_superacc_to_f64_bits(acc)
    expf = (bits >> 52) & 0x7FF
    finite_inputs = (nan_c == 0) & (pos_c == 0) & (neg_c == 0)
    overflowed = finite_inputs & (expf == 0x7FF)

    # Exactness: re-deposit the rounded double and compare canonical digits.
    t = _dep.sum_terms(bits, acc.fmt.offset_bits)
    redep = torch.zeros(bits.shape + (acc.fmt.n_limbs,), dtype=torch.int64,
                        device=bits.device)
    for off, piece in enumerate(t["pieces"]):
        redep.scatter_add_(-1, (t["q"] + off)[..., None], piece[..., None])
    d1, n1 = canonicalize_digits(acc.limbs)
    d2, n2 = canonicalize_digits(redep)
    exact = (d1 == d2).all(dim=-1) & (n1 == n2)

    status = torch.where(exact, int(Status.EXACT), int(Status.INEXACT))
    status = torch.where(overflowed, int(Status.OVERFLOW), status)
    status = torch.where(pos_c > 0, int(Status.POS_INF), status)
    status = torch.where(neg_c > 0, int(Status.NEG_INF), status)
    is_nan = (nan_c > 0) | ((pos_c > 0) & (neg_c > 0))
    status = torch.where(is_nan, int(Status.NAN), status)
    return status.to(torch.int32)
