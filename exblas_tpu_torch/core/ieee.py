"""IEEE-754 binary64 bit codec (PyTorch).

Counterpart of ``exblas_tpu/core/ieee.py``.  The TPU could not hold float64
on the device, so the JAX package carried doubles as (hi, lo) uint32 pairs.
PyTorch and the GPU hold float64 natively: a float64 tensor is decoded by
viewing it as int64, and every bit operation here is int64 arithmetic with
masks (PyTorch's unsigned 64-bit tensors lack shifts on the CPU).
"""

from __future__ import annotations

import torch

from .types import F64_EXP_SPECIAL, F64_MANT_BITS

__all__ = ["f64_bits", "decode_fields"]

FRAC_MASK = (1 << F64_MANT_BITS) - 1
HIDDEN_BIT = 1 << F64_MANT_BITS


def f64_bits(x: torch.Tensor) -> torch.Tensor:
    """Raw binary64 bit patterns of a float64 tensor, as int64 (a view)."""
    if x.dtype != torch.float64:
        raise TypeError(f"f64_bits: expected float64, got {x.dtype}")
    return x.contiguous().view(torch.int64)


def decode_fields(bits: torch.Tensor):
    """Decode int64 bit patterns -> (sign, expfield, mant53), all int64.

    sign     : 0 or 1
    expfield : in [0, 2047]
    mant53   : the 53-bit significand, implicit bit included for normals
               (subnormals, zeros and specials have bit 52 clear)

    The represented value is ``(-1)^sign * mant53 * 2^E`` with
    ``E = max(expfield, 1) - 1075``.
    """
    sign = (bits >> 63) & 1
    expfield = (bits >> F64_MANT_BITS) & F64_EXP_SPECIAL
    frac = bits & FRAC_MASK
    is_normal = (expfield != 0) & (expfield != F64_EXP_SPECIAL)
    mant53 = torch.where(is_normal, frac | HIDDEN_BIT, frac)
    return sign, expfield, mant53
