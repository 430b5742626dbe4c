"""Correctly rounded binary64 multiply and divide on int64 bit patterns
(PyTorch).

Counterpart of ``exblas_tpu/core/f64ops.py`` (``f64_mul``, ``f64_div``,
``f64_div_pair``).  The TPU has no float64 unit, so the JAX package
rebuilds both operations from uint32 integer steps.  The CPU and the GPU
have native IEEE-754 float64 multiply and divide, correctly rounded to
nearest even with subnormals, so the port views the bits as float64 and
lets the hardware round.  Only NaNs need care: a native NaN keeps a
payload and a sign, and the JAX package returns the canonical
``0x7FF8000000000000`` for every NaN result.
"""

from __future__ import annotations

import torch

from .rounding import QNAN_BITS

__all__ = ["f64_mul", "f64_div", "f64_div_pair"]


def _as_f64(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int64).contiguous().view(torch.float64)


def _binary(op, a_bits, b_bits) -> torch.Tensor:
    """``op`` on the float64 views, every NaN result made canonical."""
    r = op(_as_f64(a_bits), _as_f64(b_bits))
    return torch.where(r.isnan(), QNAN_BITS, r.view(torch.int64))


def f64_mul(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """Correctly rounded a*b on int64 binary64 patterns -> int64 bits."""
    return _binary(torch.mul, a_bits, b_bits)


def f64_div(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """Correctly rounded a/b on int64 binary64 patterns -> int64 bits."""
    return _binary(torch.div, a_bits, b_bits)


def f64_div_pair(a_bits: torch.Tensor, b_bits: torch.Tensor):
    """:func:`f64_div` as (hi32, lo32) words, int64 tensors in
    [0, 2^32) -- the word pair the JAX package's ``f64_div_pair`` gives."""
    bits = f64_div(a_bits, b_bits)
    return (bits >> 32) & 0xFFFFFFFF, bits & 0xFFFFFFFF
