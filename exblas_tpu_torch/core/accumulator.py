"""Superaccumulator arithmetic: plain deposits, carry passes and exact
merging (PyTorch).

Counterpart of ``exblas_tpu/core/accumulator.py``.  ``accumulate_sum_terms``
and ``accumulate_dot_terms`` are the plain versions of the ExSUM and ExDOT
deposit kernels: every piece is added with ``index_add_`` into int64 limbs.
Integer addition is associative, so the result is exact and independent of
the order in which the pieces land.
"""

from __future__ import annotations

import torch

from . import deposit as _dep
from .ieee import f64_bits
from .types import AccFormat, LIMB_BITS, Superacc

__all__ = ["renorm_pass", "to_int32_limbs", "merge",
           "accumulate_sum_terms", "accumulate_dot_terms",
           "MAX_TERMS", "MAX_DOT_TERMS"]

# Largest element count the int64 limbs take without a carry pass.  In the
# plain sum a limb receives at most one piece below 2^20 per element, so
# the limbs stay below 2^63 while n < 2^43.  The CUDA kernels (sum and dot:
# the 106-bit product is split into exact 20-bit digits) add at most one
# more piece per thread and register bin, so they share the bound
# n <= 2^42.
MAX_TERMS = 1 << 42
# The plain dot deposits 7 shift classes 14 bits apart, 3 pieces below 2^20
# each, so up to 5 pieces land on one limb per element: n <= 2^40.
MAX_DOT_TERMS = 1 << 40


def renorm_pass(limbs):
    """One vectorized carry pass along the last axis (exact).

    Carries move up one limb; the TOP limb is kept whole.  A negative
    value is represented as digits in [0, 2^20) plus a borrowed -1 carry
    that climbs one limb per pass: stripping it at the top would corrupt
    the value by 2^(20*L).
    """
    c = limbs >> LIMB_BITS  # arithmetic shift: floor division by 2^20
    low = limbs - (c << LIMB_BITS)
    low[..., -1] = limbs[..., -1]
    c_up = torch.zeros_like(c)
    c_up[..., 1:] = c[..., :-1]
    return low + c_up


def to_int32_limbs(limbs, passes: int = 2):
    """Renormalize wide (int64) limbs into the int32 range."""
    x = limbs.to(torch.int64)
    for _ in range(passes):
        x = renorm_pass(x)
    return x.to(torch.int32)


def merge(accs: Superacc, dim: int = 0) -> Superacc:
    """Exact merge (sum) of a batch of superaccumulators along ``dim``."""
    limbs = accs.limbs.to(torch.int64).sum(dim=dim)
    special = accs.special.to(torch.int64).sum(dim=dim)
    return Superacc(limbs=to_int32_limbs(limbs),
                    special=special.to(torch.int32), fmt=accs.fmt)


def _specials(t):
    return torch.stack([t["nan"].sum(), t["pinf"].sum(), t["ninf"].sum()])


def check_n_terms(n: int, limit: int = MAX_TERMS):
    if n > limit:
        raise ValueError(f"{n} terms exceed the int64 deposit bound {limit}")


def accumulate_sum_terms(x: torch.Tensor, fmt: AccFormat) -> Superacc:
    """Exact sum of a float64 tensor into one Superacc (plain version)."""
    bits = f64_bits(x).reshape(-1)
    check_n_terms(bits.numel())
    t = _dep.sum_terms(bits, fmt.offset_bits)
    limbs = torch.zeros(fmt.n_limbs, dtype=torch.int64, device=x.device)
    for off, piece in enumerate(t["pieces"]):
        limbs.index_add_(0, t["q"] + off, piece)
    return Superacc(limbs=to_int32_limbs(limbs),
                    special=_specials(t).to(torch.int32), fmt=fmt)


def accumulate_dot_terms(a: torch.Tensor, b: torch.Tensor,
                         fmt: AccFormat) -> Superacc:
    """Exact dot product of two float64 tensors into one Superacc (plain
    version)."""
    bits_a = f64_bits(a).reshape(-1)
    bits_b = f64_bits(b).reshape(-1)
    check_n_terms(bits_a.numel(), MAX_DOT_TERMS)
    t = _dep.product_terms(bits_a, bits_b, fmt.offset_bits)
    q, r, s = t["q"], t["r"], t["s"]
    limbs = torch.zeros(fmt.n_limbs, dtype=torch.int64, device=a.device)
    for k, cls in enumerate(t["classes"]):
        # class k sits at bit offset 14k above the product LSB
        pbit = r + 14 * k
        dq = torch.div(pbit, LIMB_BITS, rounding_mode="floor")
        pieces = _dep.split_value30(cls, pbit - dq * LIMB_BITS)
        for off, piece in enumerate(pieces):
            limbs.index_add_(0, q + dq + off, piece * s)
    return Superacc(limbs=to_int32_limbs(limbs),
                    special=_specials(t).to(torch.int32), fmt=fmt)
