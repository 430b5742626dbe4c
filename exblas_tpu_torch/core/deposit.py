"""Decomposition of doubles (and exact double products) into base-2^20
limb deposits (PyTorch, int64).

Counterpart of ``exblas_tpu/core/deposit.py``, with the same deposits:

* a double contributes ``mant53 << r`` at limb index ``q`` where the bit
  position of its significand LSB is ``p = E + offset_bits``,
  ``q = p // 20``, ``r = p % 20`` -- four 20-bit pieces;
* an exact 106-bit product ``mant_a * mant_b`` is formed from 14-bit
  mantissa pieces as 7 "shift classes" of < 2^30 each, exactly like a
  schoolbook multiply, and deposited class by class.

Native int64 replaces the JAX package's uint32 word pairs.
"""

from __future__ import annotations

import torch

from .ieee import FRAC_MASK, decode_fields
from .types import F64_EXP_SPECIAL, LIMB_BITS, LIMB_MASK

__all__ = ["split_value30", "classify", "sum_terms", "mant_pieces14",
           "product_terms", "segment_deposit_products"]


def split_value30(c, r):
    """Split ``c * 2^r`` (0 <= c < 2^30, 0 <= r < 20) into three pieces,
    each < 2^20, at limb offsets 0, 1, 2."""
    v = c << r  # < 2^50: no int64 overflow
    return v & LIMB_MASK, (v >> LIMB_BITS) & LIMB_MASK, v >> (2 * LIMB_BITS)


def classify(expfield, mant53):
    """(is_zero, is_inf, is_nan) for decoded fields."""
    frac_nonzero = (mant53 & FRAC_MASK) != 0
    is_special = expfield == F64_EXP_SPECIAL
    is_nan = is_special & frac_nonzero
    is_inf = is_special & ~frac_nonzero
    is_zero = (expfield == 0) & (mant53 == 0)
    return is_zero, is_inf, is_nan


def _limb_pos(p):
    """(q, r) = divmod(p, 20) for non-negative int64 p."""
    q = torch.div(p, LIMB_BITS, rounding_mode="floor")
    return q, p - q * LIMB_BITS


def sum_terms(bits, offset_bits: int):
    """Decompose doubles (int64 bit patterns) into sum-accumulator deposits.

    Returns a dict with (all shaped like ``bits``, int64):
      q       -- base limb index (0 for invalid terms)
      pieces  -- tuple of 4 signed 20-bit deposits for limbs q..q+3
      valid   -- bool, finite nonzero
      nan/pinf/ninf -- 0/1 special counters
    """
    sign, expfield, mant = decode_fields(bits)
    is_zero, is_inf, is_nan = classify(expfield, mant)
    valid = ~((expfield == F64_EXP_SPECIAL) | is_zero)

    # Significand LSB exponent E = max(expfield,1) - 1075; its bit position
    # p = E + offset_bits is >= 0 for every finite double in SUM_FORMAT.
    p = torch.clamp(expfield, min=1) - 1075 + offset_bits
    valid = valid & (p >= 0)
    p = torch.where(valid, p, torch.zeros_like(p))
    q, r = _limb_pos(p)

    s = torch.where(sign == 1, -1, 1)
    s = torch.where(valid, s, torch.zeros_like(s))
    # Piece k is bits [20k, 20k+20) of mant53 << r (up to 73 bits): piece 0
    # shifts the low 20 bits up; pieces 1..3 shift the significand down by
    # 20k - r > 0, so nothing overflows int64.
    p0 = ((mant & LIMB_MASK) << r) & LIMB_MASK
    pieces = (p0,) + tuple(
        (mant >> (LIMB_BITS * k - r)) & LIMB_MASK for k in (1, 2, 3))
    pieces = tuple(x * s for x in pieces)
    q = torch.where(valid, q, torch.zeros_like(q))

    nan = is_nan.to(torch.int64)
    pinf = (is_inf & (sign == 0)).to(torch.int64)
    ninf = (is_inf & (sign == 1)).to(torch.int64)
    return dict(q=q, pieces=pieces, valid=valid, nan=nan, pinf=pinf,
                ninf=ninf)


def mant_pieces14(mant53):
    """Split a 53-bit significand into four 14-bit pieces (LSB first)."""
    return tuple((mant53 >> (14 * i)) & 0x3FFF for i in range(4))


def product_terms(bits_a, bits_b, offset_bits: int):
    """Decompose exact products a[i]*b[i] into limb deposits.

    The 106-bit product mant_a*mant_b is 7 shift classes
    ``S_k = sum_{i+j=k} A_i*B_j < 2^30`` at bit offsets 14k.

    Returns a dict with (int64):
      q, r     -- base limb index and bit offset of the product LSB
      classes  -- tuple of 7 unsigned magnitudes < 2^30
      s        -- overall sign (+1/-1, 0 if invalid)
      nan/pinf/ninf -- 0*Inf -> NaN, Inf*finite nonzero -> Inf, NaN -> NaN
    """
    sign_a, exp_a, mant_a = decode_fields(bits_a)
    sign_b, exp_b, mant_b = decode_fields(bits_b)
    zero_a, inf_a, nan_a = classify(exp_a, mant_a)
    zero_b, inf_b, nan_b = classify(exp_b, mant_b)

    sign = sign_a ^ sign_b
    inf_times_zero = (inf_a & zero_b) | (inf_b & zero_a)
    is_nan = nan_a | nan_b | inf_times_zero
    is_inf = (inf_a | inf_b) & ~is_nan
    special = (exp_a == F64_EXP_SPECIAL) | (exp_b == F64_EXP_SPECIAL)
    valid = ~(special | zero_a | zero_b)

    p = (torch.clamp(exp_a, min=1) + torch.clamp(exp_b, min=1)
         - 2 * 1075 + offset_bits)
    valid = valid & (p >= 0)
    p = torch.where(valid, p, torch.zeros_like(p))
    q, r = _limb_pos(p)

    # class k = sum of a_i * b_j over i + j = k, from one outer product
    a = torch.stack(mant_pieces14(mant_a))
    b = torch.stack(mant_pieces14(mant_b))
    a, b = torch.broadcast_tensors(a, b)
    prods = (a[:, None] * b[None, :]).reshape((16,) + a.shape[1:])
    pieces = torch.arange(4, device=prods.device)
    class_of_pair = (pieces[:, None] + pieces[None, :]).reshape(-1)
    classes = torch.zeros((7,) + a.shape[1:], dtype=prods.dtype,
                          device=prods.device).index_add_(
        0, class_of_pair, prods).unbind(0)

    s = torch.where(sign == 1, -1, 1)
    s = torch.where(valid, s, torch.zeros_like(s))
    zero = torch.zeros_like(q)
    q = torch.where(valid, q, zero)
    r = torch.where(valid, r, zero)

    nan = is_nan.to(torch.int64)
    pinf = (is_inf & (sign == 0)).to(torch.int64)
    ninf = (is_inf & (sign == 1)).to(torch.int64)
    return dict(q=q, r=r, classes=classes, s=s, valid=valid,
                nan=nan, pinf=pinf, ninf=ninf)


def segment_deposit_products(limbs_flat, t, seg_base):
    """Exact deposit of ``product_terms`` ``t`` into flattened per-row limb
    accumulators, in place: the pieces of term ``i`` are ``index_add_``-ed
    at ``seg_base[i] + q[i] + ...`` of ``limbs_flat`` (int64 (R * L,)).
    ``seg_base`` (row id * L) broadcasts against t's arrays.  Returns
    ``limbs_flat``.  Up to 5 pieces below 2^20 land on one limb per term,
    so a row takes at most 2^40 terms."""
    q, r, s = t["q"], t["r"], t["s"]
    cls = torch.stack(t["classes"])  # (7, ...)
    # class k sits at bit offset 14k above the product LSB
    k14 = (14 * torch.arange(7, device=cls.device)).reshape(
        (7,) + (1,) * (cls.dim() - 1))
    pbit = r + k14
    dq = torch.div(pbit, LIMB_BITS, rounding_mode="floor")
    pieces = torch.stack(split_value30(cls, pbit - dq * LIMB_BITS)) * s
    base = seg_base + q + dq
    offs = torch.arange(3, device=cls.device).reshape(
        (3,) + (1,) * base.dim())
    idx, val = torch.broadcast_tensors(base + offs, pieces)
    return limbs_flat.index_add_(0, idx.reshape(-1), val.reshape(-1))
