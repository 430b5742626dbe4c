"""Correctly rounded conversion: superaccumulator limbs -> binary64 bits
(PyTorch, int64).

Counterpart of ``exblas_tpu/core/rounding.py``.  The accumulator value is
an exact integer, so it is rounded directly to nearest-even and the double
is assembled bitwise.  The JAX package did this in uint32 word pairs
because the TPU emulates int64; here every step is native int64.

Bit patterns are returned as int64 tensors (the float64 bits viewed as
int64): ``bits.view(torch.float64)`` gives the double.
"""

from __future__ import annotations

import torch

from .types import (
    AccFormat,
    LIMB_BITS,
    LIMB_MASK,
    SPECIAL_NAN,
    SPECIAL_NEG_INF,
    SPECIAL_POS_INF,
    Superacc,
)

__all__ = [
    "QNAN_BITS", "PINF_BITS", "NINF_BITS", "SIGN_BIT",
    "canonicalize_digits", "negate_digits", "ieee_encode_round",
    "round_digits_to_f64_bits", "round_superacc_to_f64_bits",
    "apply_specials", "bits_to_float", "rel_limbs_to_abs_limbs",
]

# Canonical special results, as int64 views of the binary64 patterns.
QNAN_BITS = 0x7FF8000000000000
PINF_BITS = 0x7FF0000000000000
NINF_BITS = 0xFFF0000000000000 - (1 << 64)
SIGN_BIT = -(1 << 63)  # the binary64 sign bit, as an int64


def canonicalize_digits(limbs):
    """Propagate carries: signed limbs (..., L) -> (digits, negative).

    digits: int32 (..., L), each in [0, 2^20) -- the base-2^20 digits of
    |V| if V >= 0, or of 2^(20L) - |V| if V < 0 (two's complement).
    negative: bool (...,) -- sign of the exact value.

    Value-exact for every representation with |V| < 2^(20L), "parked"
    negative carries in the top limb included.
    """
    x = limbs.to(torch.int64)
    carry = torch.zeros_like(x[..., 0])
    digits = []
    for limb in x.unbind(-1):
        d = limb + carry
        digits.append(d & LIMB_MASK)
        carry = d >> LIMB_BITS  # arithmetic shift: floor division
    return torch.stack(digits, -1).to(torch.int32), carry < 0


def negate_digits(digits):
    """Two's complement negation in base 2^20: 2^(20L) - D."""
    x = digits.to(torch.int64)
    borrow = torch.ones_like(x[..., 0])
    out = []
    for digit in x.unbind(-1):
        t = (digit ^ LIMB_MASK) + borrow
        out.append(t & LIMB_MASK)
        borrow = t >> LIMB_BITS
    return torch.stack(out, -1).to(digits.dtype)


def rel_limbs_to_abs_limbs(rel, p0, fmt: AccFormat):
    """Shift RELATIVE int64 limbs into an ABSOLUTE accumulator frame.

    rel: (..., Lr) redundant limbs, one exact value per leading index; rel
    bit 0 lands at absolute bit ``p0`` (an int or an int tensor of shape
    (...), ``fmt.offset_bits`` included).  Returns (..., fmt.n_limbs)
    int64 absolute limbs, the frame of the exact accumulators.  Port of
    ``exblas_tpu/core/rounding.py:95-125``: canonicalize, take sign and
    magnitude, and shift each digit to its absolute limb.

    Precondition (the callers' windows guarantee it): every value is an
    integer multiple of absolute bit 0, so canonical digits wholly below
    bit 0 are zero and at most one digit straddles it, which folds into
    limb 0 by an exact right shift.
    """
    digits, negative = canonicalize_digits(rel)
    mag = torch.where(negative[..., None], negate_digits(digits),
                      digits).to(torch.int64)
    sgn = torch.where(negative, -1, 1)
    p0 = torch.as_tensor(p0, dtype=torch.int64, device=rel.device)
    q0 = torch.div(p0, LIMB_BITS, rounding_mode="floor")
    rb = p0 - q0 * LIMB_BITS
    n_limbs = fmt.n_limbs
    out = torch.zeros(rel.shape[:-1] + (n_limbs,), dtype=torch.int64,
                      device=rel.device)
    for j in range(mag.shape[-1]):
        q = (q0 + j).expand(rel.shape[:-1])
        vj = (mag[..., j] << rb) * sgn                  # |vj| < 2^40
        sh = (-q).clamp(min=0) * LIMB_BITS
        vj = torch.where(sh > LIMB_BITS, 0, vj >> sh.clamp(max=LIMB_BITS))
        vj = torch.where(q < n_limbs, vj, 0)
        out.scatter_add_(-1, q.clamp(0, n_limbs - 1)[..., None],
                         vj[..., None])
    return out


def ieee_encode_round(sign, e_msb, m55, sticky_below):
    """Round a positive value ``m55 * 2^(e_msb - 54)`` (+ a sticky tail
    strictly below) to binary64 bits, round to nearest even.

    sign: 0/1.  e_msb: unbiased exponent of the leading bit (bit 54 of
    m55 is set).  sticky_below: bool.  All int64 tensors of one shape.
    Handles overflow to Inf and subnormals.  Returns int64 bit patterns.
    """
    e = e_msb.to(torch.int64)
    subn = e < -1022
    # Shift distance: 2 for normals; 2 + (-1022 - e) for subnormals.
    d = torch.where(subn, -1022 - e, torch.zeros_like(e))
    c = torch.clamp(d + 2, 2, 63)

    m53 = m55 >> c
    guard = (m55 >> (c - 1)) & 1
    sticky = sticky_below | ((m55 & ((1 << (c - 1)) - 1)) != 0)
    # Deep underflow: everything dropped.
    deep = d >= 60
    m53 = torch.where(deep, torch.zeros_like(m53), m53)
    guard = torch.where(deep, torch.zeros_like(guard), guard)
    sticky = sticky | deep

    round_up = (guard != 0) & (sticky | ((m53 & 1) != 0))
    m = m53 + round_up.to(torch.int64)
    # Mantissa overflow on round-up (normal path): 2^53 -> 2^52, e += 1.
    overflowed = ~subn & (m == (1 << 53))
    m = torch.where(overflowed, torch.full_like(m, 1 << 52), m)
    e = e + overflowed.to(torch.int64)

    # A subnormal that rounded up to 2^52 becomes the smallest normal.
    expf = torch.where(subn, (m >> 52) & 1, e + 1023)
    bits = (expf << 52) | (m & ((1 << 52) - 1))
    over = ~subn & (expf >= 2047)
    bits = torch.where(over, torch.full_like(bits, PINF_BITS), bits)
    return torch.where(sign != 0, bits | SIGN_BIT, bits)


def round_digits_to_f64_bits(digits, negative, fmt: AccFormat,
                             offset_bits=None):
    """Round canonical base-2^20 digits (..., L) to binary64 bits (int64).

    Bit p of the accumulator has exponent ``p - offset_bits``, where
    ``offset_bits`` defaults to ``fmt.offset_bits`` and may be an int64
    tensor of shape (...,) for accumulators anchored per element.
    """
    if offset_bits is None:
        offset_bits = fmt.offset_bits
    n_limbs = digits.shape[-1]
    mag = torch.where(negative[..., None], negate_digits(digits),
                      digits).to(torch.int64)
    nonzero = mag != 0
    any_nonzero = nonzero.any(dim=-1)
    # Highest nonzero digit index.
    rev = torch.argmax(nonzero.flip(-1).to(torch.int32), dim=-1)
    jstar = torch.where(any_nonzero, n_limbs - 1 - rev,
                        torch.zeros_like(rev))
    top = torch.gather(mag, -1, jstar[..., None])[..., 0].clamp(min=1)
    msb = torch.frexp(top.to(torch.float64))[1].to(torch.int64) - 1
    p_msb = jstar * LIMB_BITS + msb  # bit position of the leading bit

    # The 55-bit window [p_msb - 54, p_msb]: digits j0..j0+3, zero-padded
    # below bit 0 of the accumulator (j0 may be negative).
    pos_low = p_msb - 54
    j0 = torch.div(pos_low, LIMB_BITS, rounding_mode="floor")
    shift = pos_low - j0 * LIMB_BITS  # in [0, 20)

    def digit_at(t):
        idx = j0 + t
        safe = idx.clamp(0, n_limbs - 1)
        v = torch.gather(mag, -1, safe[..., None])[..., 0]
        return torch.where((idx >= 0) & (idx < n_limbs), v,
                           torch.zeros_like(v))

    d0 = digit_at(0)
    m55 = d0 >> shift
    for t in (1, 2, 3):
        m55 = m55 | (digit_at(t) << (LIMB_BITS * t - shift))
    m55 = m55 & ((1 << 55) - 1)

    # Sticky: any bit strictly below pos_low.
    idxs = torch.arange(n_limbs, device=digits.device)
    sticky = ((idxs < j0[..., None]) & nonzero).any(dim=-1)
    sticky = sticky | ((d0 & ((1 << shift) - 1)) != 0)

    bits = ieee_encode_round(negative.to(torch.int64), p_msb - offset_bits,
                             m55, sticky)
    return torch.where(any_nonzero, bits, torch.zeros_like(bits))


def apply_specials(bits, special):
    """Override rounded bits with the special results, in the reference's
    order: any NaN, or both +Inf and -Inf -> canonical qNaN; else any
    +/-Inf -> that infinity."""
    nan_c = special[..., SPECIAL_NAN]
    pos_c = special[..., SPECIAL_POS_INF]
    neg_c = special[..., SPECIAL_NEG_INF]
    is_nan = (nan_c > 0) | ((pos_c > 0) & (neg_c > 0))
    bits = torch.where(neg_c > 0, torch.full_like(bits, NINF_BITS), bits)
    bits = torch.where(pos_c > 0, torch.full_like(bits, PINF_BITS), bits)
    return torch.where(is_nan, torch.full_like(bits, QNAN_BITS), bits)


def round_superacc_to_f64_bits(acc: Superacc):
    """Full epilogue: Superacc -> binary64 bits (int64), honoring specials."""
    digits, negative = canonicalize_digits(acc.limbs)
    bits = round_digits_to_f64_bits(digits, negative, acc.fmt)
    return apply_specials(bits, acc.special)


def bits_to_float(bits) -> float:
    """A 1-element int64 bit-pattern tensor -> Python float."""
    return float(bits.reshape(1).view(torch.float64).item())
