"""Exact integers held as limbs, and their correctly rounded float64.

Plain PyTorch: this file imports nothing of the program under test.

A number is a stack of int64 limbs ``L`` (limb axis first) of radix
``2**s``, worth ``sum_p L[p] * 2**(s*p) * 2**base``, where ``base`` is an
int64 tensor that broadcasts over the other axes.  Before
:func:`normalize` a limb may hold any int64; after it every limb but the
top one lies in ``[0, 2**s)`` and the top one carries the sign.

The domain is finite float64 without subnormals, which is what the
benchmark's generators draw; :func:`check_domain` raises outside it.
"""

from __future__ import annotations

import torch

_BIAS = 1023
_MAG = (1 << 63) - 1
_SIGN = -(1 << 63)
NONE = -(1 << 40)  # the top exponent given to a zero


def check_domain(*xs) -> None:
    """Raise unless every tensor is float64, finite and free of
    subnormals."""
    for x in xs:
        if x is None:
            continue
        if x.dtype != torch.float64:
            raise TypeError(f"expected float64, got {x.dtype}")
        expf = (x.view(torch.int64) >> 52) & 0x7FF
        if bool((expf == 0x7FF).any()):
            raise ValueError("the reference takes finite inputs only")
        if bool(((expf == 0) & (x != 0)).any()):
            raise ValueError("the reference takes no subnormal inputs")


def top_exponent(x: torch.Tensor) -> torch.Tensor:
    """int64 ``e`` with ``2**e <= |x| < 2**(e+1)`` (normal ``x``), and
    :data:`NONE` for a zero."""
    expf = (x.view(torch.int64) >> 52) & 0x7FF
    return torch.where(x != 0, expf - _BIAS, NONE)


def pow2(e) -> torch.Tensor:
    """The float64 ``2**e`` of an integer tensor ``e`` in [-1022, 1023]."""
    e = torch.as_tensor(e, dtype=torch.int64)
    if bool(((e < -1022) | (e > 1023)).any()):
        raise ValueError("scale outside the normal range")
    return ((e + _BIAS) << 52).view(torch.float64)


def digit_count(x: torch.Tensor, scale: torch.Tensor, s: int) -> int:
    """How many radix-``2**s`` digits below ``2**scale`` hold every
    nonzero ``x`` exactly (``scale`` broadcasts against ``x``)."""
    nz = x != 0
    if not bool(nz.any()):
        return 1
    bits = torch.where(nz, scale - (top_exponent(x) - 52), 0)
    return max(1, -(-int(bits.max()) // s))


def digits(x: torch.Tensor, scale: torch.Tensor, s: int,
           count: int) -> list[torch.Tensor]:
    """``x = 2**scale * sum_t d[t] * 2**(-s*(t+1))`` with integral float64
    digits ``|d[t]| < 2**s`` of the sign of ``x``.  Every step is exact;
    raises if ``count`` digits leave a remainder."""
    low = torch.where(x != 0, top_exponent(x) - scale, 0)
    if bool((low < -1022).any()):
        raise ValueError("digits: an element lies too far below the scale")
    r = x * pow2(-scale)
    radix = float(1 << s)
    out = []
    for _ in range(count):
        r = r * radix
        d = torch.trunc(r)
        r = r - d
        out.append(d)
    if bool((r != 0).any()):
        raise ArithmeticError("digits: a remainder is left")
    return out


def normalize(limbs: torch.Tensor, s: int) -> torch.Tensor:
    """Carry every limb but the top one into ``[0, 2**s)``."""
    limbs = limbs.clone()
    mask = (1 << s) - 1
    for p in range(limbs.shape[0] - 1):
        carry = limbs[p] >> s
        limbs[p] &= mask
        limbs[p + 1] += carry
    return limbs


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bits of each ``0 <= v < 2**53`` (0 for 0)."""
    return torch.frexp(v.to(torch.float64)).exponent.to(torch.int64)


def round_to_f64_bits(limbs: torch.Tensor, base: torch.Tensor,
                      s: int) -> torch.Tensor:
    """The binary64 bits (int64) of the number ``limbs`` (normalized, see
    module doc) times ``2**base``, rounded to nearest, ties to even.  An
    exact zero gives +0.  The top limb must leave room: a magnitude that
    reaches it raises, as does a result outside the normal range."""
    neg = limbs[-1] < 0
    mag = normalize(torch.where(neg, -limbs, limbs), s)
    if bool((mag[-1] != 0).any()):
        raise ArithmeticError("round_to_f64_bits: no spare top limb")
    count = mag.shape[0]
    shape = (count,) + (1,) * (mag.dim() - 1)
    nz = mag != 0
    h = torch.where(nz, torch.arange(count).view(shape).to(mag.device),
                    -1).amax(0)
    zero = h < 0
    h = h.clamp(min=0)

    def limb(q):
        v = mag.gather(0, q.clamp(min=0).unsqueeze(0)).squeeze(0)
        return torch.where(q >= 0, v, 0)

    # A 62-bit window whose top bit is the number's top bit, and a sticky
    # bit for everything below the window.
    top = h * s + _bit_length(limb(h)) - 1
    low = top - 61
    window = torch.zeros_like(h)
    sticky = torch.zeros_like(zero)
    reach = (62 + s - 1) // s + 1
    for o in range(reach + 1):
        q = h - o
        v = limb(q)
        shift = q * s - low
        left = shift >= 0
        right = (-shift).clamp(min=0, max=62)
        window = window + torch.where(left, v << shift.clamp(min=0, max=62),
                                      v >> right)
        sticky |= ~left & ((v & ((1 << right) - 1)) != 0)
    below = h - reach - 1
    seen = torch.cumsum(nz.to(torch.int64), 0)
    sticky |= (below >= 0) & (
        seen.gather(0, below.clamp(min=0).unsqueeze(0)).squeeze(0) > 0)

    mant = window >> 9
    rem = window & 511
    up = (rem > 256) | ((rem == 256) & (sticky | ((mant & 1) == 1)))
    mant = mant + up.to(torch.int64)
    carry = mant >> 53
    mant = mant >> carry
    biased = top + carry + base + _BIAS
    if bool((((biased < 1) | (biased > 2046)) & ~zero).any()):
        raise ArithmeticError("round_to_f64_bits: result outside the "
                              "normal range")
    bits = (biased << 52) | (mant & ((1 << 52) - 1))
    bits = torch.where(neg, bits | _SIGN, bits)
    return torch.where(zero, 0, bits)


def ordered(bits: torch.Tensor) -> torch.Tensor:
    """binary64 bits mapped to int64 that order as the values do (both
    zeros to 0), so that a difference counts ulps."""
    return torch.where(bits >= 0, bits, -(bits & _MAG))
