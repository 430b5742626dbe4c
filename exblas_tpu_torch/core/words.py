"""The word accumulator of the exact GEMM and TRSV kernels, in PyTorch.

Kernels B5 and B10 (``ops/kernels/csrc/kulisch.cuh``) keep each exact
accumulator as one two's-complement integer of ``N_WORDS`` 64-bit words,
little-endian, bit 0 at ``2**-DOT_OFFSET_BITS``: the value of DOT_FORMAT's
216 base-2^20 limbs, 4,320 bits, sign-extended to 4,352.  A deposit is an
add with carries, not a spread over digits, and no word is ever redundant.

This module is the plain model of that format, used by the tests: the
conversions from and to the JAX canonical digits (``core/rounding.py``), and
the rounding from words step for step as ``kulisch.cuh`` does it:

1. the sign is the top bit of the top word;
2. the lowest nonzero word ``l`` (none: the value is +0.0);
3. the magnitude's words: 0 below ``l``, ``-w[l]`` at ``l``, ``~w[j]`` above
   ``l`` for a negative value (the two's complement ``~V + 1``, whose carry
   stops at ``l``), the words themselves for a positive one;
4. the top nonzero magnitude word ``t`` and the leading bit ``p_msb``;
5. the 55 bits ``[p_msb - 54, p_msb]`` from words ``t`` and ``t - 1``, and
   the sticky bit: the bits of those words below the window, or ``l`` below
   the window's low word;
6. ``ieee_encode_round`` (round to nearest even, subnormals, overflow).

The exact GEMM kernel B5 starts its words biased, each at 2^63
(``BIAS_WORD``), so that a carry or borrow out of a deposit stops at the
next word even where the sum changes sign, and takes the bias off once
before the rounding (``unbias_words``); arithmetic modulo 2^4352 makes the
result the unbiased sum.

Words are int64 tensors holding the 64-bit patterns.
"""

from __future__ import annotations

import torch

from .rounding import canonicalize_digits, ieee_encode_round
from .types import DOT_OFFSET_BITS, L_DOT, LIMB_BITS, LIMB_MASK

__all__ = ["N_WORDS", "WORD_BITS", "BIAS_WORD", "limbs_to_words",
           "words_to_digits", "deposit_words", "unbias_words", "round_words"]

WORD_BITS = 64
N_WORDS = 68  # 68 * 64 = 4352 >= 216 * 20 = 4320 bits
_ALL = -1     # a word of 64 ones, as an int64
_SIGN = -(1 << 63)
BIAS_WORD = _SIGN  # 2^63, each word's start in kulisch.cuh kBiasWord


def _lsr(x, s: int):
    """Logical right shift of int64 bit patterns by 0 <= s < 64."""
    return (x >> s) & ((1 << (WORD_BITS - s)) - 1) if s else x


def _bit_length(x):
    """Bits of the 64-bit patterns x read as unsigned (0 for 0)."""
    hi, lo = _lsr(x, 32), x & 0xFFFFFFFF
    e_hi = torch.frexp(hi.to(torch.float64))[1].to(torch.int64)
    e_lo = torch.frexp(lo.to(torch.float64))[1].to(torch.int64)
    return torch.where(hi != 0, 32 + e_hi, e_lo)


def limbs_to_words(limbs):
    """Redundant limbs (..., 216) -> words (..., 68) int64 of the same exact
    value (the kernels' conversion of a panel's accumulator)."""
    digits, negative = canonicalize_digits(limbs)
    d = digits.to(torch.int64)
    words = []
    for i in range(N_WORDS):
        w = torch.zeros_like(d[..., 0])
        lo = WORD_BITS * i
        for j in range(lo // LIMB_BITS, (lo + WORD_BITS - 1) // LIMB_BITS + 1):
            if j >= L_DOT:
                break
            s = LIMB_BITS * j - lo  # the digit's lsb within the word
            w = w | (d[..., j] << s if s >= 0 else d[..., j] >> -s)
        if lo + WORD_BITS > LIMB_BITS * L_DOT:  # sign extension
            top = LIMB_BITS * L_DOT - lo  # bits of the word held by digits
            ext = _ALL << max(top, 0)
            w = torch.where(negative, w | ext, w)
        words.append(w)
    return torch.stack(words, -1)


def words_to_digits(words):
    """Words (..., 68) -> (canonical digits int32 (..., 216), negative),
    the pair ``core.rounding.canonicalize_digits`` gives for the same
    value."""
    negative = words[..., -1] < 0
    digits = []
    for j in range(L_DOT):
        p = LIMB_BITS * j
        i, s = divmod(p, WORD_BITS)
        v = _lsr(words[..., i], s)
        if s > WORD_BITS - LIMB_BITS:
            v = v | (words[..., i + 1] << (WORD_BITS - s))
        digits.append(v & LIMB_MASK)
    return torch.stack(digits, -1).to(torch.int32), negative


def round_words(words, offset_bits: int = DOT_OFFSET_BITS):
    """Words (..., 68) -> binary64 bits (int64, ...), round to nearest
    even; an exact zero is +0.0.  Step for step ``kulisch.cuh``'s
    ``round_words`` (module doc)."""
    idx = torch.arange(N_WORDS, device=words.device)
    negative = words[..., -1] < 0
    nonzero = words != 0
    any_nonzero = nonzero.any(-1)
    # lowest nonzero word l
    l = torch.where(nonzero, idx, N_WORDS).amin(-1)
    mag = torch.where(idx < l[..., None], 0,
                      torch.where(idx == l[..., None], -words, ~words))
    mag = torch.where(negative[..., None], mag, words)
    # top nonzero magnitude word t and the leading bit
    t = torch.where(mag != 0, idx, -1).amax(-1).clamp(min=0)
    top = torch.gather(mag, -1, t[..., None])[..., 0]
    below = torch.gather(mag, -1, (t - 1).clamp(min=0)[..., None])[..., 0]
    below = torch.where(t > 0, below, 0)
    b = _bit_length(top) - 1              # leading bit within word t
    p_msb = WORD_BITS * t + b
    # the 55-bit window: top's bits [b - 54, b] over below's high bits
    up = (b - 54).clamp(min=0)            # window starts in word t
    down = (54 - b).clamp(min=0)          # bits taken from word t - 1
    m_t = torch.where(up > 0, _lsr_var(top, up),
                      torch.bitwise_left_shift(top, down))
    m_b = torch.where(down > 0,
                      _lsr_var(below, (WORD_BITS - down).clamp(
                          max=WORD_BITS - 1)), 0)
    m55 = (m_t | m_b) & ((1 << 55) - 1)
    # sticky: top's bits below the window, below's bits below it, or a
    # nonzero word under word t - 1 (the lowest nonzero word is l)
    st_top = (top & _low_mask(up)) != 0
    st_below = torch.where(down > 0, (below & _low_mask(WORD_BITS - down))
                           != 0, below != 0)
    sticky = st_top | st_below | (l < t - 1)
    bits = ieee_encode_round(negative.to(torch.int64),
                             p_msb - offset_bits, m55, sticky)
    return torch.where(any_nonzero, bits, torch.zeros_like(bits))


def _low_mask(k):
    """Masks of the k low bits, 0 <= k <= 64, per element."""
    return torch.where(k >= WORD_BITS, _ALL,
                       torch.bitwise_left_shift(
                           torch.ones_like(k), k.clamp(max=WORD_BITS - 1))
                       - 1)


def _lsr_var(x, s):
    """Logical right shift of int64 patterns by per-element 0 <= s < 64."""
    return (x >> s) & _low_mask(WORD_BITS - s)


def _ult(a, b):
    """a < b for int64 patterns read as unsigned."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def deposit_words(words, lo, hi, p, negative):
    """words + (-1)^negative * (hi:lo) * 2^p, modulo 2^4352, as the
    kernels' deposit gives it: the 128-bit (hi:lo) (int64 patterns, the
    exact product below 2^106) shifted to bit p >= 0 lands in words
    p // 64 .. + 2, a carry or borrow runs up from there, and one out of
    the top word is dropped.  All arguments broadcast over (...)."""
    idx = torch.arange(N_WORDS, device=words.device)
    wq, s = torch.div(p, WORD_BITS, rounding_mode="floor"), p % WORD_BITS
    x0 = torch.bitwise_left_shift(lo, s)
    x1 = torch.bitwise_left_shift(hi, s) | torch.where(
        s > 0, _lsr_var(lo, (WORD_BITS - s).clamp(max=WORD_BITS - 1)), 0)
    x2 = torch.where(s > 0, _lsr_var(hi, (WORD_BITS - s).clamp(
        max=WORD_BITS - 1)), 0)
    rel = idx - wq[..., None]
    add = torch.where(rel == 0, x0[..., None],
                      torch.where(rel == 1, x1[..., None],
                                  torch.where(rel == 2, x2[..., None], 0)))
    # -x = ~x + 1 over all 68 words
    add = torch.where(negative[..., None], ~add, add)
    carry = negative.to(torch.int64)
    out = []
    for i in range(N_WORDS):
        a, b = words[..., i], add[..., i]
        s1 = a + b
        c1 = _ult(s1, a)
        s2 = s1 + carry
        c2 = _ult(s2, s1)
        out.append(s2)
        carry = (c1 | c2).to(torch.int64)
    return torch.stack(out, -1)


def unbias_words(words):
    """Words (..., 68) less the bias (every word ``BIAS_WORD``), modulo
    2^4352: ``kulisch.cuh``'s ``unbias_words``, a borrow run from word 0
    up."""
    borrow = torch.zeros_like(words[..., 0])
    out = []
    for i in range(N_WORDS):
        v = words[..., i]
        sub = BIAS_WORD + borrow  # 2^63 or 2^63 + 1: no wrap
        out.append(v - sub)
        borrow = _ult(v, sub).to(torch.int64)
    return torch.stack(out, -1)
