"""The anchored window kernels' arithmetic, in plain Python integers.

Kernel B11 (``ops/kernels/csrc/sum_mxu.cu``, ``anchored.cuh``
``SumFrame``) keeps each thread's sum of covered elements as int64 sums
of the nwa + 1 32-bit words of the frame whose bit 0 has exponent
E + 1 - 32 nwa, positive and negative elements apart.  A covered element
is its significand m (< 2^53) times 2^sh, 0 <= sh <= 32 nwa - 53: m
shifted by sh mod 32 is three words, added at frame words sh // 32 ..
sh // 32 + 2 of its sign's sums.  :func:`element_words` models that
placement; every word is below 2^32, so :data:`MAX_N` elements keep each
sum below 2^62 (:func:`sums_bound`).

The last blocks of B11 and the anchored dot kernel B12 (``round.cuh``
``finish_frame``) carry the workspace's word sums into canonical terms
and round them once with the device code of kernel B3
(``round_scaled_terms``: ``add_scaled`` into base-2^20 limbs, then
``round_limbs`` and ``encode_round``).  :func:`last_block` follows those
steps one by one, as the device runs them.

Bits are returned as int64 patterns (Python ints in [-2^63, 2^63)).
"""

from __future__ import annotations

__all__ = ["MAX_N", "element_words", "sums_bound", "canonical_terms",
           "round_frame_terms", "last_block"]

MAX_N = 1 << 30      # sum_mxu.MAX_N_MXU: the most elements a call adds
_M32 = (1 << 32) - 1
_LIMB_BITS = 20
_LIMB_MASK = (1 << _LIMB_BITS) - 1
_PINF = 0x7FF0000000000000
_SIGN = 1 << 63


def _int64(u: int) -> int:
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >> 63 else u


def element_words(m: int, sh: int, nwa: int) -> tuple:
    """(q, words): the frame word q = sh // 32 and the three words
    y_0..y_2 of m << (sh mod 32) that a covered element adds at frame
    words q, q + 1 and q + 2 of its sign's sums (``SumFrame.add``: the
    low word shifted, then two funnel shifts)."""
    assert 0 <= m < 1 << 53 and 0 <= sh <= 32 * nwa - 53
    r = sh & 31
    m0, m1 = m & _M32, m >> 32
    y0 = (m0 << r) & _M32
    y1 = (((m1 << 32) | m0) << r >> 32) & _M32
    y2 = (m1 << r) >> 32
    return sh >> 5, (y0, y1, y2)


def sums_bound(n: int = MAX_N) -> int:
    """The most any one sum of a sign's words can reach over n elements:
    each adds one word below 2^32 to it."""
    return n * _M32


def canonical_terms(sums: list) -> list:
    """The carry pass of ``finish_frame``: terms 0..T-2 in [0, 2^32), the
    last the value >> 32 (T - 1), floor."""
    out, carry = [], 0
    for s in sums[:-1]:
        t = s + carry
        out.append(t & _M32)
        carry = t >> 32
    out.append(sums[-1] + carry)
    return out


def _add_scaled(limbs: list, v: int, p: int) -> None:
    q = p // _LIMB_BITS
    w = v * (1 << (p - q * _LIMB_BITS))
    limbs[q] += w & _LIMB_MASK
    limbs[q + 1] += (w >> _LIMB_BITS) & _LIMB_MASK
    limbs[q + 2] += w >> (2 * _LIMB_BITS)


def _encode_round(negative: bool, e_msb: int, m55: int,
                  sticky_below: bool) -> int:
    """``round.cuh`` ``encode_round``: m55 * 2^(e_msb - 54) plus a sticky
    tail, to nearest even, with subnormals and overflow to +-Inf."""
    subn = e_msb < -1022
    d = -1022 - e_msb if subn else 0
    c = min(d + 2, 63)
    m53 = m55 >> c
    guard = (m55 >> (c - 1)) & 1
    sticky = sticky_below or (m55 & ((1 << (c - 1)) - 1)) != 0
    if d >= 60:
        m53, guard, sticky = 0, 0, True
    m = m53 + (1 if guard and (sticky or m53 & 1) else 0)
    e = e_msb
    if not subn and m == 1 << 53:
        m, e = 1 << 52, e + 1
    expf = (m >> 52) & 1 if subn else e + 1023
    bits = (expf << 52) | (m & ((1 << 52) - 1))
    if not subn and e + 1023 >= 2047:
        bits = _PINF
    return _int64(bits | _SIGN if negative else bits)


def _round_limbs(limbs: list, offset_bits: int) -> int:
    """``round.cuh`` ``round_limbs`` over all of ``limbs`` (modified)."""
    nl = len(limbs)
    carry = 0
    for j in range(nl):
        d = limbs[j] + carry
        limbs[j] = d & _LIMB_MASK
        carry = (d - limbs[j]) >> _LIMB_BITS
    negative = carry < 0
    if negative:
        borrow = 1
        for j in range(nl):
            t = (limbs[j] ^ _LIMB_MASK) + borrow
            limbs[j] = t & _LIMB_MASK
            borrow = t >> _LIMB_BITS
    jstar = nl - 1
    while jstar >= 0 and limbs[jstar] == 0:
        jstar -= 1
    if jstar < 0:
        return 0
    p_msb = jstar * _LIMB_BITS + limbs[jstar].bit_length() - 1
    pos_low = p_msb - 54
    j0 = (pos_low + 60) // _LIMB_BITS - 3
    m55, sticky = 0, any(limbs[j] != 0 for j in range(0, max(j0, 0)))
    for j in range(max(j0, 0), jstar + 1):
        s = _LIMB_BITS * j - pos_low
        if s >= 0:
            m55 |= limbs[j] << s
        else:
            m55 |= limbs[j] >> -s
            sticky = sticky or (limbs[j] & ((1 << -s) - 1)) != 0
    return _encode_round(negative, p_msb - offset_bits,
                         m55 & ((1 << 55) - 1), sticky)


def round_frame_terms(terms: list, e: int) -> int:
    """``round_scaled_terms`` at the frame's positions (term k at bit
    32 k): sum_k terms[k] * 2^(32 k + e) rounded once, each term's 32-bit
    halves added into zeroed limbs, then ``round_limbs``."""
    t = len(terms)
    limbs = [0] * ((32 * (t - 1) + 72) // _LIMB_BITS + 2)
    for k, v in enumerate(terms):
        _add_scaled(limbs, v & _M32, 32 * k)
        _add_scaled(limbs, v >> 32, 32 * k + 32)
    return _round_limbs(limbs, -e)


def last_block(sums: list, e: int):
    """(canonical terms, bits) as the last block of B11 or B12 writes them
    from the workspace's word sums, frame bit 0 at 2^e."""
    terms = canonical_terms(sums)
    return terms, round_frame_terms(terms, e)
