"""The word accumulator of kernels B5 and B10 (``core/words.py``, the plain
model of ``ops/kernels/csrc/kulisch.cuh``) held bit for bit against the JAX
package's superaccumulator: the same exact integers, written as JAX
DOT_FORMAT limbs and as 68 two's-complement words, must give the same
canonical digits and the same rounded binary64 bits as
``exblas_tpu/core/rounding.py``.  Values are Python integers in units of
2^-2148 (bit 0 of DOT_FORMAT).  Tolerance is zero."""

import numpy as np
import pytest
import torch

from exblas_tpu.core import rounding as jround
from exblas_tpu.core.types import DOT_FORMAT as JDOT_FORMAT
from exblas_tpu.core.types import Superacc as JSuperacc
from exblas_tpu_torch.core import words as W
from exblas_tpu_torch.core.rounding import canonicalize_digits

OFF = 2148                      # DOT_FORMAT's bit 0 is 2^-2148
U64 = 1 << 64
MAX_FIN = ((1 << 53) - 1) << (OFF + 1023 - 52)

# name -> exact integer value of the accumulator
CASES = {
    "zero": 0,
    "one_ulp": 1,
    "minus_one_ulp": -1,
    "tie_even_down": (1 << 54) + 1,
    "tie_even_down_neg": -((1 << 54) + 1),
    "tie_even_up": ((1 << 54) + 3) << 1000,
    "tie_even_up_neg": -(((1 << 54) + 3) << 1001),
    "tie_across_words": ((1 << 54) + 1) << 100,
    "tie_broken_far_below": (((1 << 54) + 1) << 2000) + 1,
    "min_subnormal": 1 << (OFF - 1074),
    "subnormal_tie": 3 << (OFF - 1076),
    "half_min_subnormal_neg": -(1 << (OFF - 1075)),
    "below_half_min_subnormal": (1 << (OFF - 1075)) - 1,
    "above_half_min_subnormal": (1 << (OFF - 1075)) + 1,
    "largest_subnormal": ((1 << 52) - 1) << (OFF - 1074),
    "smallest_normal_by_rounding": (((1 << 53) - 1) << (OFF - 1075)) + 1,
    "max_finite": MAX_FIN,
    "max_finite_neg": -MAX_FIN,
    "overflow_by_tie": MAX_FIN + (1 << (OFF + 970)),
    "below_overflow_tie": MAX_FIN + (1 << (OFF + 970)) - 1,
    "two_pow_1024": 1 << (OFF + 1024),
    "borrow_through_words": -(1 << 4000),
    "borrow_far_sticky": -((1 << 3000) + 1),
    "word_min_neg": -(1 << 63),
    "two_words_neg": -(1 << 128),
    "top_headroom": (1 << 4238) - 1,
    "top_headroom_neg": -((1 << 4238) - 1),
}


def limbs_of(v: int) -> list:
    """JAX DOT_FORMAT limbs of v: canonical digits, a negative value's
    borrow parked in the top limb."""
    u = v % (1 << 4320)
    d = [(u >> (20 * j)) & 0xFFFFF for j in range(216)]
    if v < 0:
        d[-1] -= 1 << 20
    return d


def words_of(v: int) -> list:
    """The 68 two's-complement words of v, as int64 values."""
    u = v % (1 << 4352)
    out = []
    for i in range(W.N_WORDS):
        w = (u >> (64 * i)) & (U64 - 1)
        out.append(w - U64 if w >> 63 else w)
    return out


def _values():
    rng = np.random.default_rng(20261017)
    vals = dict(CASES)
    for i in range(96):
        nb = int(rng.integers(1, 4239))
        v = int.from_bytes(rng.bytes(540), "little") % (1 << nb)
        vals[f"random{i}"] = v if i % 2 else -v
    return vals


VALUES = _values()


@pytest.fixture(scope="module")
def state():
    """(names, exact values, port limbs, port words, JAX bits)."""
    names = list(VALUES)
    vals = [VALUES[k] for k in names]
    limbs = torch.tensor([limbs_of(v) for v in vals], dtype=torch.int64)
    words = torch.tensor([words_of(v) for v in vals], dtype=torch.int64)
    jacc = JSuperacc(limbs=np.asarray(limbs.numpy(), np.int32),
                     special=np.zeros((len(vals), 3), np.int32),
                     fmt=JDOT_FORMAT)
    jbits = np.asarray(jround.round_superacc_to_f64_bits(jacc)).view(
        np.int64)
    return names, vals, limbs, words, jbits


def test_limbs_to_words(state):
    _, _, limbs, words, _ = state
    assert torch.equal(W.limbs_to_words(limbs), words)


def test_words_to_digits_match_jax(state):
    names, _, limbs, words, _ = state
    digits, negative = W.words_to_digits(words)
    jd, jn = jround.canonicalize_digits(np.asarray(limbs.numpy(), np.int32))
    assert np.array_equal(digits.numpy(), np.asarray(jd).astype(np.int32))
    assert np.array_equal(negative.numpy(), np.asarray(jn))
    pd, pn = canonicalize_digits(limbs)
    assert torch.equal(digits, pd) and torch.equal(negative, pn)


@pytest.mark.parametrize("name", list(CASES) + ["random"])
def test_round_words_matches_jax(state, name):
    names, vals, _, words, jbits = state
    got = W.round_words(words).numpy()
    picks = [i for i, k in enumerate(names)
             if k == name or (name == "random" and k.startswith("random"))]
    for i in picks:
        assert int(got[i]) == int(jbits[i]), (
            f"{names[i]}: {int(got[i]) & (U64 - 1):#018x} != JAX "
            f"{int(jbits[i]) & (U64 - 1):#018x}")


def test_round_words_edges():
    """The named edges give the bits IEEE says, independent of JAX."""
    def bits(v):
        w = torch.tensor([words_of(v)], dtype=torch.int64)
        return int(W.round_words(w)[0]) & (U64 - 1)

    assert bits(0) == 0                                  # +0.0
    assert bits(CASES["half_min_subnormal_neg"]) == 1 << 63   # -0.0
    assert bits(CASES["min_subnormal"]) == 1
    assert bits(CASES["subnormal_tie"]) == 1             # 0.75 ulp -> 1
    assert bits(CASES["max_finite"]) == 0x7FEFFFFFFFFFFFFF
    assert bits(CASES["overflow_by_tie"]) == 0x7FF0000000000000
    assert bits(CASES["below_overflow_tie"]) == 0x7FEFFFFFFFFFFFFF
    assert bits(-CASES["two_pow_1024"]) == 0xFFF0000000000000

    def f64(x):
        return int(np.float64(x).view(np.uint64))

    assert bits(((1 << 54) + 1) << OFF) == f64(2.0 ** 54)      # tie, even
    assert bits(((1 << 54) + 3) << OFF) == f64(2.0 ** 54 + 4)  # tie, up
    assert bits(-(((1 << 54) + 2) << OFF)) == f64(-(2.0 ** 54 + 2))


@pytest.mark.parametrize("case", ["carry_out_of_top", "borrow_many_words",
                                  "random"])
def test_deposit_words(case):
    """The kernels' deposit: a carry out of the top word is dropped (the
    value is taken modulo 2^4352), a borrow runs through many words, and
    random products land as Python's exact integers say."""
    rng = np.random.default_rng(7)
    if case == "carry_out_of_top":
        trials = [(-1, 1, 0, False), (-(1 << 4000), 1, 4000, False)]
    elif case == "borrow_many_words":
        trials = [(0, 1, 0, True), (1 << 4200, 3, 0, True),
                  (1, (1 << 106) - 1, 4000, True)]
    else:
        trials = []
        for _ in range(64):
            v = VALUES[f"random{int(rng.integers(96))}"]
            m = int(rng.integers(1, 1 << 53)) * int(rng.integers(1, 1 << 53))
            trials.append((v, m, int(rng.integers(0, 4100)),
                           bool(rng.random() < 0.5)))
    for v, m, p, neg in trials:
        lo = m & (U64 - 1)
        w = W.deposit_words(
            torch.tensor([words_of(v)], dtype=torch.int64),
            torch.tensor([lo - U64 if lo >> 63 else lo]),
            torch.tensor([m >> 64]), torch.tensor([p]), torch.tensor([neg]))
        want = v + (-m if neg else m) * (1 << p)
        assert w[0].tolist() == words_of(want), (v, m, p, neg)


@pytest.mark.parametrize("case", ["random", "alternating"])
def test_biased_deposits(case):
    """B5's biased words: deposits into words that start at BIAS_WORD,
    then unbias_words, give the words of the exact sum and JAX's bits,
    also where the sum crosses zero at every product."""
    rng = np.random.default_rng(11)
    terms = []
    for i in range(40):
        if case == "alternating":  # -t, +t, -t, ...: 0 is crossed each time
            m, p, neg = 3 << 52, 28, i % 2 == 0
        else:
            m = int(rng.integers(1, 1 << 53)) * int(rng.integers(1, 1 << 53))
            p, neg = int(rng.integers(0, 4100)), bool(rng.random() < 0.5)
        terms.append((m, p, neg))
    w = torch.full((1, W.N_WORDS), W.BIAS_WORD, dtype=torch.int64)
    exact = 0
    for m, p, neg in terms:
        lo = m & (U64 - 1)
        w = W.deposit_words(w, torch.tensor([lo - U64 if lo >> 63 else lo]),
                            torch.tensor([m >> 64]), torch.tensor([p]),
                            torch.tensor([neg]))
        exact += (-m if neg else m) << p
    got = W.unbias_words(w)
    assert got[0].tolist() == words_of(exact)
    jacc = JSuperacc(limbs=np.asarray([limbs_of(exact)], np.int32),
                     special=np.zeros((1, 3), np.int32), fmt=JDOT_FORMAT)
    jbits = np.asarray(jround.round_superacc_to_f64_bits(jacc)).view(np.int64)
    assert int(W.round_words(got)[0]) == int(jbits[0])
