"""Kernel B3's plain version (``round_scaled_terms_torch``) held against the
JAX package's ``round_scaled_terms`` in TPU interpret mode on the edge
cases of ``tests/test_round_scaled_terms.py`` and against the exact
Fraction rounding on random terms, including terms of any int64 size
(the port splits each term in 32-bit halves).  Tolerance is zero.  The
CUDA kernel is held against the plain version on the card by
``chip_smoke.py``."""

from fractions import Fraction

import numpy as np
import pytest
import torch

from exblas_tpu_torch.ops.kernels.round_in_kernel import (
    round_scaled_terms_cuda, round_scaled_terms_torch, term_limbs_count)
from oracle import _round_fraction
from torch_parity import U64, u64


def _port(vals, pos, eadj) -> int:
    return u64(round_scaled_terms_torch(torch.tensor(vals, dtype=torch.int64),
                                        pos, eadj))


def _fraction_bits(vals, pos, eadj) -> int:
    v = sum(int(x) << int(p) for x, p in zip(vals, pos))
    return u64(np.float64(_round_fraction(Fraction(v) * Fraction(2) ** eadj))
               .view(np.uint64))


# (vals, pos, e_adjust, l_rel) of tests/test_round_scaled_terms.py:37-47
EDGES = [
    ([5], [0], 0, 3),
    ([5, -3], [0, 8], -10, 3),
    ([0] * 4, [0, 20, 40, 60], 0, 6),            # zero -> +0
    ([1, -1], [0, 0], 0, 3),                     # exact cancellation
    ([-(1 << 40), 1], [0, 0], 5, 5),
    ([1], [0], 1100, 3),                         # overflow -> +Inf
    ([-1], [0], 1100, 3),                        # -> -Inf
    ([3], [0], -1074, 3),                        # subnormal
    ([1], [0], -1100, 3),                        # underflow -> +0
]


@pytest.mark.parametrize("vals,pos,eadj,l_rel", EDGES)
def test_edges_match_jax_interpret(vals, pos, eadj, l_rel):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from exblas_tpu.ops.kernels.round_in_kernel import round_scaled_terms

    with pltpu.force_tpu_interpret_mode():
        hi, lo = round_scaled_terms(jnp.asarray(vals, jnp.int64), tuple(pos),
                                    jnp.int32(eadj), l_rel)
    want = (int(hi) << 32) | int(lo)
    got = _port(vals, pos, eadj)
    assert got == want == _fraction_bits(vals, pos, eadj), (
        f"{got:#x} {want:#x}")


@pytest.mark.parametrize("seed", range(4))
def test_random_vs_fraction(seed):
    """JAX's contract (|v| < 2^52, positions below 300) and beyond it:
    terms of up to 63 bits at positions up to 1000, exponents from deep
    underflow to overflow."""
    rng = np.random.RandomState(seed)
    for k in range(60):
        t = int(rng.randint(1, 129))
        top = 1 << (52 if k % 2 else 63)
        vals = [int(v) for v in rng.randint(1 - top, top - 1, t,
                                            dtype=np.int64)]
        if k % 7 == 0:
            vals[-1] = -sum(vals[:-1]) if t > 1 else 0   # exact cancellation
            vals[-1] = max(min(vals[-1], top - 1), -top)
        pos = [int(p) for p in rng.randint(0, 300 if k % 2 else 1000, t)]
        if k % 7 == 0:
            pos = [pos[0]] * t
        eadj = int(rng.randint(-1300, 1100))
        assert _port(vals, pos, eadj) == _fraction_bits(vals, pos, eadj), (
            seed, k)


def test_limb_count_and_contract():
    # the limbs hold 128 terms of 2^63 at the top position, with the sign
    pos = (0, 320)
    assert 20 * term_limbs_count(pos) > 320 + 63 + 7 + 1
    vals = [(1 << 63) - 1] * 2
    assert _port(vals, pos, -400) == _fraction_bits(vals, pos, -400)
    with pytest.raises(ValueError, match="int64 of shape"):
        round_scaled_terms_torch(torch.zeros(3, dtype=torch.int64), (0, 1), 0)
    with pytest.raises(ValueError, match="terms"):
        round_scaled_terms_torch(torch.zeros(129, dtype=torch.int64),
                                 tuple(range(129)), 0)


def test_cuda_wrapper_refuses_cpu_tensor():
    before = round_scaled_terms_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        round_scaled_terms_cuda(torch.tensor([1], dtype=torch.int64), (0,),
                                torch.tensor(0, dtype=torch.int32))
    assert round_scaled_terms_cuda.launches == before


# --- the last block of B11 and B12 (core/window.py) ----------------------------

def _plain(sums, e) -> int:
    return _port(sums, tuple(32 * k for k in range(len(sums))), e)


@pytest.mark.parametrize("seed", range(3))
def test_last_block_model_matches_plain_rounding(seed):
    """The last block's carry into canonical terms and its rounding, step
    for step as the device runs them, give the exact value's digits and
    round_scaled_terms_torch's bits on random workspaces of B11 (4 to 6
    sums) and B12 (11 sums), sums below 2^62 in magnitude, exponents from
    deep underflow to overflow."""
    from exblas_tpu_torch.core import window

    rng = np.random.RandomState(100 + seed)
    for k in range(60):
        t = (4, 5, 6, 11)[k % 4]
        top = 1 << int(rng.choice((20, 40, 62)))
        sums = [int(v) for v in rng.randint(-top + 1, top, t,
                                            dtype=np.int64)]
        e = int(rng.randint(-1500, 1100))
        terms, bits = window.last_block(sums, e)
        value = sum(v << (32 * i) for i, v in enumerate(sums))
        assert sum(v << (32 * i) for i, v in enumerate(terms)) == value
        assert all(0 <= v < 1 << 32 for v in terms[:-1])
        assert terms[-1] == value >> (32 * (t - 1))
        assert bits & U64 == _plain(sums, e) == _fraction_bits(
            sums, [32 * i for i in range(t)], e), (seed, k)


# (sums, e): a negative total; an exact zero (+0); a subnormal result of
# B11 at the lowest anchor (-1023, nwa 3: e = -1023 + 1 - 96); overflow
# of B11 at anchor 1032 (nwa 5: e = 1032 + 1 - 160) and of B12 at anchors
# 1032 (e = 2 * 1032 + 2 - 320), to +Inf and -Inf
LAST_BLOCK_EDGES = [
    ([5, -3, 7, -(1 << 40)], -96),
    ([1 << 32, -1, 0, 0], 0),
    ([(1 << 32) - 1, (1 << 20) + 3, 0, 0], -1023 + 1 - 96),
    ([0, 0, 0, 0, 1 << 31, 7], 1032 + 1 - 160),
    ([0, 0, 0, 0, 0, -1], 1032 + 1 - 160),
    ([0] * 10 + [1], 2 * 1032 + 2 - 320),
    ([12345] + [0] * 9 + [-1], 2 * 1032 + 2 - 320),
]


@pytest.mark.parametrize("sums,e", LAST_BLOCK_EDGES)
def test_last_block_model_edges(sums, e):
    from exblas_tpu_torch.core import window

    _, bits = window.last_block(sums, e)
    want = _plain(sums, e)
    assert bits & U64 == want == _fraction_bits(
        sums, [32 * i for i in range(len(sums))], e)
    value = sum(v << (32 * i) for i, v in enumerate(sums))
    f = float(np.uint64(want).view(np.float64))
    if value == 0:
        assert want == 0                           # +0
    elif value < 0:
        assert want >> 63 == 1
    if e >= 873:
        assert np.isinf(f)
    if e == -1118:
        assert 0 < f < np.finfo(np.float64).tiny   # subnormal
