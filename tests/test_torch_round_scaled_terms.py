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
from torch_parity import u64


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
