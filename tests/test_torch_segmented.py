"""``exsum_segmented`` / ``exsum_segmented_bits`` of the PyTorch port held
bit for bit against the JAX package's ``exsum_segmented`` (XLA
``segment_sum``) and the exact oracle: random ids and the same ids
permuted, empty segments, ids out of range (dropped, as JAX drops them),
specials in each segment, no segments at all, the chunked deposit and
the device rules.  Tolerance is zero.

JAX compiles its segmented sum once a (length, segment count); the
random cases are padded with +0.0 in segment 0 (which adds nothing) to
one shape, and each JAX result is computed once a module."""

import functools
import importlib

import numpy as np
import pytest
import torch

import exblas_tpu_torch as xt
from oracle import exact_sum_with_specials

N_PAD = 4096   # the JAX references' length
S = 16         # and segment count

CASES = {
    "fpuniform_signed": lambda n, r: xt.init_fpuniform(n, 60, -20, seed=1)
    * np.where(r.rand(n) < 0.5, -1.0, 1.0),
    "lognormal": lambda n, r: xt.init_lognormal(n, 0.0, 3.0, seed=2),
    "wide": lambda n, r: xt.init_fpuniform(n, 600, -300, seed=3)
    * np.where(r.rand(n) < 0.5, -1.0, 1.0),
    "cancellation": lambda n, r: np.concatenate(
        [v := xt.init_fpuniform(n // 2, 80, 10, seed=4), -v[::-1]]),
    "subnormals": lambda n, r: xt.init_fpuniform(n, 40, -1070, seed=5)
    * np.where(r.rand(n) < 0.5, -1.0, 1.0),
}


@functools.lru_cache(maxsize=None)
def _jax_segmented():
    import jax

    from exblas_tpu.ops.exsum import exsum_segmented_bits

    return jax.jit(exsum_segmented_bits, static_argnames="num_segments")


def jax_segmented(x, ids, num_segments):
    """JAX's per-segment bits (uint64) of x over ids, padded to N_PAD."""
    from exblas_tpu.core.ieee import split_f64

    x = np.asarray(x, np.float64)
    ids = np.asarray(ids, np.int32)
    pad = N_PAD - len(x)
    x = np.concatenate([x, np.zeros(pad)])
    ids = np.concatenate([ids, np.zeros(pad, np.int32)])
    b = split_f64(x)
    return np.asarray(_jax_segmented()(b.hi, b.lo, ids,
                                       num_segments=num_segments))


@pytest.fixture(scope="module")
def jax_cache():
    cache = {}

    def get(name, x, ids, num_segments=S):
        if name not in cache:
            cache[name] = jax_segmented(x, ids, num_segments)
        return cache[name]

    return get


def port_bits(x, ids, num_segments=S):
    return xt.exsum_segmented(x, ids, num_segments,
                              device="cpu").view(np.uint64)


def oracle_bits(x, ids, num_segments=S):
    return np.array([exact_sum_with_specials(x[ids == s])
                     for s in range(num_segments)]).view(np.uint64)


@pytest.mark.parametrize("name", CASES)
def test_segmented_random_ids_match_jax_and_oracle(name, jax_cache):
    r = np.random.RandomState(10)
    x = CASES[name](3000, r)
    ids = r.randint(0, S, len(x))
    got = port_bits(x, ids)
    np.testing.assert_array_equal(got, jax_cache(name, x, ids))
    np.testing.assert_array_equal(got, oracle_bits(x, ids))


@pytest.mark.parametrize("name", ["fpuniform_signed", "wide"])
def test_segmented_permuted_ids(name, jax_cache):
    """The same (value, id) pairs in another order give the same bits."""
    r = np.random.RandomState(10)
    x = CASES[name](3000, r)
    ids = r.randint(0, S, len(x))
    perm = np.random.RandomState(11).permutation(len(x))
    np.testing.assert_array_equal(port_bits(x[perm], ids[perm]),
                                  jax_cache(name, x, ids))


def test_segmented_empty_segments(jax_cache):
    r = np.random.RandomState(12)
    x = CASES["lognormal"](2000, r)
    ids = r.choice([1, 4, 5, 11], len(x))
    got = port_bits(x, ids)
    np.testing.assert_array_equal(got, jax_cache("empty", x, ids))
    empty = np.setdiff1d(np.arange(S), [1, 4, 5, 11])
    assert (got[empty] == 0).all()  # +0, not -0


def test_segmented_out_of_range_ids_dropped(jax_cache):
    # the probe of ROADMAP queue A item 1, with JAX's values
    x = np.array([1.0, 2.0, 4.0, 8.0, 16.0, np.inf])
    got = xt.exsum_segmented(x, [0, 1, -1, 3, 2, 5], 3, device="cpu")
    np.testing.assert_array_equal(got, [1.0, 2.0, 16.0])
    # random ids, a fifth of them out of range on either side
    r = np.random.RandomState(13)
    x = CASES["fpuniform_signed"](3000, r)
    ids = r.randint(-4, S + 4, len(x))
    x[ids >= S] = np.nan            # dropped: no NaN may show
    x[ids < 0] = -np.inf
    got = port_bits(x, ids)
    np.testing.assert_array_equal(got, jax_cache("out_of_range", x, ids))
    keep = (ids >= 0) & (ids < S)
    np.testing.assert_array_equal(got, oracle_bits(x[keep], ids[keep]))


def test_segmented_specials_per_segment(jax_cache):
    inf, nan = np.inf, np.nan
    got = xt.exsum_segmented([1, -inf, inf, nan, -inf, 5], [0, 1, 1, 2, 0, 3],
                             4, device="cpu")
    np.testing.assert_array_equal(got.view(np.uint64), np.array(
        [-inf, nan, nan, 5.0]).view(np.uint64))
    r = np.random.RandomState(14)
    x = CASES["fpuniform_signed"](3000, r)
    ids = r.randint(0, S, len(x))
    # segment s gets the specials of pattern s % 6
    patterns = [(), (nan,), (inf,), (-inf,), (inf, -inf), (-inf, -inf, 1e308)]
    for s in range(S):
        where = np.nonzero(ids == s)[0]
        for j, v in enumerate(patterns[s % 6]):
            x[where[j]] = v
    got = port_bits(x, ids)
    np.testing.assert_array_equal(got, jax_cache("specials", x, ids))
    np.testing.assert_array_equal(got, oracle_bits(x, ids))


def test_segmented_no_segments():
    got = xt.exsum_segmented(np.ones(5), np.zeros(5, np.int64), 0,
                             device="cpu")
    assert got.shape == (0,) and got.dtype == np.float64
    assert xt.exsum_segmented([], [], 2, device="cpu").view(
        np.uint64).tolist() == [0, 0]


def test_segmented_overflow_per_segment(jax_cache):
    """Each segment rounds on its own: one overflows to +Inf, its
    neighbour cancels to +0, a third stays finite above DBL_MAX's
    partial sums."""
    big = np.finfo(np.float64).max
    x = np.array([big, big, big, -big, big, big, -big, 1.0])
    ids = np.array([0, 0, 1, 1, 2, 2, 2, 3])
    got = port_bits(x, ids)
    np.testing.assert_array_equal(got, jax_cache("overflow", x, ids))
    assert got[0] == np.float64(np.inf).view(np.uint64)
    assert got[1] == 0 and got[2] == np.float64(big).view(np.uint64)


def test_segmented_chunked_deposit(monkeypatch, jax_cache):
    """Chunk boundaries inside the data change nothing."""
    r = np.random.RandomState(10)
    x = CASES["wide"](3000, r)
    ids = r.randint(0, S, len(x))
    monkeypatch.setattr(importlib.import_module("exblas_tpu_torch.ops.exsum"),
                        "SEGMENT_CHUNK", 257)
    np.testing.assert_array_equal(port_bits(x, ids), jax_cache("wide", x, ids))


def test_segmented_bits_on_tensors():
    """The tensor entry flattens N-D values and ids; the numpy entry agrees
    with it and with per-segment ``exsum``."""
    r = np.random.RandomState(15)
    x = CASES["lognormal"](600, r).reshape(20, 30)
    ids = r.randint(0, 7, (20, 30))
    bits = xt.exsum_segmented_bits(torch.from_numpy(x).view(torch.int64),
                                   torch.from_numpy(ids), 7)
    assert bits.dtype == torch.int64 and bits.shape == (7,)
    got = xt.exsum_segmented(x, ids, 7, device="cpu")
    np.testing.assert_array_equal(bits.numpy(), got.view(np.int64))
    for s in range(7):
        assert got[s] == xt.exsum(x[ids == s], device="cpu")


def test_segmented_exports_and_errors(monkeypatch):
    from exblas_tpu_torch import ops

    assert xt.exsum_segmented is ops.exsum_segmented
    assert xt.exsum_segmented_bits is ops.exsum_segmented_bits
    assert {"exsum_segmented", "exsum_segmented_bits"} <= set(xt.__all__)
    with pytest.raises(ValueError):
        xt.exsum_segmented(np.ones(4), np.zeros(3, np.int64), 2,
                           device="cpu")
    with pytest.raises(TypeError):
        xt.exsum_segmented_bits(torch.ones(4, dtype=torch.float64),
                                torch.zeros(4, dtype=torch.int64), 2)
    # numpy input goes to the CUDA device; without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        xt.exsum_segmented(np.ones(4), np.zeros(4, np.int64), 2)
