"""ExSUM in the PyTorch port held bit for bit against the JAX package
(``impl="xla"`` and the B2 Pallas kernels in TPU interpret mode) and
against the exact oracle, plus the IEEE edge cases, invariance under
permutation and partition, the fpe/early_exit knobs, inca/offset, the
C++ host backend and the device rules.  Tolerance is zero.  The CUDA
kernels themselves are held against the plain path on the card by
``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import exblas_tpu_torch as xt
from exblas_tpu_torch.core.rounding import round_superacc_to_f64_bits
from oracle import bits_of, exact_sum, exact_sum_with_specials
from torch_parity import (assert_same_bits, assert_same_state, jax_state,
                          jax_sum_bits, pallas_interpret, port_state,
                          port_sum_bits, u64)

N = 1000  # one shape for every JAX comparison keeps its compiles few

CASES = [
    ("naive", lambda n: xt.init_naive(n)),
    ("std_dyn_range", lambda n: xt.init_fpuniform(n, 2, 0, seed=1)),
    ("large_dyn_range", lambda n: xt.init_fpuniform(n, 50, 20, seed=2)),
    ("wide", lambda n: xt.init_fpuniform(n, 300, -150, seed=3)),
    ("wide_signed", lambda n: xt.init_fpuniform(n, 200, 90, seed=3) *
        np.where(np.random.RandomState(4).rand(n) < 0.5, -1.0, 1.0)),
    ("lognormal", lambda n: xt.init_lognormal(n, 0.0, 2.0, seed=5)),
    ("ill_cond_1e30", lambda n: xt.init_ill_cond(n, 1e30, seed=6)),
    ("cancellation", lambda n: np.concatenate(
        [v := xt.init_fpuniform(n // 2, 60, 30, seed=7), -v])),
    ("subnormals", lambda n: xt.init_fpuniform(n, 40, -1030, seed=8) *
        np.where(np.random.RandomState(9).rand(n) < 0.5, -1.0, 1.0)),
]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float64))


@pytest.mark.parametrize("name,gen", CASES, ids=[c[0] for c in CASES])
def test_exsum_matches_jax_and_oracle(name, gen):
    x = gen(N)
    got = port_sum_bits(x)
    assert_same_bits(got, jax_sum_bits(x), f"{name} vs jax xla")
    assert_same_bits(got, np.float64(exact_sum(x)).view(np.uint64),
                     f"{name} vs oracle")


@pytest.mark.parametrize("name,gen", CASES, ids=[c[0] for c in CASES])
def test_exsum_acc_matches_jax(name, gen):
    import exblas_tpu as xb

    x = gen(N)
    assert_same_state(port_state(xt.exsum_acc(_t(x))),
                      jax_state(xb.exsum_acc(x, impl="xla")), name)


@pytest.mark.parametrize("n", [1, 17, 4096])
def test_exsum_sizes_vs_oracle(n):
    for name, gen in CASES[1:]:
        x = gen(n)
        assert_same_bits(port_sum_bits(x),
                         np.float64(exact_sum(x)).view(np.uint64),
                         f"{name} n={n}")


# --- the B2 Pallas kernels in interpret mode (n <= 3000, rows=8) -----------

INTERPRET_CASES = [
    ("wide+zeros+subnormals", lambda: np.concatenate([
        xt.init_fpuniform(1500, 300, -150, seed=12), np.zeros(97),
        xt.init_fpuniform(400, 40, -1070, seed=14),
        np.array([5e-324, -5e-324, 2.2e-308, -0.0])])),
    ("narrow+inf", lambda: np.concatenate([
        xt.init_fpuniform(1997, 3, 0, seed=15), np.array([np.inf, 1.0])])),
]


@pytest.mark.parametrize("name,gen", INTERPRET_CASES,
                         ids=[c[0] for c in INTERPRET_CASES])
def test_exsum_bits_matches_pallas_interpret(name, gen):
    x = gen()
    assert_same_bits(port_sum_bits(x), pallas_interpret("exsum_bits_pallas",
                                                        x), name)


@pytest.mark.parametrize("name,gen", INTERPRET_CASES,
                         ids=[c[0] for c in INTERPRET_CASES])
def test_exsum_acc_matches_pallas_interpret(name, gen):
    x = gen()
    assert_same_state(port_state(xt.exsum_acc(_t(x))),
                      jax_state(pallas_interpret("exsum_pallas", x)), name)


# --- IEEE edges (the cases of tests/test_exsum.py) -------------------------

def test_exsum_subnormals_and_edges():
    x = np.array([
        5e-324, -5e-324, 3e-320, 1e-310, -2.5e-310,
        np.finfo(np.float64).max, -np.finfo(np.float64).max,
        np.finfo(np.float64).tiny, 1.0, -1.0 + 2**-53,
        2.0**-1074, 2.0**1023, -(2.0**1023), 0.0, -0.0,
    ])
    assert_same_bits(port_sum_bits(x), np.float64(exact_sum(x)).view(
        np.uint64), "edges")
    assert_same_bits(port_sum_bits(x), jax_sum_bits(x), "edges vs jax")


def test_exsum_single_values_roundtrip():
    rng = np.random.RandomState(0)
    vals = list(rng.uniform(-1e300, 1e300, 20))
    vals += [5e-324, -5e-324, 1e-310, 2.0**-1074 * 3, 1.7976931348623157e308,
             -0.0]
    for v in vals:
        want = 0 if v == 0 else bits_of(v)  # -0.0 sums to +0.0
        assert port_sum_bits(np.array([v])) == want, v


def test_exsum_overflow_to_inf():
    x = np.array([1.7976931348623157e308] * 4)
    assert xt.exsum(_t(x)) == np.inf
    assert xt.exsum(_t(-x)) == -np.inf
    y = np.array([1.7976931348623157e308] * 4 + [-1.7976931348623157e308] * 3)
    assert bits_of(xt.exsum(_t(y))) == bits_of(1.7976931348623157e308)


@pytest.mark.parametrize("data", [
    [1.0, np.nan, 2.0], [1.0, np.inf], [-np.inf, 1.0], [np.inf, -np.inf],
    [np.inf, np.nan], [1e308, 1e308, -np.inf], [-np.nan, 3.0],
], ids=["nan", "pinf", "ninf", "both", "inf+nan", "ovf+ninf", "negnan"])
def test_exsum_specials(data):
    x = np.array(data)
    got = port_sum_bits(x)
    assert_same_bits(got, jax_sum_bits(x), "vs jax")
    want = exact_sum_with_specials(data)
    if np.isnan(want):
        assert got == 0x7FF8000000000000  # the canonical qNaN
    else:
        assert got == bits_of(want)


def test_exsum_empty_and_zero():
    assert port_sum_bits(np.array([])) == 0
    assert port_sum_bits(np.array([0.0, -0.0, 0.0])) == 0
    assert port_sum_bits(np.array([-0.0, -0.0])) == 0  # +0.0, not -0.0


# --- invariance, variants, strides, backends -------------------------------

def test_exsum_permutation_invariance():
    x = xt.init_ill_cond(4096, 1e24, seed=12)
    ref = port_sum_bits(x)
    gen = torch.Generator().manual_seed(13)
    tx = _t(x)
    for _ in range(3):
        perm = torch.randperm(tx.numel(), generator=gen)
        assert u64(xt.exsum_bits(tx[perm])) == ref


@pytest.mark.parametrize("nchunks", [2, 7, 64])
def test_exsum_partition_invariance(nchunks):
    x = _t(xt.init_fpuniform(4096, 40, 5, seed=14))
    ref = u64(xt.exsum_bits(x))
    bounds = np.linspace(0, x.numel(), nchunks + 1).astype(int)
    total = None
    for a, b in zip(bounds[:-1], bounds[1:]):
        part = xt.exsum_acc(x[a:b])
        total = part if total is None else total + part
    assert u64(round_superacc_to_f64_bits(total)) == ref


@pytest.mark.parametrize("fpe,ee", [(0, False), (1, False), (3, False),
                                    (4, True), (8, True), (8, False)])
def test_exsum_variant_agreement(fpe, ee):
    x = xt.init_fpuniform(2048, 50, 10, seed=11)
    ref = port_sum_bits(x, fpe=2)
    assert port_sum_bits(x, fpe=fpe, early_exit=ee) == ref


@pytest.mark.parametrize("fpe", [-1, 9])
def test_exsum_fpe_validated(fpe):
    with pytest.raises(ValueError):
        xt.exsum(_t([1.0]), fpe=fpe)


def test_exsum_inca_offset():
    x = xt.init_fpuniform(N * 2 + 1, 10, 0, seed=15)
    got = port_sum_bits(x, inca=2, offset=1)
    assert_same_bits(got, jax_sum_bits(x, inca=2, offset=1), "vs jax")
    assert_same_bits(got, np.float64(exact_sum(x[1::2])).view(np.uint64),
                     "vs oracle")


# Negative strides and offsets slice by numpy's rules, as the JAX package
# slices them (ROADMAP queue C, C1): n = 1000 with (inca, offset).
NEG_STRIDES = [(-1, 999), (-3, 500), (-1, -1), (-3, 999)]


@pytest.fixture(scope="module")
def c1_data():
    return np.random.default_rng(0).standard_normal(N)


@pytest.mark.parametrize("inca,offset", NEG_STRIDES)
def test_exsum_negative_stride_matches_jax(c1_data, inca, offset):
    import exblas_tpu as xb

    x = c1_data
    kw = dict(inca=inca, offset=offset)
    got = port_sum_bits(x, **kw)
    assert_same_bits(got, jax_sum_bits(x, **kw), f"{kw} vs jax")
    assert_same_bits(got, np.float64(exact_sum(x[offset::inca])).view(
        np.uint64), f"{kw} vs oracle")
    assert_same_state(port_state(xt.exsum_acc(_t(x), **kw)),
                      jax_state(xb.exsum_acc(x, impl="xla", **kw)), str(kw))
    host = xt.exsum(x, parallel=False, **kw)
    assert bits_of(host) == bits_of(xb.exsum(x, parallel=False, **kw))
    assert bits_of(host) == got


def test_exsum_negative_stride_known_value(c1_data):
    """The value the fault report gives for inca -1, offset 999."""
    assert xt.exsum(c1_data, inca=-1, offset=999, device="cpu") == \
        -48.02827676298693


def test_exsum_host_path_skips_fpe_check():
    """``parallel=False`` returns before any fpe check, as in the JAX
    package (ROADMAP queue C, C2)."""
    import exblas_tpu as xb

    y = np.random.default_rng(1).standard_normal(100)
    got = xt.exsum(y, fpe=9, parallel=False)
    assert bits_of(got) == bits_of(xb.exsum(y, fpe=9, parallel=False))
    assert got == -7.361212127294709
    with pytest.raises(ValueError):
        xt.exsum(_t(y), fpe=9)


def test_exsum_cpp_backend_agrees():
    x = xt.init_lognormal(5000, 0.0, 2.0, seed=16)
    assert bits_of(xt.exsum(_t(x), parallel=False)) == port_sum_bits(x)
    assert bits_of(xt.exsum(x, parallel=False, inca=3, offset=2)) == \
        port_sum_bits(x[2::3])


def test_exsum_numpy_input_and_impl_rules(monkeypatch):
    x = xt.init_fpuniform(100, 10, 0, seed=17)
    # numpy input goes to the CUDA device; without one it raises, and the
    # CPU runs only when asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xt.exsum(x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xt.exsum_acc(list(x))
    assert bits_of(xt.exsum(x, device="cpu")) == port_sum_bits(x)
    assert xt.exsum_bits(list(x), device="cpu").device.type == "cpu"
    assert bits_of(xt.exsum(_t(x), impl="torch")) == port_sum_bits(x)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        xt.exsum(_t(x), impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        xt.exsum(_t(x), impl="xla")


def test_sum_baseline_is_native():
    from exblas_tpu_torch.baselines import sum_baseline

    x = xt.init_fpuniform(100, 10, 0, seed=18)
    assert sum_baseline(_t(x)) == float(torch.sum(_t(x)))
    assert sum_baseline(x, device="cpu") == float(torch.sum(_t(x)))


def test_cuda_wrapper_refuses_cpu_tensor():
    from exblas_tpu_torch.ops.kernels import sum_kernel

    before = sum_kernel.exsum_bits_cuda.launches
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        sum_kernel.exsum_bits_cuda(_t([1.0, 2.0]))
    assert sum_kernel.exsum_bits_cuda.launches == before


# N-D input with inca/offset slices the first axis, as numpy and the JAX
# package slice it, then sums every element (ROADMAP queue C, C4).  Each
# (inca, offset) takes 4 of the 8 rows, so JAX compiles one shape a rank.
ND_SLICES = [(1, 4), (-1, 3), (2, 0), (2, 1), (-2, -1), (-2, 6)]


@pytest.mark.parametrize("shape", [(8, 5), (8, 3, 2)], ids=["2d", "3d"])
@pytest.mark.parametrize("inca,offset", ND_SLICES)
def test_exsum_nd_slices_first_axis_like_jax(shape, inca, offset):
    import exblas_tpu as xb

    x = xt.init_fpuniform(int(np.prod(shape)), 80, -40, seed=41).reshape(
        shape) * np.where(np.random.RandomState(42).rand(*shape) < 0.5,
                          -1.0, 1.0)
    kw = dict(inca=inca, offset=offset)
    got = port_sum_bits(x, **kw)
    assert_same_bits(got, jax_sum_bits(x, **kw), f"{shape} {kw} vs jax")
    assert_same_bits(got, np.float64(exact_sum(
        x[offset::inca].reshape(-1))).view(np.uint64), "vs oracle")
    assert_same_state(port_state(xt.exsum_acc(_t(x), **kw)),
                      jax_state(xb.exsum_acc(x, impl="xla", **kw)), str(kw))
    host = xt.exsum(x, parallel=False, **kw)
    assert bits_of(host) == bits_of(xb.exsum(x, parallel=False, **kw))
    assert bits_of(host) == got


def test_exsum_nd_known_values():
    """The values of the fault report (JAX's)."""
    x = np.random.default_rng(0).standard_normal((4, 5))
    assert xt.exsum(x, inca=2, device="cpu") == -4.1684031167772515
    assert xt.exsum(x, offset=1, device="cpu") == -3.8668451008118403
    assert xt.exsum(x, offset=1, parallel=False) == -3.8668451008118403
    assert xt.exsum(x, device="cpu") == xt.exsum(x.reshape(-1), device="cpu")
