"""ExDOT in the PyTorch port held bit for bit against the JAX package
(``impl="xla"`` and the B4 Pallas kernels in TPU interpret mode) and
against the exact oracle, plus underflowing products, the IEEE edges,
invariance under permutation and partition, the fpe/early_exit knobs
and inc/offset on both vectors.  Tolerance is zero.  The CUDA kernels are
held against the plain path on the card by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import exblas_tpu_torch as xt
from exblas_tpu_torch.core.rounding import round_superacc_to_f64_bits
from oracle import bits_of, exact_dot
from torch_parity import (assert_same_bits, assert_same_state, jax_dot_bits,
                          jax_state, pallas_interpret, port_dot_bits,
                          port_state, u64)

N = 1000  # one shape for every JAX comparison keeps its compiles few

CASES = [
    ("ill_cond_1e8", lambda n: (xt.init_ill_cond(n, 1e8, seed=21),
                                xt.init_ill_cond(n, 1e8, seed=22))),
    ("ill_cond_1e32", lambda n: (xt.init_ill_cond(n, 1e32, seed=21),
                                 xt.init_ill_cond(n, 1e32, seed=22))),
    ("fpuniform_lognormal", lambda n: (xt.init_fpuniform(n, 40, 10, seed=23),
                                       xt.init_lognormal(n, 0.0, 3.0,
                                                         seed=24))),
    ("narrow", lambda n: (xt.init_fpuniform(n, 2, 0, seed=25),
                          xt.init_fpuniform(n, 2, 0, seed=26))),
    ("very_wide", lambda n: (xt.init_fpuniform(n, 400, -200, seed=27),
                             xt.init_fpuniform(n, 400, -200, seed=28))),
    ("signed_wide", lambda n: (
        np.random.RandomState(25).uniform(-1, 1, n)
        * np.exp2(np.random.RandomState(26).randint(-700, 700, n)),
        np.random.RandomState(27).uniform(-1, 1, n)
        * np.exp2(np.random.RandomState(28).randint(-320, 300, n)))),
    ("subnormal_products", lambda n: (
        xt.init_fpuniform(n, 40, -1030, seed=29),
        xt.init_fpuniform(n, 60, -1000, seed=30)
        * np.where(np.random.RandomState(31).rand(n) < 0.5, -1.0, 1.0))),
]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float64))


@pytest.mark.parametrize("name,gen", CASES, ids=[c[0] for c in CASES])
def test_exdot_matches_jax_and_oracle(name, gen):
    a, b = gen(N)
    got = port_dot_bits(a, b)
    assert_same_bits(got, jax_dot_bits(a, b), f"{name} vs jax xla")
    assert_same_bits(got, np.float64(exact_dot(a, b)).view(np.uint64),
                     f"{name} vs oracle")


@pytest.mark.parametrize("name,gen", CASES, ids=[c[0] for c in CASES])
def test_exdot_acc_matches_jax(name, gen):
    import exblas_tpu as xb

    a, b = gen(N)
    assert_same_state(port_state(xt.exdot_acc(_t(a), _t(b))),
                      jax_state(xb.exdot_acc(a, b, impl="xla")), name)


@pytest.mark.parametrize("n", [1, 13, 3000])
def test_exdot_sizes_vs_oracle(n):
    for name, gen in CASES:
        a, b = gen(n)
        assert_same_bits(port_dot_bits(a, b),
                         np.float64(exact_dot(a, b)).view(np.uint64),
                         f"{name} n={n}")


# --- the B4 Pallas kernels in interpret mode (n <= 3000, rows=8) -----------

INTERPRET_CASES = [
    ("very_wide", lambda: CASES[4][1](2000)),
    ("mixed_specials", lambda: (
        np.concatenate([xt.init_fpuniform(1996, 30, -15, seed=23),
                        np.array([0.0, 5e-324, np.inf, 1.0])]),
        np.concatenate([xt.init_fpuniform(1996, 30, -15, seed=24),
                        np.array([3.0, 5e-324, 2.0, 0.0])]))),
]


@pytest.mark.parametrize("name,gen", INTERPRET_CASES,
                         ids=[c[0] for c in INTERPRET_CASES])
def test_exdot_bits_matches_pallas_interpret(name, gen):
    a, b = gen()
    assert_same_bits(port_dot_bits(a, b),
                     pallas_interpret("exdot_bits_pallas", a, b), name)


@pytest.mark.parametrize("name,gen", INTERPRET_CASES,
                         ids=[c[0] for c in INTERPRET_CASES])
def test_exdot_acc_matches_pallas_interpret(name, gen):
    a, b = gen()
    assert_same_state(port_state(xt.exdot_acc(_t(a), _t(b))),
                      jax_state(pallas_interpret("exdot_pallas", a, b)), name)


# --- IEEE edges (the cases of tests/test_exdot.py) -------------------------

def test_exdot_underflowing_products_exact():
    a = np.array([1e-200, 2e-170, -3e-160, 1.0])
    b = np.array([1e-200, 5e-170, 7e-160, 2.0**-1074])
    assert port_dot_bits(a, b) == bits_of(exact_dot(a, b))
    a2 = np.array([2.0**-1074] * 8)
    b2 = np.array([2.0**500] * 8)
    assert port_dot_bits(a2, b2) == bits_of(exact_dot(a2, b2))
    # products of two subnormals (2^-2148) are kept exactly and cancel
    a3 = np.array([2.0**-1074, 2.0**-1074])
    b3 = np.array([2.0**-1074, -(2.0**-1074)])
    assert port_dot_bits(a3, b3) == 0


@pytest.mark.parametrize("a,b", [
    ([np.nan], [1.0]), ([np.inf], [0.0]), ([0.0], [-np.inf]),
    ([np.inf], [2.0]), ([np.inf], [-2.0]), ([-np.inf], [-np.inf]),
    ([np.inf, 1.0], [1.0, -np.inf]), ([5e-324, np.inf], [0.0, 3.0]),
], ids=["nan", "inf*0", "0*-inf", "inf", "-inf", "-inf*-inf", "both",
        "inf+subnormal*0"])
def test_exdot_specials(a, b):
    got = port_dot_bits(a, b)
    assert_same_bits(got, jax_dot_bits(a, b), "vs jax")
    with np.errstate(invalid="ignore"):
        va = np.array(a) * np.array(b)
    if np.isnan(va).any() or (np.isposinf(va).any() and np.isneginf(va).any()):
        assert got == 0x7FF8000000000000
    else:
        assert got == bits_of(float(np.sum(va)))


def test_exdot_zero_is_positive():
    assert port_dot_bits([-0.0, 1.0], [1.0, -0.0]) == 0
    assert port_dot_bits([2.0, -2.0], [3.0, 3.0]) == 0


# --- invariance, variants, strides -----------------------------------------

def test_exdot_permutation_invariance():
    a, b = (_t(v) for v in CASES[1][1](1024))
    ref = u64(xt.exdot_bits(a, b))
    gen = torch.Generator().manual_seed(28)
    for _ in range(3):
        p = torch.randperm(a.numel(), generator=gen)
        assert u64(xt.exdot_bits(a[p], b[p])) == ref


@pytest.mark.parametrize("nchunks", [3, 7])
def test_exdot_partition_invariance(nchunks):
    a, b = (_t(v) for v in CASES[5][1](2048))
    ref = u64(xt.exdot_bits(a, b))
    bounds = np.linspace(0, a.numel(), nchunks + 1).astype(int)
    total = None
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        part = xt.exdot_acc(a[lo:hi], b[lo:hi])
        total = part if total is None else total + part
    assert u64(round_superacc_to_f64_bits(total)) == ref


@pytest.mark.parametrize("fpe,ee", [(0, False), (2, False), (4, True),
                                    (6, True), (8, False)])
def test_exdot_variant_agreement(fpe, ee):
    a = xt.init_fpuniform(777, 30, 0, seed=29)
    b = xt.init_fpuniform(777, 30, 0, seed=30)
    ref = port_dot_bits(a, b, fpe=3)
    assert port_dot_bits(a, b, fpe=fpe, early_exit=ee) == ref


def test_exdot_inc_offset_both_vectors():
    a = xt.init_fpuniform(2 * N + 1, 20, 0, seed=31)
    b = xt.init_lognormal(3 * N + 2, 0.0, 2.0, seed=32)
    kw = dict(inca=2, offseta=1, incb=3, offsetb=2)
    got = port_dot_bits(a, b, **kw)
    assert_same_bits(got, jax_dot_bits(a, b, **kw), "vs jax")
    assert got == bits_of(exact_dot(a[1::2], b[2::3]))


@pytest.mark.parametrize("inc,offset", [(-1, 999), (-3, 500), (-1, -1)])
def test_exdot_negative_stride_matches_jax(inc, offset):
    """Negative strides and offsets slice by numpy's rules, as the JAX
    package slices them (ROADMAP queue C, C1)."""
    import exblas_tpu as xb

    a = np.random.default_rng(0).standard_normal(N)
    b = xt.init_lognormal(N, 0.0, 2.0, seed=33)
    kw = dict(inca=inc, offseta=offset, incb=inc, offsetb=offset)
    got = port_dot_bits(a, b, **kw)
    assert_same_bits(got, jax_dot_bits(a, b, **kw), f"{kw} vs jax")
    assert got == bits_of(exact_dot(a[offset::inc], b[offset::inc]))
    assert_same_state(port_state(xt.exdot_acc(_t(a), _t(b), **kw)),
                      jax_state(xb.exdot_acc(a, b, impl="xla", **kw)),
                      str(kw))
    if (inc, offset) == (-1, 999):
        assert xt.exdot(a, a, inca=-1, offseta=999, incb=-1, offsetb=999,
                        device="cpu") == 956.3530648422026


def test_exdot_shape_and_device_checks():
    with pytest.raises(ValueError, match="shape mismatch"):
        xt.exdot(_t([1.0, 2.0]), _t([1.0]))
    with pytest.raises(ValueError, match="fpe"):
        xt.exdot(_t([1.0]), _t([1.0]), fpe=9)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        xt.exdot(_t([1.0]), _t([1.0]), impl="cuda")


def test_exdot_numpy_input_device_rule(monkeypatch):
    a, b = CASES[3][1](100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xt.exdot(a, b)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xt.exdot_acc(list(a), list(b))
    assert bits_of(xt.exdot(a, b, device="cpu")) == port_dot_bits(a, b)
    # numpy beside a CPU tensor follows the tensor
    assert bits_of(xt.exdot(_t(a), b)) == port_dot_bits(a, b)


def test_dot_baseline_is_native():
    from exblas_tpu_torch.baselines import dot_baseline

    a, b = CASES[3][1](100)
    assert dot_baseline(_t(a), _t(b)) == float(torch.dot(_t(a), _t(b)))
    assert dot_baseline(a, b, device="cpu") == float(torch.dot(_t(a), _t(b)))


# N-D operands with inc/offset slice their first axis, as numpy and the
# JAX package slice them, and their sliced shapes must agree (ROADMAP
# queue C, C4).  Each (inc, offset) takes 4 of the 8 rows, so JAX compiles
# one shape a rank.
@pytest.mark.parametrize("shape", [(8, 5), (8, 3, 2)], ids=["2d", "3d"])
@pytest.mark.parametrize("inc,offset", [(1, 4), (-1, 3), (2, 0), (2, 1),
                                        (-2, -1), (-2, 6)])
def test_exdot_nd_slices_first_axis_like_jax(shape, inc, offset):
    import exblas_tpu as xb

    n = int(np.prod(shape))
    a = xt.init_fpuniform(n, 80, -40, seed=43).reshape(shape)
    b = -xt.init_lognormal(n, 0.0, 3.0, seed=44).reshape(shape)
    kw = dict(inca=inc, offseta=offset, incb=inc, offsetb=offset)
    got = port_dot_bits(a, b, **kw)
    assert_same_bits(got, jax_dot_bits(a, b, **kw), f"{shape} {kw} vs jax")
    assert got == bits_of(exact_dot(a[offset::inc].reshape(-1),
                                    b[offset::inc].reshape(-1)))
    assert_same_state(port_state(xt.exdot_acc(_t(a), _t(b), **kw)),
                      jax_state(xb.exdot_acc(a, b, impl="xla", **kw)),
                      str(kw))


def test_exdot_nd_shape_mismatch_raises_like_jax():
    import exblas_tpu as xb

    x = np.random.default_rng(0).standard_normal((4, 5))
    assert xt.exdot(x, x, inca=2, incb=2, device="cpu") == 8.137457542453038
    for args, kw in [((x, x.T.copy()), {}),
                     ((x, x), dict(inca=2)),
                     ((x[:, :4], x.reshape(5, 4)), {})]:
        with pytest.raises(ValueError, match="shape mismatch"):
            xb.exdot(*args, impl="xla", **kw)
        with pytest.raises(ValueError, match="shape mismatch"):
            xt.exdot(*args, device="cpu", **kw)
    # equal element counts but other shapes: rejected on the host path too
    with pytest.raises(ValueError, match="shape mismatch"):
        xt.exdot_acc(_t(x), _t(x.reshape(2, 10)))
