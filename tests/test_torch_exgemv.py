"""ExGEMV in the PyTorch port held bit for bit against the JAX package:
the public entry (plain path) against ``exgemv_bits(..., impl="xla")`` on
both transposes, every beta mode, BLAS buffers, wide, cancelling, special
and deep-subnormal data; each kernel's plain version against the JAX
kernel it stands for (B7 ``gemv_rows_acc_pallas`` and B8
``_analyze_rows_stats`` in interpret mode, B9 ``gemv_bits_mxu`` in
interpret mode at rungs (2, 2) and (3, 3) and against the exact XLA path
at the wider rungs); the rung choice against a recomputation from JAX's
own analysis; the error cases, the ``fpe == 1`` control, the device rules
and the Fraction oracle.  Tolerance is zero.  JAX's Pallas GEMV kernels
compile slowly in interpret mode, so they run at two narrow rungs and one
small shape each, the XLA references reuse a few compiled shapes, and
JAX's row and z analyses are compiled once for the module (``jax_gemv``).
The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import exblas_tpu as xb
import exblas_tpu_torch as xt
from exblas_tpu.core.ieee import split_f64
from exblas_tpu_torch.core.rounding import canonicalize_digits
from exblas_tpu_torch.ops.kernels import gemv_kernel as tkern
from exblas_tpu_torch.ops.kernels import gemv_mxu as tmxu
from test_exgemv import oracle_gemv

E = importlib.import_module("exblas_tpu_torch.ops.exgemv")
JE = importlib.import_module("exblas_tpu.ops.exgemv")

QNAN_PAYLOAD = np.array([0xFFF0000000000123], np.uint64).view(np.float64)[0]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float64))


def _bits(x):
    return _t(x).view(torch.int64)


def u64(x):
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64).view(np.uint64)


def jax_bits(trans, alpha, a, x, beta=0.0, y=None, **kw):
    return u64(np.asarray(JE.exgemv_bits(trans, alpha, a, x, beta=beta, y=y,
                                         impl="xla", **kw)).view(np.int64))


def port_bits(trans, alpha, a, x, beta=0.0, y=None, **kw):
    return u64(xt.exgemv_bits(trans, alpha, a, x, beta=beta, y=y,
                              device="cpu", **kw))


def assert_bits(got, want, msg=""):
    same = got == want
    assert same.all(), (f"{msg}: {np.count_nonzero(~same)} differ, e.g. "
                        f"{got[~same][:3]} vs {want[~same][:3]}")


def mode_of(beta):
    return "zero" if beta == 0.0 else ("one" if beta == 1.0 else "general")


def vec(n, lo, hi, seed):
    """Doubles with uniform significands, exponents in [lo, hi), signs."""
    rs = np.random.RandomState(seed)
    return ((1.0 + rs.rand(n)) * np.exp2(rs.randint(lo, hi, size=n))
            * np.where(rs.rand(n) < 0.5, -1.0, 1.0))


# The JAX references compile once per (shape, beta mode); every test below
# reuses these four.
SHAPES = {(7, 13): (2.5, 0.0), (64, 32): (1.0, 1.0), (33, 96): (-0.75, 3.25),
          (129, 257): (2.5, 0.0)}


def operands(m, n, seed, lo=0, hi=30):
    a = xb.init_fpuniform_matrix(m, n, hi - lo, 0, seed=seed) * np.exp2(lo)
    return a, xb.init_fpuniform(n, 25, 3, seed=seed + 1), vec(m, -5, 5,
                                                               seed + 2)


@pytest.fixture(scope="module")
def jax_gemv():
    """The JAX package's GEMV analyses, each compiled once for the module's
    shapes (called eagerly, they run op by op at every call): the XLA
    ``analyze_gemv_rows`` and ``analyze_z``, and the Pallas pass
    ``_analyze_rows_stats`` (traced in interpret mode at its first call)."""
    import jax
    from exblas_tpu.ops.kernels import gemv_mxu as jmxu

    return SimpleNamespace(rows=jax.jit(jmxu.analyze_gemv_rows),
                           z=jax.jit(jmxu.analyze_z),
                           stats=jax.jit(jmxu._analyze_rows_stats))


# --- the public entry against JAX --------------------------------------------

@pytest.mark.parametrize("m,n", list(SHAPES))
def test_exgemv_matches_jax(m, n):
    alpha, beta = SHAPES[(m, n)]
    a, x, y = operands(m, n, 51)
    want = jax_bits("N", alpha, a, x, beta, y)
    assert_bits(port_bits("N", alpha, a, x, beta, y), want, "N")
    # op(A) of a transposed buffer is the same matrix: the same bits
    assert_bits(port_bits("T", alpha, a.T.copy(), x, beta, y), want, "T")
    assert_bits(jax_bits("T", alpha, a.T.copy(), x, beta, y), want, "jax T")


def test_exgemv_lda_incx_incy():
    m, n = 33, 96
    alpha, beta = SHAPES[(m, n)]
    a, x, y = operands(m, n, 40)
    lda = m + 4
    rs = np.random.RandomState(41)
    buf = rs.uniform(-1, 1, lda * n)
    for j in range(n):
        buf[j * lda: j * lda + m] = a[:, j]
    x_buf = rs.uniform(-1, 1, 2 * n)
    x_buf[::2] = x
    y_buf = rs.uniform(-1, 1, 3 * m)
    y_buf[::3] = y
    want = jax_bits("N", alpha, a, x, beta, y)
    kw = dict(m=m, n=n, lda=lda, incx=2, incy=3)
    assert_bits(jax_bits("N", alpha, buf, x_buf, beta, y_buf, **kw), want,
                "jax buffers")
    assert_bits(port_bits("N", alpha, buf, x_buf, beta, y_buf, **kw), want,
                "buffers")
    got = xt.exgemv_bits("N", alpha, _t(buf), _t(x_buf), beta, _t(y_buf),
                         **kw)
    assert_bits(u64(got), want, "tensor buffers")


def test_exgemv_wide_range_and_cancellation():
    m, n = 64, 32
    alpha, beta = SHAPES[(m, n)]
    rs = np.random.RandomState(56)
    a = rs.uniform(-1, 1, (m, n)) * np.exp2(rs.randint(-500, 500, (m, n)))
    x = rs.uniform(-1, 1, n) * np.exp2(rs.randint(-300, 300, n))
    y = vec(m, -600, 600, 57)
    got = port_bits("N", alpha, a, x, beta, y)
    assert_bits(got, jax_bits("N", alpha, a, x, beta, y), "wide")
    plan = E.plan_gemv(_bits(a), _bits(x), _bits(y), E._scalar_bits(beta),
                       "one", False)
    assert plan.rung is None  # too wide for any rung: the exact kernel
    # [v, -v] . [w, w] == 0 exactly, plus y; +0.0 where y is 0
    v = xb.init_fpuniform_matrix(m, n // 2, 60, 0, seed=58) - 2.0 ** 30
    w = xb.init_fpuniform(n // 2, 40, 0, seed=59)
    a2 = np.concatenate([v, -v], axis=1)
    x2 = np.concatenate([w, w])
    y2 = np.where(np.arange(m) % 2 == 0, 0.0, y)
    got = port_bits("N", alpha, a2, x2, beta, y2)
    assert_bits(got, jax_bits("N", alpha, a2, x2, beta, y2), "cancel")
    assert_bits(got, u64(_bits(y2)), "cancel is y")


def test_exgemv_specials_match_jax():
    m, n = 7, 13
    alpha, beta = SHAPES[(m, n)]
    a, x, _ = operands(m, n, 60)
    a[0, 1] = np.inf
    a[1, 2] = -np.inf
    a[2, 3] = QNAN_PAYLOAD
    a[3, 4] = np.inf
    a[3, 5] = -np.inf                       # +Inf and -Inf: NaN
    x[6] = 0.0
    a[4, 6] = np.inf                        # Inf * 0: NaN
    want = jax_bits("N", alpha, a, x)
    plan = E.plan_gemv(_bits(a), _bits(x), None, 0, "zero", False)
    assert plan.rung is not None and plan.override
    got = port_bits("N", alpha, a, x)
    assert_bits(got, want, "a specials")
    nan = np.isnan(np.asarray(want).view(np.float64))
    assert nan[2:5].all() and (want[nan] == 0x7FF8000000000000).all()
    # beta * y specials, with finite A and x
    m, n = 33, 96
    alpha, beta = SHAPES[(m, n)]
    a, x, y = operands(m, n, 61)
    y[0], y[1], y[2] = np.inf, -np.inf, QNAN_PAYLOAD
    x[7] = np.inf                           # every row: +-Inf
    want = jax_bits("N", alpha, a, x, beta, y)
    assert_bits(port_bits("N", alpha, a, x, beta, y), want, "y specials")


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_exgemv_deep_subnormal_beta(sign):
    # products of 2^-2148 and 0.5 * 2^-1074: the relative window lies
    # below absolute bit 0 but for one straddling digit (the JAX fold)
    m, n = 33, 96
    a = np.full((m, n), sign * 5e-324)
    x = np.full(n, 5e-324)
    y = np.full(m, 5e-324)
    plan = E.plan_gemv(_bits(a), _bits(x), _bits(y), E._scalar_bits(0.5),
                       "general", False)
    assert plan.rung == (2, 2)
    want = jax_bits("N", 1.0, a, x, 0.5, y)
    assert_bits(port_bits("N", 1.0, a, x, 0.5, y), want, "deep subnormal")
    assert_bits(port_bits("N", 1.0, a, x, 3.25, y),
                jax_bits("N", 1.0, a, x, 3.25, y), "beta 3.25")


def test_exgemv_column_permutation_invariance():
    m, n = 129, 257
    a, x, _ = operands(m, n, 62, lo=-20, hi=20)
    ref = port_bits("N", 2.5, a, x)
    assert_bits(ref, jax_bits("N", 2.5, a, x), "jax")
    for seed in (63, 64):
        p = np.random.RandomState(seed).permutation(n)
        assert_bits(port_bits("N", 2.5, a[:, p], x[p]), ref, "perm")


def test_exgemv_matches_oracle():
    m, n = 7, 13
    a, x, y = operands(m, n, 65, lo=-40, hi=40)
    want = u64(oracle_gemv("N", -1.5, a, x, 0.375, y).view(np.int64))
    assert_bits(port_bits("N", -1.5, a, x, 0.375, y), want, "oracle")
    # op(A) = A^T (13 x 7): y is the vector, x the beta term
    want = u64(oracle_gemv("T", 1.0, a, y, 1.0, x).view(np.int64))
    assert_bits(port_bits("T", 1.0, a, y, 1.0, x), want, "oracle T")


# --- errors, the control and the devices -------------------------------------

ERRORS = {
    "trans": dict(trans="Q"),
    "x shape": dict(x=lambda x: x[:3]),
    "beta needs y": dict(beta=2.0),
    "fpe": dict(fpe=9),
    "incx zero": dict(incx=0),
    "incx negative": dict(incx=-1),
    "x buffer short": dict(incx=2),
    "y buffer short": dict(beta=2.0, y=lambda x: np.ones(5), incy=2),
    "incy zero": dict(beta=2.0, y=lambda x: np.ones(4), incy=0),
    "lda without m": dict(lda=4),
    "lda too small": dict(m=4, n=4, lda=3),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_exgemv_errors_match_jax(case):
    a = xb.init_fpuniform_matrix(4, 4, 5, 0, seed=62)
    x = xb.init_fpuniform(4, 5, 0, seed=63)
    kw = dict(ERRORS[case])
    trans = kw.pop("trans", "N")
    if "x" in kw:
        x = kw.pop("x")(x)
    if "y" in kw:
        kw["y"] = kw["y"](x)
    with pytest.raises(ValueError):
        JE.exgemv(trans, 1.0, a, x, impl="xla", **kw)
    with pytest.raises(ValueError):
        xt.exgemv(trans, 1.0, a, x, device="cpu", **kw)


def test_exgemv_fpe1_control():
    a = xb.init_fpuniform_matrix(8, 6, 5, 0, seed=60)
    x = xb.init_fpuniform(6, 5, 0, seed=61)
    y = xb.init_fpuniform(8, 5, 0, seed=62)
    base = xt.exgemv("N", 1.0, _t(a), _t(x), fpe=1)
    assert np.allclose(base.numpy(), a @ x, rtol=1e-6)
    base = xt.exgemv("T", 2.0, _t(a), _t(y), beta=0.5, y=_t(x), fpe=1)
    assert np.allclose(base.numpy(), 2.0 * (a.T @ y) + 0.5 * x, rtol=1e-6)
    buf = np.concatenate([a, np.zeros((2, 6))]).T.reshape(-1)  # lda = 10
    base = xt.exgemv("N", 1.0, buf, np.repeat(x, 2), fpe=1, m=8, n=6,
                     lda=10, incx=2, device="cpu")
    assert np.allclose(base.numpy(), a @ x, rtol=1e-6)


def test_exgemv_fpe1_control_strided_y():
    """The fpe == 1 control applies incy, as the exact path does; the JAX
    package's control passes y unstrided and fails on such a call
    (ROADMAP queue C), so the port is held against JAX's control on the
    dense y the stride selects.  The control is plain float64, rounded in
    each package's own order: the two agree to 1e-12, not bit for bit."""
    a = xb.init_fpuniform_matrix(4, 3, 5, 0, seed=66)
    x = xb.init_fpuniform(3, 5, 0, seed=67)
    y = xb.init_fpuniform(8, 5, 0, seed=68)
    got = xt.exgemv("N", 1.0, a, x, beta=0.5, y=y, incy=2, fpe=1,
                    device="cpu")
    want = JE.exgemv("N", 1.0, a, x, beta=0.5, y=y[::2], fpe=1)
    assert np.allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    exact = xt.exgemv("N", 1.0, a, x, beta=0.5, y=y, incy=2, device="cpu")
    assert np.allclose(got.numpy(), exact.numpy(), rtol=1e-12)


def test_exgemv_device_rules(monkeypatch):
    a = xb.init_fpuniform_matrix(4, 5, 5, 0, seed=64)
    x = xb.init_fpuniform(5, 5, 0, seed=65)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xt.exgemv("N", 1.0, a, x)
    got = xt.exgemv("N", 1.0, _t(a), _t(x))
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert_bits(u64(got.view(torch.int64)), port_bits("N", 1.0, a, x),
                "cpu tensors")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        xt.exgemv("N", 1.0, _t(a), _t(x), impl="cuda")


def test_gemv_cuda_wrappers_refuse_cpu_tensors():
    a, z = _bits(np.ones((2, 3))), _bits(np.ones(3))
    wrappers = (tkern.gemv_rows_acc_cuda, tmxu.analyze_gemv_rows_cuda,
                tmxu.gemv_bits_mxu_cuda)
    before = [w.launches for w in wrappers]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tkern.gemv_rows_acc_cuda(a, z)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tmxu.analyze_gemv_rows_cuda(a)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tmxu.gemv_bits_mxu_cuda(a, z, torch.zeros(2, dtype=torch.int32),
                                torch.tensor(0), None, 0, "zero", 2, 2)
    assert before == [w.launches for w in wrappers]


# --- B7: the exact row accumulators ------------------------------------------

def _b7_data(kind):
    rs = np.random.RandomState(70)
    m, k = 130, 300
    if kind == "wide":
        return (rs.uniform(-1, 1, (m, k)) * np.exp2(rs.randint(-600, 600,
                                                               (m, k))),
                rs.uniform(-1, 1, k) * np.exp2(rs.randint(-400, 400, k)))
    a, x = rs.uniform(-1, 1, (m, k)), rs.uniform(-1, 1, k)
    a[0, 0], a[1, 1], a[2, 2], a[2, 3] = np.inf, QNAN_PAYLOAD, np.inf, -np.inf
    a[3, :] = 5e-324
    x[9] = 0.0
    a[4, 9] = -np.inf                       # -Inf * 0: NaN
    return a, x


@pytest.mark.parametrize("kind", ["wide", "specials"])
def test_gemv_rows_acc_matches_pallas(kind):
    from jax.experimental.pallas import tpu as pltpu
    from exblas_tpu.ops.kernels.gemv_kernel import gemv_rows_acc_pallas

    a, x = _b7_data(kind)
    A, X = split_f64(a), split_f64(x)
    with pltpu.force_tpu_interpret_mode():
        limbs, special = gemv_rows_acc_pallas(A.hi, A.lo, X.hi, X.lo,
                                              k_rows=128)
    wd, wn = canonicalize_digits(torch.from_numpy(np.array(limbs)))
    gl, gs = tkern.gemv_rows_acc_torch(_bits(a), _bits(x))
    gd, gn = canonicalize_digits(gl)
    assert gl.shape == (130, 216) and gs.shape == (130, 3)
    assert torch.equal(gn, wn) and torch.equal(gd, wd)
    assert np.array_equal(gs.numpy(), np.asarray(special))


# --- B8: the row analysis ----------------------------------------------------

M8, K8 = 12, 300  # a ragged k tail for the Pallas pass (300 = 256 + 44)


def _b8_data(kind):
    rs = np.random.RandomState(80)
    a = rs.uniform(0.5, 1.0, (M8, K8)) * np.exp2(rs.randint(-40, 40,
                                                           (M8, K8)))
    if kind == "edges":
        a[0, :5] = [5e-324, -1e-320, 0.0, -0.0, 2.2e-308]  # hi-invisible
        a[1, :] = 0.0                                      # all-zero row
        a[2, :] = -0.0
        a[3, :] = np.inf                                   # all special
        a[3, 7] = QNAN_PAYLOAD
        a[4, :] = 5e-324                                   # hi-invisible
        a[5, 299] = -np.inf                                # in the tail
        a[6, 298] = 1e-310                                 # tiny, in tail
    elif kind == "tiny_only":
        a = np.where(rs.rand(M8, K8) < 0.5, 0.0, 1e-320)
    return a


@pytest.mark.parametrize("kind", ["plain", "edges", "tiny_only"])
def test_analyze_gemv_rows_matches_jax(kind, jax_gemv):
    from jax.experimental.pallas import tpu as pltpu

    a = _b8_data(kind)
    A = split_f64(a)
    ea, spread, special = tmxu.analyze_gemv_rows_torch(_bits(a))
    assert ea.dtype == torch.int32 and spread.dtype == torch.int32
    w_ea, w_spread, w_special = jax_gemv.rows(A.hi, A.lo)  # XLA branch
    assert np.array_equal(ea.numpy(), np.asarray(w_ea))
    assert int(spread) == int(w_spread) and bool(special) == bool(w_special)
    # the Pallas pass: anchors, and the spread as analyze_gemv_rows forms
    # it from the stats (gemv_mxu.py:196-206)
    with pltpu.force_tpu_interpret_mode():
        e_max, lsb_min, row_special, row_hi_inv = map(
            np.asarray, jax_gemv.stats(A.hi))
    assert np.array_equal(ea.numpy(), e_max)
    spread_def = np.max(np.where(lsb_min >= 10000, 0, e_max - lsb_min + 1))
    cand = ((np.asarray(A.hi) & 0x7FFFFFFF) == 0) & (np.asarray(A.lo) != 0)
    spread_tiny = np.max(np.where(cand, e_max[:, None] + 1075, 0)) \
        if row_hi_inv.any() else 0
    assert int(spread) == max(spread_def, spread_tiny)
    assert bool(special) == bool(row_special.any())


# --- the rung choice ---------------------------------------------------------

RUNG_CASES = {
    "narrow": (0, 10, 0, 10, (2, 2)),
    "z spread": (0, 10, -20, 20, (3, 3)),
    "a spread": (-45, 45, -35, 35, (5, 4)),
    "both": (-98, 99, -60, 60, (8, 6)),
    "widest": (-220, 220, -30, 30, (16, 7)),
    "a past 512": (-240, 240, 0, 10, None),
    "z past 224": (0, 10, -100, 100, None),
}


@pytest.mark.parametrize("case", list(RUNG_CASES))
def test_plan_gemv_rung_matches_jax(case, jax_gemv):
    la, ha, lx, hx, expected = RUNG_CASES[case]
    rs = np.random.RandomState(90)
    a = (1.0 + rs.rand(M8, K8)) * np.exp2(rs.randint(la, ha, (M8, K8)))
    x = vec(K8, lx, hx, 91)
    A, X = split_f64(a), split_f64(x)
    _, sp_a, _ = jax_gemv.rows(A.hi, A.lo)
    _, sp_z, _ = jax_gemv.z(X.hi, X.lo)
    want = next(((nwa, nwz) for nwa, nwz in JE._GEMV_RUNGS
                 if int(sp_a) <= 32 * nwa and int(sp_z) <= 32 * nwz), None)
    assert want == expected
    plan = E.plan_gemv(_bits(a), _bits(x), None, 0, "zero", False)
    assert plan.rung == want
    assert E._GEMV_RUNGS == JE._GEMV_RUNGS


def test_plan_gemv_k_cap_routes_exact(monkeypatch):
    a, x = np.ones((3, 5)), np.ones(5)
    assert E.plan_gemv(_bits(a), _bits(x), None, 0, "zero",
                       False).rung == (2, 2)
    monkeypatch.setattr(tmxu, "MAX_K_MXU", 255)
    assert E.plan_gemv(_bits(a), _bits(x), None, 0, "zero",
                       False).rung is None
    assert_bits(port_bits("N", 1.0, a, x), u64(_bits(np.full(3, 5.0))), "k")


# --- B9: the byte-plane path -------------------------------------------------

def test_gemv_host_parts_match_jax(jax_gemv):
    from exblas_tpu.ops.kernels import gemv_mxu as jmxu

    assert tmxu.MAX_K_MXU == jmxu.MAX_K_MXU
    for nwa, nwz in E._GEMV_RUNGS:
        for k_pad in (256, 32768, 1 << 20, jmxu.MAX_K_MXU):
            assert (tmxu._rung_params(nwa, nwz, k_pad)
                    == jmxu._rung_params(nwa, nwz, k_pad))
        _, _, ns, nz, r0, _ = tmxu._rung_params(nwa, nwz)
        assert tmxu.rel_limbs_count(r0) <= tmxu.MAX_REL_LIMBS
    for nwz, r in ((2, 5), (6, 60), (7, 80), (7, 600)):
        x = vec(K8, -r, r, 92)
        x[3], x[4] = 0.0, np.inf
        if r == 600:  # a subnormal: beyond every rung
            x[5] = 5e-324
        X = split_f64(x)
        f, spread, special = tmxu.analyze_z(_bits(x))
        w = jax_gemv.z(X.hi, X.lo)
        assert (int(f), int(spread), bool(special)) == (
            int(w[0]), int(w[1]), bool(w[2]))
        if int(spread) > 32 * nwz:
            continue  # uncovered: the dispatcher never makes its digits
        zd, _ = jmxu.make_z_digits(X.hi, X.lo, w[0], nwz)
        got = tmxu.make_z_digits(_bits(x), f, nwz)
        assert np.array_equal(got.numpy(), np.asarray(zd)[:4 * nwz + 1][::-1])


def _b9_interpret(jax_gemv, a, x, beta, y, nwa, nwz):
    from jax.experimental.pallas import tpu as pltpu
    from exblas_tpu.ops.kernels.gemv_mxu import gemv_bits_mxu

    A, X, Y = split_f64(a), split_f64(x), split_f64(y)
    bh, bl = JE._scalar_bits(beta)
    ea, _, _ = jax_gemv.rows(A.hi, A.lo)
    f, _, _ = jax_gemv.z(X.hi, X.lo)
    with pltpu.force_tpu_interpret_mode():
        hi, lo = gemv_bits_mxu(A.hi, A.lo, X.hi, X.lo, ea, f, Y.hi, Y.lo,
                               bh, bl, mode_of(beta), nwa=nwa, nwz=nwz)
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        lo).astype(np.uint64)


def _port_b9(a, x, beta, y, rung):
    plan = E.plan_gemv(_bits(a), _bits(x), _bits(y), E._scalar_bits(beta),
                       mode_of(beta), False)
    assert plan.rung == rung
    return u64(tmxu.gemv_bits_mxu_torch(
        _bits(a), _bits(x), plan.ea0, plan.f0, _bits(y),
        E._scalar_bits(beta), mode_of(beta), *rung))


M9, K9 = 40, 300


def test_gemv_bits_mxu_matches_pallas_rung22(monkeypatch, jax_gemv):
    rs = np.random.RandomState(100)
    sgn = np.where(rs.rand(M9, K9) < 0.5, -1.0, 1.0)
    a = rs.uniform(0.5, 1.0, (M9, K9)) * sgn
    a.ravel()[::13] = 0.0
    x = rs.uniform(0.5, 1.0, K9) * np.where(rs.rand(K9) < 0.5, -1.0, 1.0)
    y = np.zeros(M9)
    want = _b9_interpret(jax_gemv, a, x, 0.0, y, 2, 2)
    assert_bits(_port_b9(a, x, 0.0, y, (2, 2)), want, "(2, 2)")
    # all-negative A (the JAX kernel's sign-mask split case) and the int32
    # sums widened every 64 k: the same bits
    neg = -rs.uniform(0.5, 1.0, (M9, K9))
    want = _b9_interpret(jax_gemv, neg, x, 0.0, y, 2, 2)
    assert_bits(_port_b9(neg, x, 0.0, y, (2, 2)), want, "negative")
    monkeypatch.setattr(tmxu, "K_CHUNK", tmxu.KS)
    assert_bits(_port_b9(neg, x, 0.0, y, (2, 2)), want, "negative, K_CHUNK 64")


def test_gemv_bits_mxu_matches_pallas_rung33_beta(monkeypatch, jax_gemv):
    rs = np.random.RandomState(101)
    a = rs.uniform(0.5, 1.0, (M9, K9))
    a[:, ::3] *= 2.0 ** -25                  # ~78-bit rows: rung (3, 3)
    x = rs.uniform(-1.0, 1.0, K9)
    x[0] = 1.0
    y = rs.uniform(-4.0, 4.0, M9)
    y[1] = 2.0 ** -1070
    want = _b9_interpret(jax_gemv, a, x, 2.5, y, 3, 3)
    assert_bits(_port_b9(a, x, 2.5, y, (3, 3)), want, "(3, 3) beta")
    monkeypatch.setattr(tmxu, "K_CHUNK", tmxu.KS)
    assert_bits(_port_b9(a, x, 2.5, y, (3, 3)), want,
                "(3, 3) beta, K_CHUNK 64")


# The wide rungs of test_gemv_mxu.py:250-312 (the exponent ranges of its
# data), at the shapes the public tests compiled.
WIDE_RUNGS = [
    ((4, 4), 50, 50, -25), ((5, 4), 97, 40, -20), ((6, 5), 130, 100, -50),
    ((8, 6), 197, 60, -30), ((12, 7), 275, 60, -30), ((16, 7), 440, 60, -30),
]


@pytest.mark.parametrize("rung,ra,rx,ex", WIDE_RUNGS,
                         ids=[f"{r[0][0]}x{r[0][1]}" for r in WIDE_RUNGS])
def test_gemv_bits_mxu_wide_rungs_match_jax(rung, ra, rx, ex):
    for (m, n), (alpha, beta) in ((((129, 257), SHAPES[(129, 257)])),
                                  (((33, 96), SHAPES[(33, 96)]))):
        a = xb.init_fpuniform_matrix(m, n, ra, 0, seed=ra)
        x = xb.init_fpuniform(n, rx, ex, seed=rx)
        y = xb.init_fpuniform(m, 10, -5, seed=3)
        z = np.float64(alpha) * x
        want = jax_bits("N", alpha, a, x, beta, y)
        assert_bits(_port_b9(a, z, beta, y, rung), want, f"{rung} {m}x{n}")
        assert_bits(port_bits("N", alpha, a, x, beta, y), want, "public")
