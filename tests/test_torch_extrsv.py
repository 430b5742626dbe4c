"""ExTRSV in the PyTorch port held bit for bit against the JAX package: the
public entry (plain path) against ``extrsv(..., impl="xla")`` for all eight
(uplo, trans, diag) combinations on fpuniform (ranges 8 and 600) and
lognormal systems, the Fraction replay of the spec, the plain kernel
version ``trsv_lower_x_torch`` at several block heights, specials and the
masking traps (a zero diagonal, NaN/Inf in b, NaN in the ignored triangle
and on a unit diagonal, subnormal x), BLAS buffers, the error cases, the
``fpe == 1`` control and the device rules.  Tolerance is zero.

JAX compiles its spec solve once per (n, unit diagonal), a few seconds each
on a CPU, so the tests reuse the few pairs in ``JAX_N``; the JAX package's
own ``test_extrsv_pallas_kernel_interpret`` holds its Pallas kernel to that
spec solve, so no interpret-mode kernel runs here.  Kernel B10 is held
against ``trsv_lower_x_torch`` on the card by ``chip_smoke.py``."""

import importlib

import numpy as np
import pytest
import torch

import exblas_tpu as xb
import exblas_tpu_torch as xt
from exblas_tpu_torch.core.rounding import canonicalize_digits
from exblas_tpu_torch.ops.kernels import gemv_kernel as tgemv
from exblas_tpu_torch.ops.kernels import trsv_kernel as tk
from test_extrsv import oracle_trsv_lower

E = importlib.import_module("exblas_tpu_torch.ops.extrsv")
JE = importlib.import_module("exblas_tpu.ops.extrsv")

COMBOS = [(u, t, d) for u in "LU" for t in "NT" for d in "NU"]
DISTS = ("fpuniform8", "fpuniform600", "lognormal")
# n the JAX references compile, per diagonal kind; every test below
# reuses these five pairs.
JAX_N = {"N": (4, 130), "U": (1, 33, 96)}
NAN_PAYLOAD = np.array([0xFFF0000000000123], np.uint64).view(np.float64)[0]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float64))


def u64(x):
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.float64).view(np.uint64)


def assert_bits(got, want, msg=""):
    same = got == want
    assert same.all(), (f"{msg}: {np.count_nonzero(~same)} of {same.size} "
                        f"differ, first at {int(np.argmax(~same))}")


def jax_bits(uplo, trans, diag, a, b, **kw):
    return u64(xb.extrsv(uplo, trans, diag, a, b, impl="xla", **kw))


def port_bits(uplo, trans, diag, a, b, **kw):
    return u64(xt.extrsv(uplo, trans, diag, a, b, device="cpu", **kw))


def system(uplo, diag, n, dist, seed):
    """(a, b): the ``uplo`` triangle of T stored, the other one zero."""
    if dist == "fpuniform8":
        a = xb.init_fpuniform_tr_matrix(uplo, diag, n, 8, 0, seed=seed)
        b = xb.init_fpuniform(n, 8, 0, seed=seed + 1)
    elif dist == "fpuniform600":
        a = xb.init_fpuniform_tr_matrix(uplo, diag, n, 600, 300, seed=seed)
        b = xb.init_fpuniform(n, 600, 300, seed=seed + 1)
    else:
        a = xb.init_lognormal_tr_matrix(uplo, diag, n, 0.0, 2.0, seed=seed)
        b = xb.init_lognormal(n, 0.0, 2.0, seed=seed + 1)
    return a, b


# --- the public entry against JAX --------------------------------------------

@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("uplo,trans,diag", COMBOS)
def test_extrsv_matches_jax(uplo, trans, diag, dist):
    ci, di = COMBOS.index((uplo, trans, diag)), DISTS.index(dist)
    ns = JAX_N[diag]
    n = ns[(ci + di) % len(ns)]
    a, b = system(uplo, diag, n, dist, seed=100 + 10 * ci + di)
    assert_bits(port_bits(uplo, trans, diag, a, b),
                jax_bits(uplo, trans, diag, a, b),
                f"{uplo}{trans}{diag} n={n} {dist}")


@pytest.mark.parametrize("n", [1, 24, 64])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_extrsv_matches_spec_oracle(n, diag):
    a = xb.init_fpuniform_tr_matrix("L", diag, n, 10, 0, seed=200 + n)
    b = xb.init_fpuniform(n, 10, 0, seed=201 + n)
    want = u64(oracle_trsv_lower(a, b, unit=diag == "U"))
    assert_bits(port_bits("L", "N", diag, a, b), want, f"n={n} {diag}")
    # the upper solve is the lower solve of the flipped system
    got = port_bits("U", "N", diag, a[::-1, ::-1].copy(), b[::-1].copy())
    assert_bits(got[::-1], want, f"n={n} {diag} upper")


def test_trsv_lower_x_torch_block_invariance():
    n = 130
    a, b = system("L", "N", n, "fpuniform8", seed=300)
    want = jax_bits("L", "N", "N", a, b)
    tb, bb = _t(a).view(torch.int64), _t(b).view(torch.int64)
    # the public plain path takes JAX's block for every n (here 2)
    assert all(E._choose_block(k) == JE._choose_block(k)
               for k in range(1, 300))
    for block in (1, 8, 32, 128):  # 8, 32 and 128 leave a ragged last block
        got = u64(tk.trsv_lower_x_torch(tb, bb, False, block=block)
                  .view(torch.float64))
        assert_bits(got, want, f"block {block}")


# --- specials and the masking traps ------------------------------------------

def _zero_diag():
    a, b = system("L", "N", 130, "fpuniform8", seed=400)
    a[5, 5] = 0.0        # x_5 = +-Inf; rows below meet Inf and 0 * Inf
    a[40, 40] = -0.0
    a[50:60, 5] = 0.0    # strictly-lower zeros times x_5 = Inf: NaN
    b[40] = 0.0
    return "N", a, b


def _specials_in_b():
    a, b = system("L", "N", 130, "fpuniform8", seed=401)
    b[3], b[70], b[100] = np.inf, -np.inf, NAN_PAYLOAD
    return "N", a, b


def _nan_upper():
    a, b = system("L", "N", 4, "fpuniform8", seed=402)
    a[np.triu_indices(4, 1)] = NAN_PAYLOAD
    return "N", a, b


def _nan_unit_diag():
    a, b = system("L", "U", 33, "fpuniform8", seed=403)
    a[np.triu_indices(33, 0)] = NAN_PAYLOAD  # the diagonal is never read
    return "U", a, b


def _subnormal_x():
    a, b = system("L", "N", 130, "fpuniform8", seed=404)
    a[np.diag_indices(130)] *= 2.0 ** 700
    b = xb.init_fpuniform(130, 8, -350, seed=405)  # x_i ~ 2^-1050
    return "N", a, b


SPECIALS = {"zero_diag": _zero_diag, "specials_in_b": _specials_in_b,
            "nan_upper": _nan_upper, "nan_unit_diag": _nan_unit_diag,
            "subnormal_x": _subnormal_x}


@pytest.mark.parametrize("case", list(SPECIALS))
def test_extrsv_specials_match_jax(case):
    diag, a, b = SPECIALS[case]()
    want = jax_bits("L", "N", diag, a, b)
    got = port_bits("L", "N", diag, a, b)
    assert_bits(got, want, case)
    x = got.view(np.float64)
    if case == "zero_diag":
        assert np.isinf(x[5]) and np.isnan(x[50:60]).all()
        assert (u64(x[np.isnan(x)]) == 0x7FF8000000000000).all()
    elif case in ("nan_upper", "nan_unit_diag"):
        clean = np.tril(a, -1 if diag == "U" else 0)
        assert_bits(got, port_bits("L", "N", diag, clean, b), "masked")
    elif case == "subnormal_x":
        assert (np.abs(x[:8]) < 2.0 ** -1022).all() and (x[:8] != 0).all()


# --- buffers, errors, control, devices ---------------------------------------

def test_extrsv_lda_incx():
    n, lda = 33, 37
    a, b = system("U", "U", n, "lognormal", seed=500)
    buf = np.random.RandomState(501).uniform(-1, 1, lda * n)
    for j in range(n):
        buf[j * lda: j * lda + n] = a[:, j]
    b_buf = np.random.RandomState(502).uniform(-1, 1, 2 * n)
    b_buf[::2] = b
    want = jax_bits("U", "T", "U", a, b)
    kw = dict(n=n, lda=lda, incx=2)
    assert_bits(jax_bits("U", "T", "U", buf, b_buf, **kw), want, "jax")
    assert_bits(port_bits("U", "T", "U", buf, b_buf, **kw), want, "numpy")
    got = xt.extrsv_bits("U", "T", "U", _t(buf), _t(b_buf), **kw)
    assert_bits(u64(got.view(torch.float64)), want, "tensor buffers")


ERRORS = {
    "uplo": (("X", "N", "N"), {}),
    "trans": (("L", "C", "N"), {}),
    "diag": (("L", "N", "X"), {}),
    "shape": (("L", "N", "N"), {"b": lambda b: b[:3]}),
    "fpe": (("L", "N", "N"), {"fpe": 11}),
    "fpe_negative": (("L", "N", "N"), {"fpe": -1}),
    "lda_without_n": (("L", "N", "N"), {"lda": 4}),
    "incx": (("L", "N", "N"), {"incx": 0}),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_extrsv_errors(case):
    a = xb.init_fpuniform_tr_matrix("L", "N", 4, 4, 0, seed=101)
    b = xb.init_fpuniform(4, 4, 0, seed=102)
    args, kw = ERRORS[case]
    kw = dict(kw)
    if "b" in kw:
        b = kw.pop("b")(b)
    with pytest.raises(ValueError):
        xb.extrsv(*args, a, b, impl="xla", **kw)
    with pytest.raises(ValueError):
        xt.extrsv(*args, a, b, device="cpu", **kw)


def test_extrsv_fpe1_control():
    from exblas_tpu.baselines import trsv_baseline

    n = 16
    for uplo, trans, diag in (("L", "N", "N"), ("U", "T", "U"),
                              ("U", "N", "N"), ("L", "T", "U")):
        a, b = system(uplo, diag, n, "fpuniform8", seed=600)
        a = a + np.where(a == 0, 7.0, 0.0)  # the other triangle is not read
        got = xt.extrsv(uplo, trans, diag, _t(a), _t(b), fpe=1)
        want = trsv_baseline(uplo, trans, diag, a, b)
        assert np.allclose(got.numpy(), want, rtol=1e-10), (uplo, trans, diag)


def test_extrsv_device_rules(monkeypatch):
    a, b = system("L", "N", 4, "fpuniform8", seed=700)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xt.extrsv("L", "N", "N", a, b)
    got = xt.extrsv("L", "N", "N", _t(a), _t(b))
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert_bits(u64(got), jax_bits("L", "N", "N", a, b), "cpu tensors")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        xt.extrsv("L", "N", "N", _t(a), _t(b), impl="cuda")
    empty = xt.extrsv("L", "N", "N", np.zeros((0, 0)), np.zeros(0),
                      device="cpu")
    assert empty.shape == (0,)


def test_trsv_cuda_wrapper_refuses_cpu_tensors():
    t, b = _t(np.eye(3)).view(torch.int64), _t(np.ones(3)).view(torch.int64)
    before = tk.trsv_lower_x_cuda.launches
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tk.trsv_lower_x_cuda(t, b, False)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tgemv.gemv_rows_acc_cuda(t[1:, :1], b[:1], negate_z=True)
    assert tk.trsv_lower_x_cuda.launches == before


def test_gemv_rows_negated_z_is_negated_a():
    """B7's panel option: products with -z equal those of -A, NaN/Inf
    counts included (the JAX solve negates T)."""
    rs = np.random.RandomState(800)
    a = rs.uniform(-4, 4, (9, 12))
    a[2, 3], a[4, 0], a[5, 7] = np.inf, -np.inf, NAN_PAYLOAD
    z = rs.uniform(-4, 4, 12)
    z[7], z[0] = 0.0, -np.inf
    ab, zb = _t(a).view(torch.int64), _t(z).view(torch.int64)
    got = tgemv.gemv_rows_acc_torch(ab[:, 1:], zb[1:], negate_z=True)
    want = tgemv.gemv_rows_acc_torch(_t(-a[:, 1:]).view(torch.int64), zb[1:])
    for g, w in zip(canonicalize_digits(got[0]), canonicalize_digits(want[0])):
        assert torch.equal(g, w)
    assert torch.equal(got[1], want[1]) and int(got[1][:, 1:].sum()) > 0
