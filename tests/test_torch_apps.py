"""The application studies of the PyTorch port (``exblas_tpu_torch.apps``)
on the CPU: each experiment's strong reproducibility (the exact path
bit-identical across shuffled reruns, the float control not), its
reproducible values held bit for bit against the JAX package's building
blocks on the same data (``exsum``, ``exsum_segmented``,
``_rows_dot_exact``, ``dot_rows_acc_xla``, the jitted device k-means
step and ``_f32_from_bits``), the numpy readers against the JAX
package's, and the CLIs.  Tolerance is zero.  The JAX experiments
themselves are not re-run: each JAX reference is one building block,
computed once a module."""

import functools
import importlib
import math
import os

import numpy as np
import pytest
import torch

import exblas_tpu_torch as xt
from exblas_tpu_torch import apps
from exblas_tpu_torch.apps import gridding, io, kmeans, rng_sum, spmv
from exblas_tpu_torch.ops.exgemv import dot_rows_acc
from torch_parity import assert_same_state, u64

CPU = dict(device="cpu")


def _bits(a):
    return np.ascontiguousarray(a, np.float64).view(np.uint64)


# --- the experiments -------------------------------------------------------

def test_rng_sum_strong_reproducibility():
    import exblas_tpu as xb

    r = apps.rng_sum_experiment(n=20000, repeats=6, seed=1, **CPU)
    assert r["repro_unique"] == 1
    assert r["repro_equals_single_pass"]
    assert r["control_unique"] > 1, "control unexpectedly reproducible"
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, 20000) * np.exp2(rng.randint(-30, 30, 20000))
    assert u64(xb.exsum_bits(x, impl="xla")) == _bits(r["value"])
    assert r["value"] == math.fsum(x)


def test_rng_sum_parts_below_and_above_the_ladder(monkeypatch):
    """A part at or above the ladder's threshold takes the anchored
    ladder, a smaller one the exact path; the merged partials are the
    single pass's bits."""
    exsum_mod = importlib.import_module("exblas_tpu_torch.ops.exsum")
    monkeypatch.setattr(exsum_mod, "_SUM_MXU_MIN", 4096)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.uniform(-1, 1, 6000)
                         * np.exp2(rng.randint(-30, 30, 6000)))
    exsum_mod._exsum_acc_mxu_auto.route = ()
    got = rng_sum._exsum_parts([x[5000:], x[:5000]])
    assert exsum_mod._exsum_acc_mxu_auto.route != ()
    assert _bits(got) == _bits(xt.exsum(x))


def test_kmeans_strong_reproducibility():
    r = apps.kmeans_experiment(n=600, nf=3, k=4, repeats=4, seed=2, **CPU)
    assert r["repro_unique"] == 1
    assert r["control_unique"] > 1


def test_spmv_strong_reproducibility():
    r = apps.spmv_experiment(m=100, nnz=24, repeats=4, seed=3, **CPU)
    assert r["repro_unique"] == 1
    assert r["control_unique"] > 1


def test_gridding_strong_reproducibility():
    r = apps.gridding_experiment(n_samples=2000, n_cells=8, repeats=4,
                                 seed=4, **CPU)
    assert r["repro_unique"] == 1
    assert r["control_unique"] > 1


def test_experiments_exported_and_need_a_device(monkeypatch):
    assert sorted(apps.__all__) == sorted(
        ["rng_sum_experiment", "kmeans_experiment", "spmv_experiment",
         "gridding_experiment"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (apps.rng_sum_experiment, apps.kmeans_experiment,
               apps.spmv_experiment, apps.gridding_experiment):
        with pytest.raises(RuntimeError):
            fn()


# --- the reproducible paths against the JAX package's building blocks -----

def _kmeans_points(n=600, nf=3, seed=2):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (n, nf)) * np.exp2(rng.randint(-20, 20,
                                                             (n, nf)))


@pytest.mark.parametrize("empty", [False, True])
def test_update_centers_repro_matches_jax(empty):
    from exblas_tpu.apps import kmeans as jk

    pts = _kmeans_points()
    mem = kmeans._assign(pts, pts[:4])
    if empty:
        mem[mem == 2] = 1  # cluster 2 empty: its center is 0
    got = kmeans._update_centers_repro(pts, mem, 4, **CPU)
    want = jk._update_centers_repro(pts, mem, 4)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _csr(m=120, nnz=24, seed=3):
    vals, cols = spmv.make_random_csr(m, nnz, seed)
    rng = np.random.RandomState(seed + 1)
    x = rng.uniform(-1, 1, m) * np.exp2(rng.randint(-25, 25, m))
    return vals, cols, x


def test_make_random_csr_matches_jax():
    from exblas_tpu.apps import spmv as js

    for a, b in zip(spmv.make_random_csr(50, 7, 9),
                    js.make_random_csr(50, 7, 9)):
        np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_rows_dot_exact():
    """The body of the JAX package's ``spmv._rows_dot_exact`` under one
    ``jax.jit`` (eagerly its operations compile one by one, about 6 s)."""
    import jax

    from exblas_tpu.ops.exgemv import dot_rows_acc_xla, round_rows

    return jax.jit(lambda *planes: round_rows(*dot_rows_acc_xla(*planes)))


def test_spmv_repro_matches_jax():
    from exblas_tpu.core.ieee import split_f64

    vals, cols, x = _csr()
    vals[3, 5] = np.inf     # a row with a special
    vals[7, :] = 0.0        # a zero row gives +0
    got = spmv.spmv_repro(vals, cols, x, **CPU)
    av, xv = split_f64(vals), split_f64(x[cols])
    want = np.asarray(_jax_rows_dot_exact()(av.hi, av.lo, xv.hi,
                                            xv.lo)).view(np.float64)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    perm = np.random.RandomState(8).permutation(vals.shape[1])
    np.testing.assert_array_equal(
        _bits(spmv.spmv_repro(vals[:, perm], cols[:, perm], x, **CPU)),
        _bits(got))


@functools.lru_cache(maxsize=None)
def _jax_rows_acc():
    import jax

    from exblas_tpu.ops.exgemv import dot_rows_acc_xla

    return jax.jit(dot_rows_acc_xla)


@pytest.mark.parametrize("chunk", [None, 50])
def test_dot_rows_acc_2d_z_matches_jax(chunk, monkeypatch):
    """Each row against its own z, in one pass or in chunks of rows;
    states compared by canonical digits, sign and special counts."""
    from exblas_tpu.core.ieee import split_f64

    from torch_parity import jax_state

    exgemv_mod = importlib.import_module("exblas_tpu_torch.ops.exgemv")
    if chunk:
        monkeypatch.setattr(exgemv_mod, "PRODUCTS_PER_PASS", chunk)
    rng = np.random.RandomState(6)
    a = xt.init_fpuniform(40 * 9, 600, -300, seed=7).reshape(40, 9)
    z = rng.uniform(-1, 1, (40, 9)) * np.exp2(rng.randint(-500, 500,
                                                          (40, 9)))
    a[1, 2], z[2, 3], a[4, 0], z[4, 0] = np.nan, -np.inf, 0.0, np.inf
    a[5, :], z[5, :] = a[6, :], -a[6, :]   # exact cancellation
    limbs, special = dot_rows_acc(torch.from_numpy(a).view(torch.int64),
                                  torch.from_numpy(z).view(torch.int64))
    ab, zb = split_f64(a), split_f64(z)
    jl, js = _jax_rows_acc()(ab.hi, ab.lo, zb.hi, zb.lo)
    from exblas_tpu_torch.core.types import DOT_FORMAT, Superacc
    from exblas_tpu.core.types import DOT_FORMAT as JDOT, Superacc as JS

    for i in range(a.shape[0]):
        got = Superacc(limbs=limbs[i], special=special[i], fmt=DOT_FORMAT)
        want = JS(limbs=jl[i], special=js[i], fmt=JDOT)
        from torch_parity import port_state

        assert_same_state(port_state(got), jax_state(want), f"row {i}")
    with pytest.raises(ValueError):
        dot_rows_acc(torch.zeros((3, 4), dtype=torch.int64),
                     torch.zeros((4, 3), dtype=torch.int64))


def _grid_data(n=3000, n_cells=24, seed=4):
    rng = np.random.RandomState(seed)
    cells = rng.randint(0, n_cells, n)
    mag = np.exp2(rng.randint(-25, 25, n).astype(np.float64))
    values = (rng.uniform(-1, 1, n) * mag
              + 1j * rng.uniform(-1, 1, n) * mag)
    return cells, values, n_cells


def test_grid_repro_matches_jax():
    from exblas_tpu.apps import gridding as jg

    cells, values, n_cells = _grid_data()
    got = gridding.grid_repro(cells, values, n_cells + 2, **CPU)  # 2 empty
    want = jg.grid_repro(cells, values, n_cells + 2)
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def test_grid_control_matches_arrival_order_loop():
    from exblas_tpu.apps import gridding as jg

    cells, values, n_cells = _grid_data()
    np.testing.assert_array_equal(
        gridding.grid_control(cells, values, n_cells).view(np.uint64),
        jg.grid_control(cells, values, n_cells).view(np.uint64))


# --- the device k-means step -----------------------------------------------

F32_CASES = np.array([
    0.0, -0.0, 1.0, -2.5, 5e-324, -2.2250738585072014e-308,  # subnormal, min
    np.inf, -np.inf, np.nan, -np.nan,
    2.0 ** 130, -(2.0 ** 130), 2.0 ** -130, -(2.0 ** -130),
    2.0 ** 128, 2.0 ** 127 * 1.5, 2.0 ** -126, 2.0 ** -127, 2.0 ** -149,
    1.5 * 2.0 ** -127, -1.25 * 2.0 ** -127,  # rebiased exponent 0: zero
    1.0 + 2.0 ** -23 - 2.0 ** -30,   # nearest rounds up, truncation down
    -(1.0 + 2.0 ** -24 + 2.0 ** -40),
    3.4028235677973366e38, 3.4028235677973362e38, 0.1, -1e-30, 1e38,
])


def test_f32_from_bits_matches_jax():
    import jax

    from exblas_tpu.apps.kmeans import _f32_from_bits as jf32
    from exblas_tpu.core.ieee import split_f64

    b = split_f64(F32_CASES)
    want = np.asarray(jax.jit(jf32)(b.hi, b.lo)).view(np.uint32)
    got = kmeans._f32_from_bits(torch.from_numpy(F32_CASES).view(
        torch.int64)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    # truncation, not nearest: differs from the rounding cast here
    i = list(F32_CASES).index(1.0 + 2.0 ** -23 - 2.0 ** -30)
    assert got[i] != np.float32(F32_CASES[i]).view(np.uint32)


def _clusters(seed=7, per=150):
    rng = np.random.RandomState(seed)
    k, nf = 4, 3
    offs = np.array([[0.0, 0.0, 0.0], [100.0, 0, 0],
                     [0, 100.0, 0], [0, 0, 100.0]])
    pts = np.concatenate([
        offs[c] + rng.uniform(-1, 1, (per, nf)) * np.exp2(
            rng.randint(-12, 12, (per, nf)))
        for c in range(k)])
    return pts, offs + 0.25, k


@functools.lru_cache(maxsize=None)
def _jax_step(k):
    import jax

    from exblas_tpu.apps.kmeans import kmeans_step_device as jstep

    return jax.jit(functools.partial(jstep, k=k))


def _jax_step_np(pts, centers, k):
    from exblas_tpu.core.ieee import split_f64

    b, c = split_f64(pts), split_f64(centers)
    c_hi, c_lo, mem = _jax_step(k)(b.hi, b.lo, c.hi, c.lo)
    bits = (np.asarray(c_hi, np.uint64) << np.uint64(32)) | np.asarray(
        c_lo, np.uint64)
    return bits, np.asarray(mem)


@pytest.mark.parametrize("case", ["plain", "empty_cluster", "shuffled"])
def test_kmeans_step_device_matches_jax(case):
    pts, init, k = _clusters()
    if case == "empty_cluster":
        init[3] = [1e6, 1e6, 1e6]      # nothing is nearest to it
    if case == "shuffled":
        pts = pts[np.random.RandomState(9).permutation(len(pts))]
    want_bits, want_mem = _jax_step_np(pts, init, k)
    got, mem = kmeans.kmeans_step_device(torch.from_numpy(pts),
                                         torch.from_numpy(init), k)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want_bits)
    np.testing.assert_array_equal(mem.numpy(), want_mem)
    if case == "empty_cluster":
        assert (want_bits[3] == 0).all()   # +0, not the old center
    # the int64 bit patterns are accepted too
    got2, _ = kmeans.kmeans_step_device(
        torch.from_numpy(pts).view(torch.int64),
        torch.from_numpy(init).view(torch.int64), k)
    assert torch.equal(got2.view(torch.int64), got.view(torch.int64))


def test_kmeans_device_shuffle_invariant_and_exact():
    """Centers bit-identical under point shuffles, and equal to the exact
    sum / count given the same membership."""
    pts, init, k = _clusters()
    rng = np.random.RandomState(10)
    outs, mem0 = set(), None
    for _ in range(3):
        perm = rng.permutation(len(pts))
        centers, mem = kmeans.kmeans_device(pts[perm], k, iters=3,
                                            init=init, **CPU)
        assert mem.dtype == np.int32
        outs.add(centers.tobytes())
        unshuffled = mem[np.argsort(perm)]
        mem0 = unshuffled if mem0 is None else mem0
        np.testing.assert_array_equal(mem0, unshuffled)
    assert len(outs) == 1
    centers, mem = kmeans.kmeans_device(pts, k, iters=1, init=init, **CPU)
    for c in range(k):
        members = pts[mem == c]
        for f in range(pts.shape[1]):
            want = math.fsum(members[:, f]) / len(members)
            assert _bits(centers[c, f]) == _bits(want)


def test_kmeans_step_restores_matmul_precision():
    pts, init, k = _clusters(per=10)
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        kmeans.kmeans_step_device(torch.from_numpy(pts),
                                  torch.from_numpy(init), k)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(saved)


def test_kmeans_step_leaves_default_precision_untouched(monkeypatch):
    """At PyTorch's default precision the step writes no process-wide
    setting."""
    pts, init, k = _clusters(per=10)
    if torch.get_float32_matmul_precision() != "highest":
        pytest.fail("the tests expect PyTorch's default matmul precision")

    def refuse(_):
        raise AssertionError("the matmul precision was set")

    monkeypatch.setattr(torch, "set_float32_matmul_precision", refuse)
    kmeans.kmeans_step_device(torch.from_numpy(pts), torch.from_numpy(init),
                              k)


# --- the readers and the CLIs ----------------------------------------------

MTX = """%%MatrixMarket matrix coordinate real symmetric
% a comment
4 4 6
1 1 2.5
2 1 -1.25
3 2 4.0
3 3 1e-3
4 1 7.0
4 4 -3.5
"""


def test_readers_match_jax(tmp_path):
    from exblas_tpu.apps import io as jio

    mtx = tmp_path / "a.mtx"
    mtx.write_text(MTX)
    got, want = io.read_matrix_market(str(mtx)), jio.read_matrix_market(
        str(mtx))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(io.mm_to_padded_rows(*got), jio.mm_to_padded_rows(
            *want)):
        np.testing.assert_array_equal(a, b)
    pts = tmp_path / "points"
    pts.write_text("1 0.5 2.0\n2 -1.5 3.25\n\n3 4.0 -0.125\n")
    np.testing.assert_array_equal(io.read_kmeans_points(str(pts)),
                                  jio.read_kmeans_points(str(pts)))
    uks = tmp_path / "s.uks"
    uks.write_text("aquisition.numsamples=3000\n"
                   "aquisition.kmax=150.0 150.0 150.0\n"
                   "gridding.matrixSize=16 16 16\n")
    p, s = io.read_uks(str(uks), synth_cap=500)
    jp, js = jio.read_uks(str(uks), synth_cap=500)
    assert p == jp and p["synthetic"]
    np.testing.assert_array_equal(s, js)


def test_reference_data_path(tmp_path, monkeypatch):
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "f.mtx").write_text(MTX)
    monkeypatch.delenv("EXBLAS_REFERENCE_ROOT", raising=False)
    assert io.reference_data_path("d", "f.mtx") is None
    monkeypatch.setenv("EXBLAS_REFERENCE_ROOT", str(tmp_path))
    assert io.reference_data_path("d", "f.mtx") == os.path.join(
        str(tmp_path), "d", "f.mtx")
    assert io.reference_data_path("d", "missing") is None


def test_clis_on_local_files(tmp_path, capsys):
    mtx = tmp_path / "a.mtx"
    mtx.write_text(MTX)
    assert spmv.main([str(mtx), "3"], **CPU) == 0
    pts = tmp_path / "points"
    rows = np.random.RandomState(0).uniform(-1, 1, (40, 3))
    pts.write_text("".join(f"{i} " + " ".join(repr(float(v)) for v in r)
                           + "\n" for i, r in enumerate(rows)))
    assert kmeans.main([str(pts), "3", "3"], **CPU) == 0
    uks = tmp_path / "s.uks"
    uks.write_text("aquisition.numsamples=2000\n"
                   "aquisition.kmax=150.0 150.0 150.0\n"
                   "gridding.matrixSize=16 16 16\n")
    assert gridding.main([str(uks), "128", "3"], **CPU) == 0
    out = capsys.readouterr().out
    assert out.count("reproducible path: 1 distinct result(s)   OK") == 3
    for mod in (spmv, kmeans, gridding):
        assert mod.main([]) == 1   # usage


_SPMV_DIR = ("src", "cpu", "examples", "spmv (Parboil)", "data")


@pytest.mark.parametrize("name", ["jgl009.mtx", "fidapm05.mtx"])
def test_spmv_real_matrix_market(name):
    path = io.reference_data_path(*_SPMV_DIR, name)
    if path is None:
        pytest.skip("reference data not available")
    assert spmv.main([path, "4"], **CPU) == 0


def test_kmeans_real_data():
    path = io.reference_data_path(
        "src", "cpu", "examples", "kmeans (Rodinia)", "data", "100")
    if path is None:
        pytest.skip("reference data not available")
    assert io.read_kmeans_points(path).shape == (100, 34)
    assert kmeans.main([path, "4", "4"], **CPU) == 0


def test_gridding_real_uks():
    path = io.reference_data_path(
        "src", "cpu", "examples", "mri-gridding (Parboil)", "data",
        "small", "small.uks")
    if path is None:
        pytest.skip("reference data not available")
    params, samples = io.read_uks(path, synth_cap=20000)
    assert int(params["aquisition.numsamples"]) == 2655910
    idx = np.random.RandomState(0).randint(0, 999, len(samples))
    occupied, idx = np.unique(idx, return_inverse=True)
    vals = samples[:, 0] + 1j * samples[:, 1]
    rng = np.random.RandomState(1)
    outs = set()
    for _ in range(3):
        perm = rng.permutation(len(vals))
        outs.add(gridding.grid_repro(idx[perm], vals[perm], len(occupied),
                                     **CPU).tobytes())
    assert len(outs) == 1
