"""The port's mesh layer (``exblas_tpu_torch.parallel``) in Gloo worlds of
1, 2, 3, 4 and 8 CPU processes, bit for bit (tolerance 0):

* every case of the JAX package's ``test_distributed.py`` (11),
  ``test_distributed_blas2.py`` (34) and ``test_mesh_scale.py`` (1; its
  32- and 64-device meshes held at 8 ranks), on their data, against their
  expected bits: ``tests/oracle.py`` for sums and dots, the JAX package's
  single-device ``impl="xla"`` result for the rest;
* one direct parity case a sharded entry against the JAX sharded function
  (a mesh of 4, or of 2 for the solve), and ``psum_superacc``'s state
  (canonical digits, sign, counts) against JAX's;
* pins for the fault classes: a negative total whose top limb a rank's
  positive part must not strip, parts that cancel to +0, specials on
  different ranks, empty shards, uneven shapes, and every rank's bits
  alike.

Each world is spawned once (``tests/torch_dist.py``) and runs every call
of its size in the background while the JAX references compile; every
test reads its calls' results, which every rank of the world must give
alike.  ``test_port_imports_no_jax`` covers the children's imports:
they import only ``torch_dist`` and the port.
"""

import functools
import threading
import time
from functools import partial

import numpy as np
import pytest
import torch

import exblas_tpu as xb
import torch_dist
from fuzz import _oracle_gemm, _oracle_gemv, _oracle_trsv_lower
from oracle import assert_same_bits_arr, exact_dot, exact_sum, \
    exact_sum_with_specials
from torch_parity import assert_same_state, jax_state, u64

WORLDS = (1, 2, 3, 4, 8)
ONE_D = ("1d",)
# (key, entry, arguments) of calls that must raise, run in the world of 2
ENTRY_ERRORS = (
    ("dot_lengths", "exdot_sharded", (np.ones(3), np.ones(4))),
    ("trsv_shape", "extrsv_sharded", ("L", "N", "N", np.ones((3, 4)),
                                      np.ones(3))),
)
QNAN = 0x7FF8000000000000


def mesh2(shape, axes=("rows", "k")):
    return ("2d", tuple(shape), axes)


def _f(bits):
    return np.asarray(bits).view(np.float64)


# --- data: the JAX tests' recipes, seeds and sizes ------------------------

def _trsv_case(uplo, n=48):
    rng = np.random.RandomState(83)
    m0 = xb.init_fpuniform_matrix(n, n, 20, -10, seed=84)
    a = np.tril(m0) if uplo == "L" else np.triu(m0)
    idx = np.arange(n)
    a[idx, idx] = rng.uniform(0.5, 2.0, n) * np.where(
        rng.rand(n) < 0.5, -1.0, 1.0)
    return a, xb.init_fpuniform(n, 20, -10, seed=85)


def _zero_diag_case():
    n = 16
    a = np.tril(xb.init_fpuniform_matrix(n, n, 4, 0, seed=86))
    idx = np.arange(n)
    a[idx, idx] = 1.0
    a[5, 5] = 0.0
    return a, xb.init_fpuniform(n, 4, 0, seed=87)


@functools.lru_cache(maxsize=None)
def data():
    d = {
        # test_distributed.py
        "x41": xb.init_ill_cond(10000, 1e30, seed=41),
        "x42": xb.init_fpuniform(10007, 30, 5, seed=42),
        "a43": xb.init_ill_cond(4096, 1e24, seed=43),
        "b44": xb.init_ill_cond(4096, 1e24, seed=44),
        "x_inf": np.concatenate([np.full(1000, 1.0), [np.inf],
                                 np.full(1000, 2.0)]),
        "x_nan": np.concatenate([[np.inf], np.full(1000, 1.0), [-np.inf]]),
        # test_distributed_blas2.py
        "a61": xb.init_fpuniform_matrix(32, 64, 30, 0, seed=61),
        "x62": xb.init_fpuniform(64, 30, 0, seed=62),
        "a65": xb.init_fpuniform_matrix(32, 64, 30, 0, seed=65),
        "x66": xb.init_fpuniform(64, 30, 0, seed=66),
        "y67": xb.init_fpuniform(32, 35, -5, seed=67),
        "a63": xb.init_fpuniform_matrix(16, 16, 25, 0, seed=63),
        "b64": xb.init_fpuniform_matrix(16, 16, 25, 0, seed=64),
        "a71": xb.init_fpuniform_matrix(16, 24, 25, 0, seed=71),
        "b72": xb.init_fpuniform_matrix(24, 16, 25, 0, seed=72),
        "c73": xb.init_fpuniform_matrix(16, 16, 35, -5, seed=73),
        "a67": xb.init_fpuniform_matrix(16, 16, 25, 0, seed=67),
        "b68": xb.init_fpuniform_matrix(16, 16, 25, 0, seed=68),
        "a69": xb.init_fpuniform_matrix(8, 16, 30, 0, seed=69),
        "b70": xb.init_fpuniform_matrix(16, 12, 30, 0, seed=70),
        "ga71": xb.init_fpuniform_matrix(32, 64, 12, 0, seed=71),
        "gx72": xb.init_fpuniform(64, 12, 0, seed=72),
        "tz": _zero_diag_case(),
        # test_mesh_scale.py
        "s71": xb.init_ill_cond(20000, 1e28, seed=71),
        "s72": xb.init_fpuniform(20011, 40, -10, seed=72),
        "s73": xb.init_ill_cond(8192, 1e20, seed=73),
        "s74": xb.init_ill_cond(8192, 1e20, seed=74),
        "s_inf": np.concatenate([np.full(100, 1.0), [np.inf],
                                 np.full(900, 2.0)]),
    }
    for uplo, trans, diag in TRSV_FORMS:
        d["t" + uplo] = _trsv_case(uplo)
    # parity with the JAX sharded functions (uneven sizes)
    rng = np.random.RandomState(90)
    d["p_sum"] = xb.init_ill_cond(1001, 1e20, seed=91)
    d["p_a"] = xb.init_ill_cond(1003, 1e16, seed=92)
    d["p_b"] = xb.init_ill_cond(1003, 1e16, seed=93)
    d["p_mat"] = xb.init_fpuniform_matrix(21, 37, 30, -10, seed=94)
    d["p_x37"] = xb.init_fpuniform(37, 30, -10, seed=95)
    d["p_x21"] = xb.init_fpuniform(21, 30, -10, seed=96)
    d["p_y21"] = xb.init_fpuniform(21, 35, -5, seed=97)
    d["p_y37"] = xb.init_fpuniform(37, 35, -5, seed=98)
    d["p_ga"] = xb.init_fpuniform_matrix(13, 11, 25, -5, seed=99)
    d["p_gbt"] = xb.init_fpuniform_matrix(9, 11, 25, -5, seed=100)
    d["p_gc"] = xb.init_fpuniform_matrix(13, 9, 35, -5, seed=101)
    t = np.triu(xb.init_fpuniform_matrix(63, 63, 20, -12, seed=102))
    t[np.arange(63), np.arange(63)] = rng.uniform(0.5, 2.0, 63)
    d["p_t"] = (t, xb.init_fpuniform(63, 20, -10, seed=103))
    # fault classes
    pos = xb.init_fpuniform(250, 40, 0, seed=104)
    neg = -2.0 * xb.init_fpuniform(750, 40, 0, seed=105)
    d["f_neg"] = np.concatenate([pos, neg])       # rank 0 of 4: positive
    d["f_neg_b"] = xb.init_fpuniform(1000, 4, 0, seed=115)
    half = xb.init_fpuniform(500, 60, -30, seed=106)
    d["f_cancel"] = np.concatenate([half, -half])  # ranks' parts nonzero
    d["f_negzero"] = np.full(5, -0.0)
    spec = np.ones(16)
    spec[1], spec[13] = np.inf, -np.inf          # ranks 0 and 3 of 4
    d["f_pm_inf"] = spec
    nan = np.ones(16)
    nan[6] = np.array([0xFFF0000000000123], np.uint64).view(np.float64)[0]
    d["f_nan"] = nan                              # a NaN payload, rank 1
    two = np.ones(16)
    two[0], two[15] = np.inf, np.inf
    d["f_inf2"] = two
    zi = np.ones(16)
    zi[9] = np.inf
    d["f_zero_inf"] = (np.where(np.arange(16) == 9, 0.0, 1.0), zi)
    d["f_small"] = np.array([1e300, -3.5, 1e-300])
    d["u_a"] = xb.init_fpuniform_matrix(13, 7, 30, -15, seed=107)
    d["u_x"] = xb.init_fpuniform(7, 30, -15, seed=108)
    d["u_y"] = xb.init_fpuniform(13, 30, -15, seed=109)
    d["u_ga"] = xb.init_fpuniform_matrix(7, 5, 30, -15, seed=110)
    d["u_gb"] = xb.init_fpuniform_matrix(5, 3, 30, -15, seed=111)
    d["u_gc"] = xb.init_fpuniform_matrix(7, 3, 30, -15, seed=112)
    t5 = np.tril(xb.init_fpuniform_matrix(5, 5, 4, -2, seed=113))
    t5[np.arange(5), np.arange(5)] = 1.5
    d["u_t"] = (t5, xb.init_fpuniform(5, 4, -2, seed=114))
    return d


TRSV_FORMS = (("L", "N", "N"), ("U", "N", "U"), ("L", "T", "N"),
              ("U", "T", "N"))
GEMM_2D_SHAPES = ((1, 8), (2, 4), (4, 2), (8, 1))
GEMV_2D_SHAPES = ((1, 8), (2, 4), (4, 2), (8, 1), (2, 2))


def shards(v, nd):
    """The JAX package's shards of ``v``: zero-padded to a multiple of nd,
    cut into nd contiguous parts."""
    v = np.asarray(v, np.float64)
    size = -(-len(v) // nd)
    return list(np.concatenate([v, np.zeros(size * nd - len(v))])
                .reshape(nd, size))


def plan(d) -> dict:
    """Every world's calls, keyed as the tests read them."""
    calls = {w: [] for w in WORLDS}

    def add(worlds, key, entry, *args, mesh=ONE_D, **kwargs):
        for w in worlds:
            calls[w].append(dict(key=key, entry=entry, args=args,
                                 kwargs=kwargs, mesh=mesh))

    for w in WORLDS:
        add((w,), "ranks", "mesh_ranks")
        add((w,), "make_mesh_error", "make_mesh_error", w + 1)
    for key, name, args in ENTRY_ERRORS:
        add((2,), key, "entry_error", name, *args)
    # test_distributed.py
    add((1, 2, 4, 8), "sum41", "exsum_sharded", d["x41"], impl="torch")
    add((1, 3, 8), "sum42", "exsum_sharded", d["x42"], impl="torch")
    add((2, 8), "dot43", "exdot_sharded", d["a43"], d["b44"], impl="torch")
    add((4,), "sum_inf", "exsum_sharded", d["x_inf"], impl="torch")
    add((4,), "sum_nan", "exsum_sharded", d["x_nan"], impl="torch")
    # test_distributed_blas2.py
    for shard in ("rows", "k"):
        add((1, 2, 8), f"gemv_{shard}", "exgemv_sharded", d["a61"],
            d["x62"], alpha=1.5, shard=shard, impl="torch")
        for beta in (1.0, -2.5):
            add((1, 4, 8), f"gemv_{shard}_beta{beta}", "exgemv_sharded",
                d["a65"], d["x66"], alpha=-0.75, beta=beta, y=d["y67"],
                shard=shard, impl="torch")
    for beta in (1.0, -2.5):
        add((8,), f"gemv2d_beta{beta}", "exgemv_sharded_2d", d["a65"],
            d["x66"], alpha=-0.75, beta=beta, y=d["y67"],
            mesh=mesh2((2, 4)))
        kw = dict(alpha=-0.5, beta=beta, c=d["c73"])
        add((1, 4, 8), f"gemm_ab{beta}", "exgemm_sharded", d["a71"],
            d["b72"], impl="torch", **kw)
        add((1, 4, 8), f"gemm_k_ab{beta}", "exgemm_sharded_k", d["a71"],
            d["b72"], **kw)
        add((8,), f"gemm2d_ab{beta}", "exgemm_sharded_2d", d["a71"],
            d["b72"], impl="torch", mesh=mesh2((2, 4), ("rows", "cols")),
            **kw)
    add((1, 4), "gemm", "exgemm_sharded", d["a63"], d["b64"], impl="torch")
    for form in TRSV_FORMS:
        add((1, 2, 4, 8), "trsv" + "".join(form), "extrsv_sharded", *form,
            *d["t" + form[0]], impl="torch")
    add((4,), "trsv_zero_diag", "extrsv_sharded", "L", "N", "N", *d["tz"],
        impl="torch")
    for shape in GEMM_2D_SHAPES:
        add((8,), f"gemm2d{shape}", "exgemm_sharded_2d", d["a67"], d["b68"],
            impl="torch", mesh=mesh2(shape, ("rows", "cols")))
    add((1, 2, 8), "gemm_k", "exgemm_sharded_k", d["a69"], d["b70"])
    add((1, 2, 4), "gemv_auto", "exgemv_sharded", d["ga71"], d["gx72"],
        alpha=2.0, shard="rows")
    for shape in GEMV_2D_SHAPES:
        add((shape[0] * shape[1],), f"gemv2d{shape}", "exgemv_sharded_2d",
            d["a65"], d["x66"], alpha=1.5, mesh=mesh2(shape))
    # test_mesh_scale.py, at 8 ranks against 1
    add((1, 8), "s71", "exsum_sharded", d["s71"], impl="torch")
    add((1, 8), "s72", "exsum_sharded", d["s72"], impl="torch")
    add((1, 8), "s73", "exdot_sharded", d["s73"], d["s74"], impl="torch")
    add((8,), "s_inf", "exsum_sharded", d["s_inf"], impl="torch")
    # parity with the JAX sharded functions
    add((4,), "p_sum", "exsum_sharded", d["p_sum"])
    add((4,), "p_dot", "exdot_sharded", d["p_a"], d["p_b"])
    gemv = dict(alpha=-0.75, beta=-2.5, y=d["p_y21"])
    add((4,), "p_gemv_rows", "exgemv_sharded", d["p_mat"], d["p_x37"],
        shard="rows", **gemv)
    add((4,), "p_gemv_k", "exgemv_sharded", d["p_mat"], d["p_x21"],
        alpha=3.7, beta=1.0, y=d["p_y37"], shard="k", trans="T")
    add((4,), "p_gemv_2d", "exgemv_sharded_2d", d["p_mat"], d["p_x37"],
        mesh=mesh2((2, 2)), **gemv)
    gemm = dict(alpha=-0.5, beta=2.5, c=d["p_gc"], transb="T")
    add((4,), "p_gemm", "exgemm_sharded", d["p_ga"], d["p_gbt"], **gemm)
    add((4,), "p_gemm_2d", "exgemm_sharded_2d", d["p_ga"], d["p_gbt"],
        mesh=mesh2((2, 2), ("rows", "cols")), **gemm)
    add((4,), "p_gemm_k", "exgemm_sharded_k", d["p_ga"], d["p_gbt"], **gemm)
    add((2,), "p_trsv", "extrsv_sharded", "U", "T", "N", *d["p_t"])
    # fault classes
    add((4,), "f_neg_state", "psum_state", "sum", shards(d["f_neg"], 4))
    add((4,), "f_neg_dot_state", "psum_state", "dot",
        list(zip(shards(d["f_neg"], 4), shards(d["f_neg_b"], 4))))
    for key in ("f_neg", "f_cancel", "f_negzero", "f_pm_inf", "f_nan",
                "f_inf2", "f_small"):
        add((4, 8), key, "exsum_sharded", d[key])
    add((4, 8), "f_zero_inf", "exdot_sharded", *d["f_zero_inf"])
    add((8,), "f_dot_small", "exdot_sharded", d["f_small"], d["f_small"])
    for w in (3, 8):
        for shard in ("rows", "k"):
            add((w,), f"u_gemv_{shard}", "exgemv_sharded", d["u_a"],
                d["u_x"], alpha=-1.25, beta=0.5, y=d["u_y"], shard=shard)
        add((w,), "u_gemm", "exgemm_sharded", d["u_ga"], d["u_gb"],
            alpha=3.0, beta=1.0, c=d["u_gc"])
        add((w,), "u_gemm_k", "exgemm_sharded_k", d["u_ga"], d["u_gb"],
            alpha=3.0, beta=1.0, c=d["u_gc"])
        add((w,), "u_trsv", "extrsv_sharded", "L", "N", "N", *d["u_t"])
    add((8,), "u_gemv_2d", "exgemv_sharded_2d", d["u_a"], d["u_x"],
        alpha=-1.25, beta=0.5, y=d["u_y"], mesh=mesh2((2, 4)))
    add((8,), "u_gemm_2d", "exgemm_sharded_2d", d["u_ga"], d["u_gb"],
        alpha=3.0, beta=1.0, c=d["u_gc"],
        mesh=mesh2((4, 2), ("rows", "cols")))
    return calls


# Seconds for every world: a hung world fails first by its own name, after
# torch_dist.WORLD_TIMEOUT in each of the two waves of ranks; this limit
# only catches a hang outside them.  The worlds take about 30 s in a run.
WORLDS_LIMIT = 2 * torch_dist.WORLD_TIMEOUT + 30


def _compute(directory):
    return torch_dist.spawn_worlds(
        torch_dist.run_calls,
        {w: ("cpu", calls) for w, calls in plan(data()).items()},
        rendezvous_dir=str(directory))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds' results, ``{world: [rank results]}``, computed in a
    background thread: the tests compile their JAX references meanwhile."""
    box = {}

    def target():
        try:
            box["value"] = torch_dist.shared_result(
                tmp_path_factory, "torch_parallel", _compute)
        except BaseException as e:  # re-raised by get() in the test
            box["error"] = e

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    deadline = time.monotonic() + WORLDS_LIMIT

    def get():
        thread.join(timeout=max(0.0, deadline - time.monotonic()))
        assert not thread.is_alive(), (
            f"the worlds did not finish in {WORLDS_LIMIT:g} s")
        if "error" in box:
            raise box["error"]
        return box["value"]

    return get


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_same, a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def one(worlds, world, key):
    """A call's result, after checking that every rank gave it."""
    ranks = worlds()[world]
    first = ranks[0][key]
    for r, res in enumerate(ranks[1:], 1):
        assert _same(res[key], first), (
            f"world {world}: rank {r} differs from rank 0 on {key}")
    return first


def same_bits(got, want, msg=""):
    """int64 bits ``got`` equal ``want``: doubles, or bits of an integer
    dtype."""
    got = np.asarray(got).reshape(-1).view(np.uint64)
    want = np.asarray(want)
    want = (want.astype(np.float64) if want.dtype.kind == "f"
            else want).reshape(-1).view(np.uint64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, (
        f"{msg}: {bad.size} differ, first at {bad[0]}: "
        f"{int(got[bad[0]]):#018x} != {int(want[bad[0]]):#018x}")


# --- JAX references, computed once a worker -------------------------------

@functools.lru_cache(maxsize=None)
def jax_gemv(a, x, alpha, beta=0.0, y=None):
    d = data()
    return xb.exgemv("N", alpha, d[a], d[x], beta=beta,
                     y=None if y is None else d[y], impl="xla")


@functools.lru_cache(maxsize=None)
def jax_gemm(a, b, alpha, beta=0.0, c=None):
    d = data()
    return xb.exgemm("N", "N", alpha, d[a], d[b], beta=beta,
                     c=None if c is None else d[c], impl="xla")


@functools.lru_cache(maxsize=None)
def jax_trsv(form):
    a, b = data()["t" + form[0]]
    return xb.extrsv(*form, a, b, impl="xla")


# --- direct parity with the JAX sharded functions (first: their JAX
# compiles overlap the worlds' run) ---------------------------------------

def _jax_parallel():
    from exblas_tpu import parallel as jp

    return jp


PARITY = {
    # the slowest JAX compiles first, while the worlds run
    "p_trsv": lambda jp, d: jp.extrsv_sharded(
        "U", "T", "N", *d["p_t"], mesh=jp.make_mesh(2)),
    "p_gemv_k": lambda jp, d: jp.exgemv_sharded(
        d["p_mat"], d["p_x21"], 3.7, mesh=jp.make_mesh(4), shard="k",
        impl="xla", beta=1.0, y=d["p_y37"], trans="T"),
    "p_gemv_2d": lambda jp, d: jp.exgemv_sharded_2d(
        d["p_mat"], d["p_x37"], -0.75, mesh=jp.make_mesh_2d((2, 2)),
        beta=-2.5, y=d["p_y21"]),
    "p_gemv_rows": lambda jp, d: jp.exgemv_sharded(
        d["p_mat"], d["p_x37"], -0.75, mesh=jp.make_mesh(4), shard="rows",
        impl="xla", beta=-2.5, y=d["p_y21"]),
    "p_gemm": lambda jp, d: jp.exgemm_sharded(
        d["p_ga"], d["p_gbt"], mesh=jp.make_mesh(4), impl="xla", alpha=-0.5,
        beta=2.5, c=d["p_gc"], transb="T"),
    "p_gemm_2d": lambda jp, d: jp.exgemm_sharded_2d(
        d["p_ga"], d["p_gbt"], mesh=jp.make_mesh_2d((2, 2), ("rows", "cols")),
        impl="xla", alpha=-0.5, beta=2.5, c=d["p_gc"], transb="T"),
    "p_gemm_k": lambda jp, d: jp.exgemm_sharded_k(
        d["p_ga"], d["p_gbt"], mesh=jp.make_mesh(4), alpha=-0.5, beta=2.5,
        c=d["p_gc"], transb="T"),
    "p_sum": lambda jp, d: jp.exsum_sharded(d["p_sum"], mesh=jp.make_mesh(4),
                                            impl="xla"),
    "p_dot": lambda jp, d: jp.exdot_sharded(d["p_a"], d["p_b"],
                                            mesh=jp.make_mesh(4), impl="xla"),
}


@pytest.mark.parametrize("key", list(PARITY))
def test_sharded_entry_matches_jax_sharded(worlds, key):
    want = np.asarray(PARITY[key](_jax_parallel(), data()))
    world = 2 if key == "p_trsv" else 4
    same_bits(one(worlds, world, key), want.view(np.float64), key)


def _jax_psum_state(kind: str, vectors, nd: int = 4):
    """JAX's ``psum_superacc`` over a mesh of ``nd``: each device's shard
    accumulated by the plain JAX accumulator, the total's state."""
    import jax
    from jax.sharding import PartitionSpec as P
    from exblas_tpu.core import accumulator as acc_mod
    from exblas_tpu.core.ieee import split_f64
    from exblas_tpu.core.types import DOT_FORMAT, SUM_FORMAT, Superacc

    jp = _jax_parallel()
    planes = []
    for v in vectors:
        b = split_f64(np.concatenate(shards(v, nd)))
        planes += [b.hi, b.lo]

    @partial(jax.shard_map, mesh=jp.make_mesh(nd),
             in_specs=(P(jp.distributed.AXIS),) * len(planes),
             out_specs=P(), check_vma=False)
    def run(*planes):
        acc = (acc_mod.accumulate_sum_terms(*planes, SUM_FORMAT)
               if kind == "sum" else
               acc_mod.accumulate_dot_terms(*planes, DOT_FORMAT))
        total = jp.psum_superacc(acc)
        return total.limbs, total.special

    limbs, special = jax.jit(run)(*planes)
    fmt = SUM_FORMAT if kind == "sum" else DOT_FORMAT
    return jax_state(Superacc(limbs=limbs, special=special, fmt=fmt))


@pytest.mark.parametrize("kind", ["sum", "dot"])
def test_psum_superacc_state_matches_jax(worlds, kind):
    """A total that is negative while rank 0's part is positive: the
    merged state (canonical digits, sign, counts) is JAX's, so the top
    limb kept its borrow through the int64 wire."""
    d = data()
    vectors = (d["f_neg"],) if kind == "sum" else (d["f_neg"], d["f_neg_b"])
    assert sum(shards(vectors[0], 4)[0] * (shards(vectors[-1], 4)[0]
                                           if kind == "dot" else 1)) > 0
    got = one(worlds, 4, "f_neg_state" if kind == "sum"
              else "f_neg_dot_state")
    want = _jax_psum_state(kind, vectors)
    assert want[1], "the total must be negative"
    assert_same_state(got, want, kind)


# --- test_distributed.py ---------------------------------------------------

def test_has_worlds(worlds):
    """Each world has its ranks (the JAX test's 8 virtual devices), and no
    rank imported JAX."""
    for w in WORLDS:
        assert [r["ranks"] for r in worlds()[w]] == [(w, i, False)
                                                     for i in range(w)]


@pytest.mark.parametrize("nd", [1, 2, 4, 8])
def test_exsum_mesh_invariance(worlds, nd):
    same_bits(one(worlds, nd, "sum41"), exact_sum(data()["x41"]),
              f"nd={nd}")


@pytest.mark.parametrize("nd", [1, 3, 8])
def test_exsum_uneven_shards(worlds, nd):
    same_bits(one(worlds, nd, "sum42"), exact_sum(data()["x42"]),
              f"nd={nd} uneven")


@pytest.mark.parametrize("nd", [2, 8])
def test_exdot_mesh_invariance(worlds, nd):
    d = data()
    same_bits(one(worlds, nd, "dot43"), exact_dot(d["a43"], d["b44"]),
              f"nd={nd}")


def test_specials_cross_device(worlds):
    assert _f(one(worlds, 4, "sum_inf")) == np.inf
    assert u64(one(worlds, 4, "sum_nan")) == QNAN


# --- test_distributed_blas2.py ---------------------------------------------

@pytest.mark.parametrize("shard", ["rows", "k"])
@pytest.mark.parametrize("nd", [1, 2, 8])
def test_exgemv_sharded_mesh_invariance(worlds, shard, nd):
    same_bits(one(worlds, nd, f"gemv_{shard}"), jax_gemv("a61", "x62", 1.5),
              f"{shard} nd={nd}")


@pytest.mark.parametrize("shard", ["rows", "k"])
@pytest.mark.parametrize("beta", [1.0, -2.5])
def test_exgemv_sharded_beta_mesh_invariance(worlds, shard, beta):
    """beta*y deposited exactly once per output row on any mesh or
    sharding (the owner's deposit for rows, replicated after the merge for
    k and the 2-D mesh)."""
    want = jax_gemv("a65", "x66", -0.75, beta, "y67")
    for nd in (1, 4, 8):
        same_bits(one(worlds, nd, f"gemv_{shard}_beta{beta}"), want,
                  f"nd={nd}")
    same_bits(one(worlds, 8, f"gemv2d_beta{beta}"), want, "2-D (2, 4)")


@pytest.mark.parametrize("nd", [1, 4])
def test_exgemm_sharded_mesh_invariance(worlds, nd):
    same_bits(one(worlds, nd, "gemm"), jax_gemm("a63", "b64", 1.0),
              f"nd={nd}")


@pytest.mark.parametrize("beta", [1.0, -2.5])
def test_exgemm_sharded_alpha_beta_mesh_invariance(worlds, beta):
    """alpha folded a shard, the exact beta*C deposited once an element
    (the owner for rows and 2-D, replicated after the merge for k)."""
    want = jax_gemm("a71", "b72", -0.5, beta, "c73")
    for nd in (1, 4, 8):
        same_bits(one(worlds, nd, f"gemm_ab{beta}"), want, f"rows nd={nd}")
        same_bits(one(worlds, nd, f"gemm_k_ab{beta}"), want, f"k nd={nd}")
    same_bits(one(worlds, 8, f"gemm2d_ab{beta}"), want, "2-D (2, 4)")


@pytest.mark.parametrize("uplo,trans,diag", TRSV_FORMS)
def test_extrsv_sharded_mesh_invariance(worlds, uplo, trans, diag):
    """The sharded wavefront solve gives the single-device spec solve's
    bits in worlds of 1, 2, 4 and 8."""
    form = (uplo, trans, diag)
    want = jax_trsv(form)
    for nd in (1, 2, 4, 8):
        same_bits(one(worlds, nd, "trsv" + "".join(form)), want, f"nd={nd}")


def test_extrsv_sharded_zero_diag_inf(worlds):
    """A zero diagonal: the Inf/NaN chain matches the single-device bits."""
    a, b = data()["tz"]
    same_bits(one(worlds, 4, "trsv_zero_diag"),
              xb.extrsv("L", "N", "N", a, b, impl="xla"))


@pytest.mark.parametrize("shape", GEMM_2D_SHAPES)
def test_exgemm_sharded_2d_mesh_shape_invariance(worlds, shape):
    same_bits(one(worlds, 8, f"gemm2d{shape}"), jax_gemm("a67", "b68", 1.0),
              f"{shape}")


@pytest.mark.parametrize("nd", [1, 2, 8])
def test_exgemm_sharded_k_mesh_invariance(worlds, nd):
    """k sharding: the exact limb all_reduce merges the k slices; the
    world size must not change a bit."""
    same_bits(one(worlds, nd, "gemm_k"), jax_gemm("a69", "b70", 1.0),
              f"nd={nd}")


@pytest.mark.parametrize("nd", [1, 2, 4])
def test_exgemv_sharded_rows_auto_path(worlds, nd):
    """Row sharding through the single-device dispatch (the plain B8, then
    B9 at its rung) a rank: the bits of the exact path."""
    same_bits(one(worlds, nd, "gemv_auto"), jax_gemv("ga71", "gx72", 2.0),
              f"nd={nd}")


@pytest.mark.parametrize("shape", GEMV_2D_SHAPES)
def test_exgemv_sharded_2d_mesh_shape_invariance(worlds, shape):
    same_bits(one(worlds, shape[0] * shape[1], f"gemv2d{shape}"),
              jax_gemv("a65", "x66", 1.5), f"{shape}")


# --- test_mesh_scale.py ----------------------------------------------------

def test_mesh_invariance_8_ranks(worlds):
    """The JAX test's 32/64-device checks at 8 ranks: the same bits as one
    rank and as the oracle, uneven shards included, and specials across
    shards."""
    d = data()
    for key, want in (("s71", exact_sum(d["s71"])),
                      ("s72", exact_sum(d["s72"])),
                      ("s73", exact_dot(d["s73"], d["s74"]))):
        same_bits(one(worlds, 8, key), one(worlds, 1, key), key)
        same_bits(one(worlds, 8, key), want, key)
    assert _f(one(worlds, 8, "s_inf")) == np.inf


# --- fault classes ---------------------------------------------------------

@pytest.mark.parametrize("nd", [4, 8])
def test_sharded_sum_fault_classes(worlds, nd):
    """A negative total, parts cancelling to +0, -0.0 alone (empty shards
    at 8), +Inf and -Inf on two ranks, a NaN payload, +Inf on two ranks,
    and n below the world size: every one the oracle's bits, NaN the
    canonical quiet NaN."""
    d = data()
    for key in ("f_neg", "f_cancel", "f_negzero", "f_small"):
        same_bits(one(worlds, nd, key), exact_sum(d[key]), key)
    assert u64(one(worlds, nd, "f_cancel")) == 0, "+0.0, not -0.0"
    assert u64(one(worlds, nd, "f_negzero")) == 0
    assert u64(one(worlds, nd, "f_pm_inf")) == QNAN
    assert u64(one(worlds, nd, "f_nan")) == QNAN
    same_bits(one(worlds, nd, "f_inf2"), exact_sum_with_specials(d["f_inf2"]))
    assert u64(one(worlds, nd, "f_zero_inf")) == QNAN, "0 * Inf on a rank"


def test_sharded_dot_shorter_than_world(worlds):
    small = data()["f_small"]
    same_bits(one(worlds, 8, "f_dot_small"), exact_dot(small, small))


@pytest.mark.parametrize("nd", [3, 8])
def test_sharded_uneven_and_empty_shards(worlds, nd):
    """Uneven m, k and n, with shards of no rows or columns at 8 ranks:
    the exact oracles' bits, and the same from every sharding."""
    d = data()
    want = _oracle_gemv("N", -1.25, d["u_a"], d["u_x"], 0.5, d["u_y"])
    for shard in ("rows", "k"):
        assert_same_bits_arr(_f(one(worlds, nd, f"u_gemv_{shard}")), want,
                             shard)
    want = _oracle_gemm(3.0, d["u_ga"], d["u_gb"], 1.0, d["u_gc"])
    for key in ("u_gemm", "u_gemm_k"):
        assert_same_bits_arr(_f(one(worlds, nd, key)), want, key)
    t, b = d["u_t"]
    assert_same_bits_arr(_f(one(worlds, nd, "u_trsv")),
                         _oracle_trsv_lower(t, b, unit=False), "trsv")
    if nd == 8:
        assert_same_bits_arr(
            _f(one(worlds, 8, "u_gemv_2d")),
            _oracle_gemv("N", -1.25, d["u_a"], d["u_x"], 0.5, d["u_y"]),
            "gemv 2-D")
        assert_same_bits_arr(_f(one(worlds, 8, "u_gemm_2d")),
                             _oracle_gemm(3.0, d["u_ga"], d["u_gb"], 1.0,
                                          d["u_gc"]), "gemm 2-D")


def test_every_rank_returns_the_same_bits(worlds):
    for w, ranks in worlds().items():
        assert len(ranks) == w
        for key in ranks[0]:
            if key != "ranks":   # each rank's own index
                one(worlds, w, key)


# --- errors ----------------------------------------------------------------

def test_make_mesh_needs_a_process_group():
    from exblas_tpu_torch import parallel as xp

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        xp.make_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        xp.make_mesh_2d((1, 1), device_type="cpu")


def test_make_mesh_rejects_another_size(worlds):
    for w in WORLDS:
        assert one(worlds, w, "make_mesh_error").startswith(
            f"ValueError: make_mesh: n_devices={w + 1}, but the world has "
            f"{w} ranks")


@pytest.mark.parametrize("key,name,args,message",
                         [e + (m,) for e, m in zip(ENTRY_ERRORS, (
                             "exdot_sharded: 3 vs 4 elements",
                             "extrsv_sharded: a must be (3, 3)"))],
                         ids=[e[0] for e in ENTRY_ERRORS])
def test_sharded_entries_reject_bad_shapes(worlds, key, name, args,
                                           message):
    assert one(worlds, 2, key) == f"ValueError: {message}"
