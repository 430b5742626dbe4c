"""The mesh-invariance fuzzer of ``tests/fuzz_mesh.py`` in port mode: the
same cases, run through ``exblas_tpu_torch.parallel`` in Gloo worlds of
CPU processes.

Every case is drawn from (campaign_seed, case_index, the largest world) in
``fuzz_mesh.run_case``'s order -- routine, distribution, world sizes, 2-D
factorizations, data, permutations -- so one (seed, index, --devices)
names the same case in both modes:

    python tests/fuzz_mesh_torch.py --cases 100 --seed 20260825 --devices 8

This process draws every case first (it imports ``fuzz_mesh``, and with it
JAX, for ``_mesh_sizes`` and ``_factor_2d``), groups each decomposition's
call by world size, and spawns one world a size (``tests/torch_dist.py``;
the children import only torch, numpy and the port).  Then it checks that
every decomposition of a case gives the same bits on every rank, and that
the bits are the oracle's (sum, dot) or those of the JAX package's
single-device entry with ``impl="xla"`` (gemv, gemm, trsv, as
``fuzz_mesh.py`` anchors the solve; ``_jax_anchor``), which the port's single-device entry must
also give; and a random global permutation (sum, dot) or k-permutation
(gemv, gemm) must not change them.  A deterministic
slice runs in pytest (``test_torch_fuzz.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_dist  # noqa: E402
from fuzz import DISTRIBUTIONS  # noqa: E402
from fuzz_torch import _dot_oracle, _sum_oracle, gen_vector  # noqa: E402


def _bits(x) -> np.ndarray:
    return np.asarray(x).reshape(-1).view(np.uint64)


def _padded(v, shape) -> np.ndarray:
    out = np.zeros(shape)
    out[tuple(slice(0, d) for d in np.shape(v))] = v
    return out


def _jax_anchor(routine, *args, **kwargs) -> np.ndarray:
    """The JAX package's single-device ``impl="xla"`` result, computed on
    the operands zero-padded to the largest shape the fuzzer draws (GEMV
    (96, 128), GEMM (48, 64) x (64, 48), TRSV 64 with the identity
    extension), so JAX compiles once a configuration instead of once a
    case.  Zero rows and columns deposit nothing into the real entries and
    the extension's x is +0.0, so the real entries' bits are the unpadded
    call's."""
    import exblas_tpu as xb

    if routine == "exgemv":
        alpha, a, x = args
        m = a.shape[0]
        if kwargs.get("y") is not None:
            kwargs["y"] = _padded(kwargs["y"], (96,))
        return xb.exgemv("N", alpha, _padded(a, (96, 128)),
                         _padded(x, (128,)), impl="xla", **kwargs)[:m]
    if routine == "exgemm":
        alpha, a, b = args
        m, n = a.shape[0], b.shape[1]
        if kwargs.get("c") is not None:
            kwargs["c"] = _padded(kwargs["c"], (48, 48))
        return xb.exgemm("N", "N", alpha, _padded(a, (48, 64)),
                         _padded(b, (64, 48)), impl="xla",
                         **kwargs)[:m, :n]
    uplo, trans, diag, a, b = args
    n = b.shape[0]
    t = _padded(a, (64, 64))
    t[np.arange(n, 64), np.arange(n, 64)] = 1.0
    return xb.extrsv(uplo, trans, diag, t, _padded(b, (64,)),
                     impl="xla")[:n]


class Case:
    """One drawn case: its label, the calls it gives each world size, and
    the checks on their results (``self.checks``: functions of a lookup
    ``get(world, name)`` that raise AssertionError)."""

    def __init__(self, idx: int, label: str):
        self.idx, self.label = idx, label
        self.calls, self.checks = {}, []

    def call(self, world, name, entry, *args, mesh=("1d",), **kwargs):
        self.calls.setdefault(world, []).append(dict(
            key=(self.idx, name), entry=entry, args=args, kwargs=kwargs,
            mesh=mesh))
        return (world, name)

    def check(self, fn):
        self.checks.append(fn)


def draw_case(idx: int, campaign_seed: int, nd_max: int) -> Case:
    """``fuzz_mesh.run_case``'s draws, in its order, as calls and checks."""
    import exblas_tpu_torch as xt
    from fuzz_mesh import _factor_2d, _mesh_sizes

    rng = np.random.RandomState((campaign_seed * 999983 + idx) % 2 ** 31)
    routine = ["exsum", "exsum", "exdot", "exdot",
               "exgemv", "exgemm", "extrsv"][int(rng.randint(7))]
    dist = DISTRIBUTIONS[int(rng.randint(len(DISTRIBUTIONS)))]
    meshes = _mesh_sizes(rng, nd_max, k=int(rng.randint(2, 5)))
    case = Case(idx, f"case {idx} (seed {campaign_seed}): {routine} {dist} "
                     f"meshes={meshes}")
    label = case.label

    def equal(refs, what, want=None, port=None):
        """Every result in ``refs`` has the same bits (and ``want``'s, which
        the port's single-device result ``port`` must also have)."""
        def check(get):
            if port is not None:
                assert (_bits(port) == _bits(want)).all(), (
                    f"{label}: {what}: the port's single-device entry "
                    f"differs from JAX's")
            res = [_bits(get(*r)) for r in refs]
            first = res[0] if want is None else _bits(want)
            for r, got in zip(refs, res):
                assert got.shape == first.shape and (got == first).all(), (
                    f"{label}: {what}: world {r[0]} {r[1]} differs")
        case.check(check)

    if routine == "exsum":
        n = int(rng.randint(1, 20001))
        x = gen_vector(dist, n, rng)
        refs = [case.call(nd, f"sum{nd}", "exsum_sharded", x)
                for nd in meshes]
        p = rng.permutation(n)
        refs.append(case.call(meshes[-1], "sum_p", "exsum_sharded", x[p]))
        equal(refs, "the oracle's bits", np.float64(_sum_oracle(x)))
        case.label += f" n={n}"
    elif routine == "exdot":
        n = int(rng.randint(1, 12001))
        a = gen_vector(dist, n, rng)
        b_dist = (dist if rng.rand() < 1 / 3 else
                  DISTRIBUTIONS[int(rng.randint(len(DISTRIBUTIONS)))])
        b = gen_vector(b_dist, n, rng)
        refs = [case.call(nd, f"dot{nd}", "exdot_sharded", a, b)
                for nd in meshes]
        p = rng.permutation(n)
        refs.append(case.call(meshes[-1], "dot_p", "exdot_sharded", a[p],
                              b[p]))
        equal(refs, "the oracle's bits", np.float64(_dot_oracle(a, b)))
        case.label += f" n={n}"
    elif routine == "extrsv":
        safe = {"special_laced": "fpuniform_std",
                "subnormal_heavy": "fpuniform_std",
                "fpuniform_full": "fpuniform_large"}
        tdist = safe.get(dist, dist)
        nt = int(rng.randint(1, 65))
        uplo = ["L", "U"][int(rng.randint(2))]
        diag = ["N", "U"][int(rng.randint(2))]
        trans = ["N", "T"][int(rng.randint(2))]
        m0 = gen_vector(tdist, nt * nt, rng).reshape(nt, nt)
        a = np.tril(m0) if uplo == "L" else np.triu(m0)
        idxd = np.arange(nt)
        a[idxd, idxd] = 0.0
        off_max = float(np.max(np.abs(a))) if nt > 1 else 0.0
        if off_max > 0.0:
            s = 2.0 ** -max(0, int(np.ceil(np.log2(off_max * nt * 4))))
            a *= s
        a[idxd, idxd] = (gen_vector("fpuniform_std", nt, rng) + 1.0) * (
            np.where(rng.rand(nt) < 0.5, -1.0, 1.0))
        b = gen_vector(tdist, nt, rng)
        refs = [case.call(nd, f"trsv{nd}", "extrsv_sharded", uplo, trans,
                          diag, a, b) for nd in meshes]
        equal(refs, "the single-device extrsv's bits",
              _jax_anchor("extrsv", uplo, trans, diag, a, b),
              xt.extrsv_bits(uplo, trans, diag, a, b, device="cpu"))
        case.label += f" {uplo}{trans}{diag} n={nt}"
    elif routine == "exgemv":
        m = int(rng.randint(1, 97))
        k = int(rng.randint(1, 129))
        alpha = [1.0, -0.5, 3.7][int(rng.randint(3))]
        a = gen_vector(dist, m * k, rng).reshape(m, k)
        xv = gen_vector(dist, k, rng)
        refs = []
        for nd in meshes:
            refs.append(case.call(nd, f"rows{nd}", "exgemv_sharded", a, xv,
                                  alpha, shard="rows"))
            refs.append(case.call(nd, f"k{nd}", "exgemv_sharded", a, xv,
                                  alpha, shard="k"))
            pq = _factor_2d(rng, nd)
            refs.append(case.call(nd, f"2d{nd}", "exgemv_sharded_2d", a, xv,
                                  alpha, mesh=("2d", pq, ("rows", "k"))))
        p = rng.permutation(k)
        refs.append(case.call(meshes[-1], "rows_p", "exgemv_sharded",
                              a[:, p], xv[p], alpha, shard="rows"))
        equal(refs, "rows/k/2-D and k-permuted: the single-device bits",
              _jax_anchor("exgemv", alpha, a, xv),
              xt.exgemv_bits("N", alpha, a, xv, device="cpu"))
        beta = [1.0, -2.25][int(rng.randint(2))]
        yv = gen_vector("fpuniform_large", m, rng)
        kw = dict(alpha=alpha, beta=beta, y=yv)
        nd = meshes[-1]
        rb = [case.call(nd, f"beta_{s}", "exgemv_sharded", a, xv, shard=s,
                        **kw) for s in ("rows", "k")]
        rb.append(case.call(nd, "beta_2d", "exgemv_sharded_2d", a, xv,
                            mesh=("2d", _factor_2d(rng, nd), ("rows", "k")),
                            **kw))
        rb.append(case.call(1, "beta_rows1", "exgemv_sharded", a, xv,
                            shard="rows", **kw))
        equal(rb, f"beta={beta}: the single-device bits",
              _jax_anchor("exgemv", alpha, a, xv, beta=beta, y=yv),
              xt.exgemv_bits("N", alpha, a, xv, beta=beta, y=yv,
                             device="cpu"))
        shard_t = ["rows", "k"][int(rng.randint(2))]
        x_t = gen_vector(dist, m, rng)
        rt = [case.call(nd, "trans_t", "exgemv_sharded", a, x_t, alpha,
                        shard=shard_t, trans="T"),
              case.call(nd, "trans_n", "exgemv_sharded",
                        np.ascontiguousarray(a.T), x_t, alpha,
                        shard=shard_t)]
        equal(rt, "trans=T: the pre-transposed matrix's bits")
        case.label += f" {m}x{k} alpha={alpha} beta={beta} +T"
    else:  # exgemm
        m = int(rng.randint(1, 49))
        k = int(rng.randint(1, 65))
        n2 = int(rng.randint(1, 49))
        a = gen_vector(dist, m * k, rng).reshape(m, k)
        b_dist = (dist if rng.rand() < 1 / 3 else
                  DISTRIBUTIONS[int(rng.randint(len(DISTRIBUTIONS)))])
        b = gen_vector(b_dist, k * n2, rng).reshape(k, n2)
        refs = []
        for nd in meshes:
            refs.append(case.call(nd, f"rows{nd}", "exgemm_sharded", a, b))
            pq = _factor_2d(rng, nd)
            refs.append(case.call(nd, f"2d{nd}", "exgemm_sharded_2d", a, b,
                                  mesh=("2d", pq, ("rows", "cols"))))
            refs.append(case.call(nd, f"k{nd}", "exgemm_sharded_k", a, b))
        p = rng.permutation(k)
        refs.append(case.call(meshes[-1], "rows_p", "exgemm_sharded",
                              a[:, p], b[p, :]))
        equal(refs, "rows/2-D/k and k-permuted: the single-device bits",
              _jax_anchor("exgemm", 1.0, a, b, beta=0.0),
              xt.exgemm_bits("N", "N", 1.0, a, b, beta=0.0, device="cpu"))
        alpha = [1.0, -0.5][int(rng.randint(2))]
        beta = [1.0, 3.25][int(rng.randint(2))]
        cm = gen_vector("fpuniform_large", m * n2, rng).reshape(m, n2)
        kw = dict(alpha=alpha, beta=beta, c=cm)
        nd = meshes[-1]
        rb = [case.call(nd, "beta_rows", "exgemm_sharded", a, b, **kw),
              case.call(nd, "beta_k", "exgemm_sharded_k", a, b, **kw),
              case.call(nd, "beta_2d", "exgemm_sharded_2d", a, b,
                        mesh=("2d", _factor_2d(rng, nd), ("rows", "cols")),
                        **kw),
              case.call(1, "beta_rows1", "exgemm_sharded", a, b, **kw)]
        equal(rb, f"alpha={alpha} beta={beta}: the single-device bits",
              _jax_anchor("exgemm", alpha, a, b, beta=beta, c=cm),
              xt.exgemm_bits("N", "N", alpha, a, b, beta=beta, c=cm,
                             device="cpu"))
        ta = ["N", "T"][int(rng.randint(2))]
        tb = "T" if ta == "N" else ["N", "T"][int(rng.randint(2))]
        a_t = np.ascontiguousarray(a.T) if ta == "T" else a
        b_t = np.ascontiguousarray(b.T) if tb == "T" else b
        rt = [case.call(nd, "trans", "exgemm_sharded", a_t, b_t, transa=ta,
                        transb=tb), (nd, f"rows{nd}")]
        equal(rt, f"transa={ta} transb={tb}: the untransposed bits")
        case.label += f" {m}x{k}x{n2} alpha={alpha} beta={beta} +{ta}{tb}"
    return case


def run_cases(indices, campaign_seed: int, nd_max: int,
              rendezvous_dir: str) -> list:
    """Draw the cases, run every world once, check -> one (label, failure
    message or None) a case."""
    cases = [draw_case(i, campaign_seed, nd_max) for i in indices]
    jobs = {}
    for case in cases:
        for world, calls in case.calls.items():
            jobs.setdefault(world, []).extend(calls)
    results = torch_dist.spawn_worlds(
        torch_dist.run_calls, {w: ("cpu", calls) for w, calls in jobs.items()},
        rendezvous_dir=rendezvous_dir)
    out = []
    for case in cases:
        def get(world, name, idx=case.idx):
            ranks = results[world]
            first = ranks[0][(idx, name)]
            for r, res in enumerate(ranks[1:], 1):
                assert np.array_equal(res[(idx, name)], first), (
                    f"{case.label}: world {world} {name}: rank {r} differs "
                    f"from rank 0")
            return first
        try:
            for check in case.checks:
                check(get)
            out.append((case.label, None))
        except AssertionError as e:
            out.append((case.label, str(e)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cases", type=int, default=100)
    ap.add_argument("--seed", type=int, default=20260825)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--devices", type=int, default=8,
                    help="the largest world (CPU processes) a case draws")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        results = run_cases(range(args.start, args.start + args.cases),
                            args.seed, args.devices, tmp)
    failures = 0
    for label, failure in results:
        if failure is None:
            print(f"PASS {label}", flush=True)
        else:
            failures += 1
            print(f"FAIL {failure}", flush=True)
    print(f"\n{args.cases} cases, {failures} failures (seed {args.seed}, "
          f"worlds of up to {args.devices} ranks)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
