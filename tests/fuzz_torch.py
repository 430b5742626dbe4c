"""The fuzz campaign of ``tests/fuzz.py`` in port mode: the same cases, run
through ``exblas_tpu_torch`` on the CPU or on the card, against the same
exact oracles and the same permutation checks.

Every case is drawn from (campaign_seed, case_index) in ``fuzz.run_case``'s
order, with its generators, distributions, alphas and betas, so one
(seed, index) names the same case in both modes:

    python tests/fuzz_torch.py --cases 257 --seed 20260816 --device cpu
    python tests/fuzz_torch.py --cases 257 --seed 20260816 --device cuda

The inputs are drawn by the port's generators (``exblas_tpu_torch``'s
``init_*``, bit-identical to the JAX package's, ``test_torch_core.py``),
so this mode imports no JAX.  Beside ``fuzz.py``'s checks, every ExSUM
case also runs the anchored-window ladder (the fast path above 2^20
elements) at its small n against the exact kernel, as ``fuzz.py`` runs
its MXU tier against the VPU kernel on the TPU.  A deterministic slice
runs in pytest (``test_torch_fuzz.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import fuzz  # noqa: E402  (numpy and the oracles only)
from fuzz import (  # noqa: E402
    _ALPHAS,
    _BETAS,
    DISTRIBUTIONS,
    _oracle_gemm,
    _oracle_gemv,
    _oracle_trsv_lower,
    exact_dot_with_specials,
)
from oracle import (  # noqa: E402
    assert_same_bits,
    assert_same_bits_arr,
    exact_sum_with_specials,
)


@contextlib.contextmanager
def _port_generators():
    """``fuzz.gen_vector`` reads its generators from ``import exblas_tpu``:
    for its draws, that name is the port, which exports the same
    ``init_*`` functions."""
    import exblas_tpu_torch

    saved = sys.modules.get("exblas_tpu")
    sys.modules["exblas_tpu"] = exblas_tpu_torch
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["exblas_tpu"]
        else:
            sys.modules["exblas_tpu"] = saved


def gen_vector(dist: str, n: int, rng: np.random.RandomState) -> np.ndarray:
    """``fuzz.gen_vector``, drawn with the port's generators."""
    with _port_generators():
        return fuzz.gen_vector(dist, n, rng)


def _gen_matrix(dist, m, k, rng):
    with _port_generators():
        return fuzz._gen_matrix(dist, m, k, rng)


def _sum_oracle(x):
    return (fuzz._SUM_ORACLE or exact_sum_with_specials)(x)


def _dot_oracle(a, b):
    return (fuzz._DOT_ORACLE or exact_dot_with_specials)(a, b)


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def run_case(idx: int, campaign_seed: int, device: str, max_n: int = 5000,
             big_dims: bool = False):
    """One fuzz case on ``device`` ("cpu": the plain path; "cuda": the
    kernels); raises AssertionError with full reproduction info."""
    import torch

    import exblas_tpu_torch as xt
    from exblas_tpu_torch.ops.exsum import _exsum_bits_mxu_auto

    rng = np.random.RandomState((campaign_seed * 1000003 + idx) % 2 ** 31)
    routine = ["exsum", "exsum", "exsum", "exdot", "exdot", "exdot",
               "exgemv", "exgemm", "extrsv"][int(rng.randint(9))]
    dist = DISTRIBUTIONS[int(rng.randint(len(DISTRIBUTIONS)))]
    n = int(rng.randint(1, max_n + 1))
    fpe = int(rng.randint(0, 9))
    early_exit = bool(rng.randint(2))
    if fpe == 1:
        fpe = 2  # fpe==1 is the non-reproducible control; not fuzzed
    kw = dict(fpe=fpe, early_exit=early_exit, device=device)

    label = (f"case {idx} (seed {campaign_seed}): {routine} {dist} n={n} "
             f"fpe={fpe} ee={early_exit} device={device}")
    if routine == "exsum":
        x = gen_vector(dist, n, rng)
        got = xt.exsum(x, **kw)
        assert_same_bits(got, _sum_oracle(x), label)
        # the anchored ladder at this n, against the exact kernel
        got_l = xt.core.rounding.bits_to_float(_exsum_bits_mxu_auto(
            torch.from_numpy(x).to(device), device == "cuda"))
        assert_same_bits(got_l, got, label + " [ladder-vs-exact]")
        p = rng.permutation(n)
        got_p = xt.exsum(x[p], **kw)
        assert_same_bits(got_p, got, label + " [permuted]")
    elif routine == "exdot":
        a = gen_vector(dist, n, rng)
        b_dist = (dist if rng.rand() < 1 / 3 else
                  DISTRIBUTIONS[int(rng.randint(len(DISTRIBUTIONS)))])
        b = gen_vector(b_dist, n, rng)
        got = xt.exdot(a, b, **kw)
        assert_same_bits(got, _dot_oracle(a, b), label)
        p = rng.permutation(n)
        got_p = xt.exdot(a[p], b[p], **kw)
        assert_same_bits(got_p, got, label + " [permuted]")
    elif routine == "exgemv":
        m = int(rng.randint(1, 65))
        k = int(rng.randint(1, 97))
        if big_dims:   # extra draws only in big mode: old seeds replay
            m *= int(rng.randint(2, 9))
            k *= int(rng.randint(2, 17))
        trans = ["N", "T"][int(rng.randint(2))]
        alpha = _ALPHAS[int(rng.randint(len(_ALPHAS)))]
        beta = _BETAS[int(rng.randint(len(_BETAS)))]
        a = _gen_matrix(dist, m, k, rng)
        x_dist = (dist if rng.rand() < 1 / 3 else
                  DISTRIBUTIONS[int(rng.randint(len(DISTRIBUTIONS)))])
        xv = gen_vector(x_dist, m if trans == "T" else k, rng)
        out_len = k if trans == "T" else m
        y = (gen_vector("fpuniform_large", out_len, rng)
             if beta != 0.0 else None)
        label = (f"case {idx} (seed {campaign_seed}): exgemv {dist} "
                 f"{trans} {m}x{k} alpha={alpha} beta={beta} fpe={fpe} "
                 f"device={device}")
        got = _np(xt.exgemv(trans, alpha, a, xv, beta=beta, y=y, **kw))
        assert_same_bits_arr(got, _oracle_gemv(trans, alpha, a, xv, beta, y),
                             label)
        kk = m if trans == "T" else k
        p = rng.permutation(kk)
        ap = a[p, :] if trans == "T" else a[:, p]
        got_p = _np(xt.exgemv(trans, alpha, ap, xv[p], beta=beta, y=y, **kw))
        assert_same_bits_arr(got_p, got, label + " [k-permuted]")
    elif routine == "exgemm":
        m = int(rng.randint(1, 33))
        k = int(rng.randint(1, 49))
        nn = int(rng.randint(1, 33))
        if big_dims:
            m *= int(rng.randint(2, 9))
            k *= int(rng.randint(2, 33))
            nn *= int(rng.randint(2, 9))
        alpha = _ALPHAS[int(rng.randint(len(_ALPHAS)))]
        beta = _BETAS[int(rng.randint(len(_BETAS)))]
        a = _gen_matrix(dist, m, k, rng)
        b_dist = (dist if rng.rand() < 1 / 3 else
                  DISTRIBUTIONS[int(rng.randint(len(DISTRIBUTIONS)))])
        b = _gen_matrix(b_dist, k, nn, rng)
        c = (_gen_matrix("fpuniform_large", m, nn, rng)
             if beta != 0.0 else None)
        label = (f"case {idx} (seed {campaign_seed}): exgemm {dist} "
                 f"{m}x{k}x{nn} alpha={alpha} beta={beta} device={device}")
        got = _np(xt.exgemm("N", "N", alpha, a, b, beta=beta, c=c, **kw))
        assert_same_bits_arr(got, _oracle_gemm(alpha, a, b, beta, c), label)
        p = rng.permutation(k)
        got_p = _np(xt.exgemm("N", "N", alpha, a[:, p], b[p, :], beta=beta,
                              c=c, **kw))
        assert_same_bits_arr(got_p, got, label + " [k-permuted]")
    else:  # extrsv: finite data, nonzero diagonal, bounded growth
        safe = {"special_laced": "fpuniform_std",
                "subnormal_heavy": "fpuniform_std",
                "fpuniform_full": "fpuniform_large",
                "fpuniform_wide": "fpuniform_large"}
        tdist = safe.get(dist, dist)
        nt = int(rng.randint(1, 97))
        uplo = ["L", "U"][int(rng.randint(2))]
        diag = ["N", "U"][int(rng.randint(2))]
        trans = ["N", "T"][int(rng.randint(2))]
        m0 = _gen_matrix(tdist, nt, nt, rng)
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
        label = (f"case {idx} (seed {campaign_seed}): extrsv {tdist} "
                 f"{uplo}{trans}{diag} n={nt} fpe={fpe} device={device}")
        got = _np(xt.extrsv(uplo, trans, diag, a, b, **kw))
        ae = a if trans == "N" else a.T
        ue = uplo if trans == "N" else ("U" if uplo == "L" else "L")
        if ue == "L":
            want = _oracle_trsv_lower(ae, b, unit=(diag == "U"))
        else:
            want = _oracle_trsv_lower(ae[::-1, ::-1], b[::-1],
                                      unit=(diag == "U"))[::-1]
        assert_same_bits_arr(got, want, label)
        fpe2 = 2 if fpe >= 5 else 8
        got_v = _np(xt.extrsv(uplo, trans, diag, a, b, fpe=fpe2,
                              early_exit=not early_exit, device=device))
        assert_same_bits_arr(got_v, got, label + f" [variant fpe={fpe2}]")
    return label


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cases", type=int, default=257)
    ap.add_argument("--seed", type=int, default=20260816)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="cpu: the plain path; cuda: the kernels")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--max-n", type=int, default=5000)
    ap.add_argument("--big-dims", action="store_true",
                    help="scale GEMV/GEMM dims up to ~512x1536 / 256x1536x256")
    args = ap.parse_args()
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("fuzz_torch: --device cuda needs a CUDA device")
        print(f"device {torch.cuda.get_device_name(0)}", flush=True)

    failures = 0
    for idx in range(args.start, args.start + args.cases):
        try:
            label = run_case(idx, args.seed, args.device, args.max_n,
                             big_dims=args.big_dims)
            print(f"PASS {label}", flush=True)
        except AssertionError as e:
            failures += 1
            print(f"FAIL {e}", flush=True)
    print(f"\n{args.cases} cases, {failures} failures "
          f"(seed {args.seed}, device {args.device}"
          + (", big-dims" if args.big_dims else "") + ")")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
