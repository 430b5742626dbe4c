#!/usr/bin/env python3
"""Times public calls for this checkout and others, in turns on one GPU:
those that run on the exact dot and row kernels B4 and B7 (``--set
exact``, the default), or the anchored-window ladders (``--set
ladders``).

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 scripts/public_calls.py [--tree DIR] [--set exact|ladders]

With ``--tree DIR`` (the root of another checkout, for example an older
commit unpacked with ``git archive``) it times that tree and this one in
turns -- DIR, this, this, DIR, ``--pairs`` times -- each in a process of
its own that imports the tree's ``exblas_tpu_torch`` and builds its
kernels there.  The calls,
timed with CUDA events on data made with numpy from fixed seeds (the
``wide`` data of ``chip_smoke.py``: 300 binades, and lognormal data):

* ``exdot_bits`` at n = 2^16 and 2^19 (below the fast-path ladder: B4b
  alone) on wide and lognormal data, and at n = 2^24 on wide data (the
  ladder sends it to the exact tier, B4b);
* ``exgemv_bits`` at 8192^2, beta = 0, on a 600-binade A (no GEMV rung
  covers it: B7), and its parts alone: ``plan_gemv``, B7 and
  ``round_rows``.

With ``--set ladders``: ``exsum_bits`` and ``exdot_bits`` at n = 2^24 on
each distribution of ``chip_smoke.py``'s BLAS-1 benchmark data (the
ladders' window passes: B11 and B12; wide300 takes the exact tier).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def child(tree: Path, which: str) -> None:
    sys.path.insert(0, str(tree))
    import torch

    import exblas_tpu_torch as xt

    def ms(fn, reps: int = 7, inner: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(inner):
                fn()
            e1.record()
            torch.cuda.synchronize()
            out.append(e0.elapsed_time(e1) / inner)
        return statistics.median(out)

    res = {}
    if which == "ladders":
        sys.path.insert(0, str(HERE))
        import chip_smoke as cs

        n = cs.N_BIG
        for name, x in cs.bench_sum_data(xt, n).items():
            x = torch.from_numpy(x).cuda()
            res[f"exsum_bits n=2^24 {name}"] = ms(lambda: xt.exsum_bits(x))
        for name, (a, b) in cs.bench_dot_data(xt, n).items():
            a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
            res[f"exdot_bits n=2^24 {name}"] = ms(lambda: xt.exdot_bits(a, b))
        print(json.dumps(res), flush=True)
        return
    for n in (1 << 16, 1 << 19, 1 << 24):
        data = {"wide": (xt.init_fpuniform(n, 300, -150, seed=11),
                         xt.init_fpuniform(n, 300, -150, seed=12))}
        if n < 1 << 24:
            data["lognormal"] = (xt.init_lognormal(n, 0.0, 2.0, seed=11),
                                 xt.init_lognormal(n, 0.0, 2.0, seed=12))
        for name, (a, b) in data.items():
            a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
            res[f"exdot_bits n={n} {name}"] = ms(lambda: xt.exdot_bits(a, b))
    m = 8192
    a = torch.from_numpy(xt.init_fpuniform_matrix(m, m, 600, -300,
                                                  seed=61)).cuda()
    x = torch.from_numpy(xt.init_fpuniform(m, 10, 0, seed=2)).cuda()
    res[f"exgemv_bits {m}^2 600-binade A"] = ms(
        lambda: xt.exgemv_bits("N", 1.0, a, x), reps=5, inner=2)
    # its parts, each alone: the plan (B8, the z analysis, one host sync),
    # B7, and the rounding of the rows in PyTorch
    from exblas_tpu_torch.ops.kernels import gemv_kernel as gk

    ge = importlib.import_module("exblas_tpu_torch.ops.exgemv")

    ab, zb = a.view(torch.int64), x.view(torch.int64)
    limbs, special = gk.gemv_rows_acc_cuda(ab, zb)
    res["  plan_gemv"] = ms(
        lambda: ge.plan_gemv(ab, zb, None, 0, "zero", True), reps=5, inner=2)
    res["  B7 gemv_rows_acc_cuda"] = ms(
        lambda: gk.gemv_rows_acc_cuda(ab, zb), reps=5, inner=2)
    res["  round_rows"] = ms(lambda: ge.round_rows(limbs, special), reps=5,
                             inner=2)
    print(json.dumps(res), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=None)
    ap.add_argument("--pairs", type=int, default=1,
                    help="turns of (DIR, this, this, DIR) with --tree")
    ap.add_argument("--set", choices=("exact", "ladders"), default="exact")
    ap.add_argument("--child", type=Path, default=None)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child.resolve(), args.set)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    trees = [HERE] if args.tree is None else args.pairs * [
        args.tree.resolve(), HERE, HERE, args.tree.resolve()]
    runs = []
    for tree in trees:
        out = subprocess.run([sys.executable, __file__, "--child", str(tree),
                              "--set", args.set],
                             capture_output=True, text=True,
                             env={**os.environ, "PYTHONPATH": str(tree)})
        if out.returncode != 0:
            raise SystemExit(f"{tree}: {out.stderr[-3000:]}")
        runs.append((tree, json.loads(out.stdout.strip().splitlines()[-1])))
    for key in runs[0][1]:
        cells = ", ".join(f"{'this' if t == HERE else t.name} "
                          f"{r[key]:.4f}" for t, r in runs)
        print(f"{key}: {cells} ms [{smi}]", flush=True)


if __name__ == "__main__":
    main()
