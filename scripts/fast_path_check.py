#!/usr/bin/env python3
"""A short first check of the fast-path kernels B11, B12 and B3 on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 scripts/fast_path_check.py

It prints each fast-path source's register, shared-memory and spill
figures (``nvcc -Xptxas -v``), builds the kernels, holds B11
(``sum_flat_cuda``, windows of 96, 128 and 160 bits) and B12
(``dot_flat_cuda``) against their plain versions at n = 2^24 on lognormal
data at the exact anchor, 8 bits above it and one bit below it (terms,
flags, and the bits of their one-launch window passes against the plain
bits and the two-launch path, as ``chip_smoke.py`` does), and B3
(``round_scaled_terms_cuda``) on 300 random term vectors, checks the
public ladders against the exact kernels, and times the kernels, the
exact kernels, the public calls and the float64 controls with CUDA
events.  It stops at the first disagreement.  ``chip_smoke.py`` is the
full check; this is the quick one for a new kernel's first build.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import exblas_tpu_torch as xt  # noqa: E402
from exblas_tpu_torch.ops.exdot import _exdot_bits_mxu_auto  # noqa: E402
from exblas_tpu_torch.ops.exsum import _exsum_bits_mxu_auto  # noqa: E402
from exblas_tpu_torch.ops.kernels import _build  # noqa: E402
from exblas_tpu_torch.ops.kernels import dot_kernel as dk  # noqa: E402
from exblas_tpu_torch.ops.kernels import dot_mxu as dm  # noqa: E402
from exblas_tpu_torch.ops.kernels import round_in_kernel as rk  # noqa: E402
from exblas_tpu_torch.ops.kernels import sum_kernel as sk  # noqa: E402
from exblas_tpu_torch.ops.kernels import sum_mxu as sm  # noqa: E402


def cuda_ms(fn, inner: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(inner):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / inner


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fast_path_check: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    out = Path(_build.BUILD_DIR)
    out.mkdir(parents=True, exist_ok=True)
    for src in ("sum_mxu.cu", "dot_mxu.cu", "round_terms.cu"):
        r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                            "-Xptxas", "-v", "-c", "-o",
                            str(out / f"ptxas_{src}.o"),
                            str(_build.CSRC / src)],
                           capture_output=True, text=True)
        print(src, r.returncode, r.stderr, flush=True)
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    print(f"build seconds {time.perf_counter() - t0:.2f}")

    n = 1 << 24
    x = torch.from_numpy(xt.init_lognormal(n, 1.0, 2.0, seed=10)).cuda()
    a = torch.from_numpy(xt.init_lognormal(n, 1.0, 2.0, seed=11)).cuda()
    b = torch.from_numpy(xt.init_lognormal(n, 1.0, 2.0, seed=12)).cuda()
    e = sm.exact_anchor(x)
    for nwa in (3, 4, 5):
        for de in (0, 8, -1):
            err, _, bad = cs.sum_window_pass(x, e + de, nwa)
            print("B11", nwa, de, bool(bad), err == 0, flush=True)
            assert err == 0
    ea, eb = sm.exact_anchor(a), sm.exact_anchor(b)
    for da, db in ((0, 0), (8, 8), (-1, 0)):
        err, _, bad = cs.dot_window_pass(a, b, ea + da, eb + db)
        print("B12", da, db, bool(bad), err == 0, flush=True)
        assert err == 0
    rs = np.random.RandomState(0)
    for _ in range(300):
        t = int(rs.randint(1, 129))
        vals = rs.randint(-(1 << 52) + 1, 1 << 52, t, dtype=np.int64)
        pos = tuple(int(p) for p in rs.randint(0, 400, t))
        eadj = int(rs.randint(-1300, 1100))
        v = torch.from_numpy(vals)
        got = int(rk.round_scaled_terms_cuda(
            v.cuda(), pos, torch.tensor(eadj, dtype=torch.int32).cuda()))
        assert got == int(rk.round_scaled_terms_torch(v, pos, eadj))
    print("B3: 300 vectors equal")
    assert int(xt.exsum_bits(x)) == int(sk.exsum_bits_cuda(x))
    assert int(xt.exdot_bits(a, b)) == int(dk.exdot_bits_cuda(a, b))
    print("ladders", _exsum_bits_mxu_auto.route, _exdot_bits_mxu_auto.route,
          "equal to B2b/B4b")
    for nwa in (3, 4, 5):
        print(f"B11 nwa={nwa} {cuda_ms(lambda: sm.sum_flat_cuda(x, e, nwa))}"
              " ms")
    print(f"B12 {cuda_ms(lambda: dm.dot_flat_cuda(a, b, ea, eb))} ms")
    print(f"B2b {cuda_ms(lambda: sk.exsum_bits_cuda(x))} ms, B4b "
          f"{cuda_ms(lambda: dk.exdot_bits_cuda(a, b))} ms")
    print(f"public sum {cuda_ms(lambda: xt.exsum_bits(x))} ms, public dot "
          f"{cuda_ms(lambda: xt.exdot_bits(a, b))} ms")
    print(f"torch.sum {cuda_ms(lambda: torch.sum(x))} ms, torch.dot "
          f"{cuda_ms(lambda: torch.dot(a, b))} ms")


if __name__ == "__main__":
    main()
