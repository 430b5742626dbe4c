#!/usr/bin/env python3
"""Side-by-side builds of the int8 kernels' tuning choices on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 scripts/mxu_variants.py

It compiles a copy of ``csrc/gemm_mxu.cu`` for each class-window
partition of the rung (8, 8) GEMM kernel (its ``kWin``), for each window
width of the rungs (8, 12) to (16, 16) (``wgw::kWidth``), and of
``csrc/gemv_mxu.cu`` for each warp and stage count of the rung (2, 2) GEMV
kernel (its ``kWarps``, ``kStages``), each into a library of its own under
``build/variants/``, and prints ptxas' spill line for each.  Every variant
must give the bits of the default build: B6 on a few shapes against
``gemm_bits_mxu_torch`` and at n = 4096 against the default kernel (the
benchmark data at (8, 8), exponents in [0, 50) at (16, 16)), B9's class
sums at 8192^2 against the default kernel's, with the widening every 64 k
too.  Then it times the variants with CUDA events in turns (the list, then
the list reversed) on the same card.  ``--only gemm,wide,gemv`` picks the
sets to run.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import exblas_tpu_torch as xt  # noqa: E402
from exblas_tpu_torch.ops.exgemm import plan_gemm  # noqa: E402
from exblas_tpu_torch.ops.exgemv import plan_gemv  # noqa: E402
from exblas_tpu_torch.ops.kernels import _build  # noqa: E402
from exblas_tpu_torch.ops.kernels import gemm_mxu as gm  # noqa: E402
from exblas_tpu_torch.ops.kernels import gemv_mxu as vm  # noqa: E402

OUT = _build.BUILD_DIR.parent / "variants"
# the class windows' cuts (0, ..., 17)
GEMM_WINDOWS = ((0, 4, 12, 17), (0, 4, 13, 17), (0, 3, 11, 17),
                (0, 5, 12, 17), (0, 6, 12, 17), (0, 9, 17))
# the window widths of the wide rungs' kernel (wgw::kWidth)
WIDE_WIDTHS = (4, 5, 8)
# (warps, stages)
GEMV_SHAPES = ((12, 3), (8, 4), (10, 4), (12, 4))
ONE = int(np.float64(1.0).view(np.int64))


def build(src: str, edits: dict, key: str = "", entry: str = ""):
    """(the entry point, ptxas' spill lines) of a copy of ``src`` with the
    lines ``edits`` maps replaced, built into a library of its own; the
    spill lines of the kernels whose names hold ``key``."""
    text = (_build.CSRC / f"{src}.cu").read_text()
    for old, new in edits.items():
        if old not in text:
            raise RuntimeError(f"{src}.cu has no line {old!r}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    tag = "_".join("".join(c for c in v if c.isdigit() or c == ",")
                   .replace(",", "-") for v in edits.values())
    copy = OUT / f"{src}_{tag}.cu"
    copy.write_text(text)
    lib = copy.with_suffix(".so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v",
           f"-I{_build.CSRC}", "-shared", "-o", str(lib), str(copy)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{copy.name}: {proc.stderr[-3000:]}")
    lines = proc.stderr.splitlines()
    key = key or ("gemm88" if src == "gemm_mxu" else "3v22")
    spills = [lines[i + 2].strip() for i, line in enumerate(lines)
              if "Compiling entry" in line and key in line]
    entry = entry or ("mxu_gemm88_cuda" if src == "gemm_mxu"
                      else "gemv_mxu_classes_cuda")
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.argtypes = _build.SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return fn, spills


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def gemm88(fn, ops, c_bits, mode: int, beta: int) -> torch.Tensor:
    """gemm_mxu.py's rung (8, 8) launches through the entry ``fn``."""
    out = torch.empty((ops.m, ops.n), dtype=torch.int64, device="cuda")
    gm._wg_launches(fn, (), ops, c_bits, mode, beta, out)
    return out


def mat(m, n, seed, binades=10, signed=True):
    """Bits of doubles with exponents in [0, binades)."""
    rs = np.random.RandomState(seed)
    x = (1.0 + rs.rand(m, n)) * np.exp2(rs.randint(0, binades, size=(m, n)))
    if signed:
        x *= np.where(rs.rand(m, n) < 0.5, -1.0, 1.0)
    return torch.from_numpy(x).cuda().view(torch.int64)


def gemm_variants() -> None:
    def windows(cuts):
        sizes = tuple(b - a for a, b in zip(cuts, cuts[1:]))
        text = ", ".join(map(str, cuts[:-1])) + ", kCls"
        return str(sizes), {"constexpr int kWin[] = {0, 4, 12, kCls};":
                            f"constexpr int kWin[] = {{{text}}};"}

    with ThreadPoolExecutor(len(GEMM_WINDOWS)) as pool:
        built = dict(pool.map(
            lambda cuts: (windows(cuts)[0],
                          build("gemm_mxu", windows(cuts)[1])),
            GEMM_WINDOWS))
    for name, (_, spills) in built.items():
        print(f"B6 windows {name}: ptxas {spills}")
    for ci, (m, k, n) in enumerate(((1, 1, 1), (130, 300, 70),
                                    (257, 8192 + 33, 129))):
        z, b, c = mat(m, k, ci), mat(k, n, ci + 9), mat(m, n, ci + 99)
        want = gm.gemm_bits_mxu_torch(z, b, c, ONE, "one", 8, 8)
        ops = gm.mxu_operands_cuda(z, b, 8, 8)
        for name, (fn, _) in built.items():
            if not torch.equal(gemm88(fn, ops, c, 1, ONE), want):
                raise SystemExit(f"B6 windows {name} differ at {m}x{k}x{n}")
    n = 4096
    a, b, c = (torch.from_numpy(xt.init_fpuniform_matrix(n, n, 10, 0,
                                                          seed=s)).cuda()
               .view(torch.int64) for s in (1, 2, 3))
    plan = plan_gemm(a, b, c, ONE, "one")
    ref = gm.gemm_bits_mxu_cuda(a, b, c, ONE, "one", 8, 8, ea=plan.ea0,
                                fb=plan.fb0)
    ops = gm.mxu_operands_cuda(a, b, 8, 8, ea=plan.ea0, fb=plan.fb0)
    names = list(built)
    for name in names + names[::-1]:
        fn = built[name][0]
        same = torch.equal(gemm88(fn, ops, c, 1, ONE), ref)
        t = cuda_ms(lambda: gemm88(fn, ops, c, 1, ONE), 3)
        print(f"B6 class kernel n={n}, windows {name}: {t:.3f} ms, "
              f"{'==' if same else '!='} default")
        if not same:
            raise SystemExit(f"B6 windows {name} differ at n={n}")


def wide(fn, ops, c_bits, mode: int, beta: int) -> torch.Tensor:
    """gemm_mxu.py's launches of a WG_RUNGS rung through the entry ``fn``."""
    out = torch.empty((ops.m, ops.n), dtype=torch.int64, device="cuda")
    gm._wg_launches(fn, (ops.sa, ops.sb), ops, c_bits, mode, beta, out)
    return out


def wide_variants() -> None:
    def width(w):
        return (f"kWidth {w}", {"constexpr int kWidth = 4; ":
                                f"constexpr int kWidth = {w}; "})

    with ThreadPoolExecutor(len(WIDE_WIDTHS)) as pool:
        built = dict(pool.map(
            lambda w: (width(w)[0], build("gemm_mxu", width(w)[1],
                                          "wide_kernel",
                                          "mxu_gemm_wide_cuda")),
            WIDE_WIDTHS))
    for name, (_, spills) in built.items():
        print(f"B6 wide rungs, {name}: ptxas {spills}")
    for ci, (m, k, n) in enumerate(((1, 1, 1), (130, 300, 70),
                                    (257, 4096 + 33, 129))):
        for sa, sb in gm.WG_RUNGS:
            z = mat(m, k, ci, 8 * sa - 63)
            b = mat(k, n, ci + 9, 8 * sb - 63)
            c = mat(m, n, ci + 99)
            want = gm.gemm_bits_mxu_torch(z, b, c, ONE, "one", sa, sb)
            ops = gm.mxu_operands_cuda(z, b, sa, sb)
            for name, (fn, _) in built.items():
                if not torch.equal(wide(fn, ops, c, 1, ONE), want):
                    raise SystemExit(f"B6 {name} differs at ({sa}, {sb}) "
                                     f"{m}x{k}x{n}")
    n = 4096
    a, b, c = (mat(n, n, s, 50, signed=False) for s in (1, 2, 3))
    plan = plan_gemm(a, b, c, ONE, "one")
    if plan.rung != (16, 16):
        raise SystemExit(f"exponents in [0, 50) took rung {plan.rung}")
    ref = gm.gemm_bits_mxu_cuda(a, b, c, ONE, "one", 16, 16, ea=plan.ea0,
                                fb=plan.fb0)
    ops = gm.mxu_operands_cuda(a, b, 16, 16, ea=plan.ea0, fb=plan.fb0)
    names = list(built)
    for name in names + names[::-1]:
        fn = built[name][0]
        same = torch.equal(wide(fn, ops, c, 1, ONE), ref)
        t = cuda_ms(lambda: wide(fn, ops, c, 1, ONE), 3)
        print(f"B6 class kernel (16, 16) n={n}, {name}: {t:.3f} ms, "
              f"{'==' if same else '!='} default")
        if not same:
            raise SystemExit(f"B6 {name} differs at n={n}")


def gemv_variants() -> None:
    def shape(v):
        return (f"{v[0]} warps, {v[1]} stages",
                {"constexpr int kWarps = 12;": f"constexpr int kWarps = "
                                               f"{v[0]};",
                 "constexpr int kStages = 3; ": f"constexpr int kStages = "
                                                f"{v[1]}; "})

    with ThreadPoolExecutor(len(GEMV_SHAPES)) as pool:
        built = dict(pool.map(
            lambda v: (shape(v)[0], build("gemv_mxu", shape(v)[1])),
            GEMV_SHAPES))
    for name, (_, spills) in built.items():
        print(f"B9 {name}: ptxas {spills}")
    n = 8192
    a = torch.from_numpy(xt.init_fpuniform_matrix(n, n, 10, 0, seed=1)).cuda()
    x = torch.from_numpy(xt.init_fpuniform(n, 10, 0, seed=2)).cuda()
    ab, zb = a.view(torch.int64), x.view(torch.int64)
    plan = plan_gemv(ab, zb, None, 0, "zero", True)
    zd = gm._digits_cuda(zb.reshape(1, n), plan.f0.to(torch.int64).reshape(1),
                         1, n, 8)
    ea = plan.ea0.to(torch.int32).contiguous()
    p, stream = _build.ptr, _build.stream_of(a.device)

    def classes(fn, kc=vm.K_CHUNK):
        cls = torch.zeros((n, 17), dtype=torch.int64, device="cuda")
        _build.check(fn(p(ab), p(ea), p(zd), n, n, n, 2, 2, kc, p(cls),
                        stream), "gemv_mxu_classes_cuda")
        return cls

    ref = classes(_build.library().gemv_mxu_classes_cuda)
    names = list(built)
    for name in names + names[::-1]:
        fn = built[name][0]
        same = torch.equal(classes(fn), ref) and torch.equal(
            classes(fn, vm.KS), ref)
        t = cuda_ms(lambda: classes(fn), 20)
        print(f"B9 class kernel {n}^2, {name}: {t:.4f} ms (with the zeroing "
              f"of its sums), {'==' if same else '!='} default")
        if not same:
            raise SystemExit(f"B9 {name} differs")
    print(f"torch.mv {cuda_ms(lambda: torch.mv(a, x), 20):.4f} ms")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mxu_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sets = {"gemm": gemm_variants, "wide": wide_variants,
            "gemv": gemv_variants}
    only = (sys.argv[sys.argv.index("--only") + 1].split(",")
            if "--only" in sys.argv else list(sets))
    _build.library()
    for name in only:
        sets[name]()
    print("mxu_variants: passed")


if __name__ == "__main__":
    main()
