#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``exblas_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(the kernels are built for sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels from the checkout's sources, holds each kernel
bit for bit against its plain PyTorch version at n in {1, 17, 2^20+3, 2^24}
on every listed distribution (specials included), drives the public API
(``exsum``, ``exdot``, ``exsum_acc``, ``exdot_acc``) on CUDA tensors at
n = 2^24 against exact host oracles, checks that the main path went through
the kernels, times kernels, plain versions and native float64 controls with
CUDA events, and prints one JSON summary line per the contract below.  Any
failure raises, so the script exits non-zero without the final line.  It
also exits non-zero when no CUDA device is present.

Last line: {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": 1}}.  The line before it: {"kernels": [...]}, one per kernel.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_BIG = 1 << 24
SIZES = (1, 17, (1 << 20) + 3, N_BIG)
SEED = 20261016

SUM_DISTS = ("narrow", "wide", "ill_cond", "lognormal", "zeros_subnormals",
             "cancellation", "nan", "pinf", "ninf", "both_inf")
DOT_DISTS = SUM_DISTS + ("inf_times_zero",)


def log(*args):
    print(*args, flush=True)


def f64_bits(v: float) -> int:
    return int(np.float64(v).view(np.uint64))


def u64(bits: int) -> int:
    return bits & 0xFFFFFFFFFFFFFFFF


# ---------------------------------------------------------------------------
# Inputs, made with numpy from seeds by the port's generators
# ---------------------------------------------------------------------------

def make_input(xt, dist: str, n: int, seed: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    if dist == "narrow":
        return xt.init_fpuniform(n, 2, 0, seed=seed)
    if dist == "wide":
        return xt.init_fpuniform(n, 300, -150, seed=seed)
    if dist == "ill_cond":
        return xt.init_ill_cond(n, 1e30, seed=seed)
    if dist == "lognormal":
        return xt.init_lognormal(n, 0.0, 2.0, seed=seed)
    if dist == "zeros_subnormals":
        sub = xt.init_fpuniform(n, 40, -1030, seed=seed)  # 2^-1070..2^-1031
        sign = np.where(rs.rand(n) < 0.5, -1.0, 1.0)
        return np.where(rs.rand(n) < 0.3, 0.0, sub) * sign
    if dist == "cancellation":
        v = xt.init_fpuniform(n // 2, 60, 30, seed=seed)
        return np.concatenate([v, -v, np.zeros(n % 2)])
    x = xt.init_fpuniform(n, 2, 0, seed=seed).copy()
    k = rs.randint(0, n)
    if dist == "nan":
        # a NaN with a payload and the sign set: the result must still be
        # the canonical 0x7FF8000000000000
        x[k] = np.array([0xFFF0000000000123], np.uint64).view(np.float64)[0]
    elif dist in ("pinf", "inf_times_zero"):
        x[k] = np.inf
    elif dist == "ninf":
        x[k] = -np.inf
    elif dist == "both_inf":
        x[k] = np.inf
        x[(k + n // 2) % n] = -np.inf
    else:
        raise ValueError(dist)
    return x


def dot_partner(xt, dist: str, a: np.ndarray, seed: int) -> np.ndarray:
    """The second ExDOT operand for distribution ``dist``."""
    n = a.size
    if dist in ("nan", "pinf", "ninf", "both_inf"):
        return make_input(xt, "narrow", n, seed)
    if dist == "inf_times_zero":
        b = make_input(xt, "narrow", n, seed).copy()
        b[np.isinf(a)] = 0.0
        return b
    if dist == "cancellation":  # [v, -v] . [w, w] == 0 exactly
        w = xt.init_fpuniform(n // 2, 60, 30, seed=seed)
        return np.concatenate([w, w, np.zeros(n % 2)])
    return make_input(xt, dist, n, seed)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from exblas_tpu_torch.ops.kernels import _build

    log("build:", " ".join(_build.build_command(_build.LIB_PATH)))
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    log(f"build seconds {time.perf_counter() - t0:.2f}")


def same_acc(acc_k, acc_p) -> int:
    """0 if two Superaccs hold the same exact value and counts, else the
    largest canonical-digit difference (or 1 for a sign/count mismatch)."""
    from exblas_tpu_torch.core.rounding import canonicalize_digits

    dk, nk = canonicalize_digits(acc_k.limbs.cpu())
    dp, np_ = canonicalize_digits(acc_p.limbs.cpu())
    err = int((dk.to(torch.int64) - dp.to(torch.int64)).abs().max())
    if bool(nk != np_) or not torch.equal(acc_k.special.cpu(),
                                          acc_p.special.cpu()):
        err = max(err, 1)
    return err


def bits_err(bk: int, bp: int) -> float:
    if bk == bp:
        return 0.0
    vk = float(np.array([bk], np.int64).view(np.float64)[0])
    vp = float(np.array([bp], np.int64).view(np.float64)[0])
    return abs(vk - vp) if math.isfinite(vk - vp) else float("inf")


def phase_kernels(xt) -> dict:
    """Each kernel against its plain PyTorch version on the card."""
    from exblas_tpu_torch.ops.kernels import dot_kernel as dk
    from exblas_tpu_torch.ops.kernels import sum_kernel as sk

    errs = {"exsum_acc_cuda": 0.0, "exsum_bits_cuda": 0.0,
            "exdot_acc_cuda": 0.0, "exdot_bits_cuda": 0.0}
    failures = []
    for n in SIZES:
        for i, dist in enumerate(DOT_DISTS):
            seed = SEED + 97 * i + n % 1009
            a_np = make_input(xt, dist, n, seed)
            a = torch.from_numpy(a_np).cuda()
            line = [f"n={n} {dist}:"]
            if dist in SUM_DISTS:
                bk = int(sk.exsum_bits_cuda(a))
                bp = int(sk.exsum_bits_torch(a))
                e = same_acc(sk.exsum_acc_cuda(a), sk.exsum_acc_torch(a))
                errs["exsum_bits_cuda"] = max(errs["exsum_bits_cuda"],
                                              bits_err(bk, bp))
                errs["exsum_acc_cuda"] = max(errs["exsum_acc_cuda"], e)
                ok = bk == bp and e == 0
                line.append(f"sum {u64(bk):#018x} {'==' if ok else '!='} "
                            f"{u64(bp):#018x}")
                if not ok:
                    failures.append(f"sum n={n} {dist}")
            b = torch.from_numpy(dot_partner(xt, dist, a_np, seed + 1)).cuda()
            bk = int(dk.exdot_bits_cuda(a, b))
            bp = int(dk.exdot_bits_torch(a, b))
            e = same_acc(dk.exdot_acc_cuda(a, b), dk.exdot_acc_torch(a, b))
            errs["exdot_bits_cuda"] = max(errs["exdot_bits_cuda"],
                                          bits_err(bk, bp))
            errs["exdot_acc_cuda"] = max(errs["exdot_acc_cuda"], e)
            ok = bk == bp and e == 0
            line.append(f"dot {u64(bk):#018x} {'==' if ok else '!='} "
                        f"{u64(bp):#018x}")
            if not ok:
                failures.append(f"dot n={n} {dist}")
            log(" ".join(line))
    torch.cuda.synchronize()
    if failures:
        raise AssertionError(f"kernel != plain version: {failures}")
    log("kernels vs plain versions: bit-equal (tolerance 0) on "
        f"{len(SIZES)} sizes x {len(DOT_DISTS)} distributions")
    return errs


def exact_dot_host(a: np.ndarray, b: np.ndarray) -> float:
    """Correctly rounded dot product of finite doubles whose products
    neither overflow nor underflow: Dekker's exact TwoProduct, then
    math.fsum (correctly rounded) over all products and their errors."""
    split = 134217729.0  # 2^27 + 1

    def halves(x):
        t = split * x
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    ah, al = halves(a)
    bh, bl = halves(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return math.fsum(np.concatenate([p, e]).tolist())


def phase_public_api(xt) -> dict:
    """The port's main path: exsum/exdot (and the _acc entries for the
    partition merge) on CUDA tensors at n = 2^24.  Returns the launch
    counts of this run."""
    from exblas_tpu_torch.core.rounding import round_superacc_to_f64_bits
    from exblas_tpu_torch.ops.kernels import dot_kernel as dk
    from exblas_tpu_torch.ops.kernels import sum_kernel as sk

    wrappers = (sk.exsum_acc_cuda, sk.exsum_bits_cuda, dk.exdot_acc_cuda,
                dk.exdot_bits_cuda)
    host = {d: make_input(xt, d, N_BIG, SEED + k)
            for k, d in enumerate(("lognormal", "ill_cond"))}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    perm = torch.randperm(N_BIG, device="cuda", generator=gen)
    bounds = np.linspace(0, N_BIG, 8).astype(int)
    for w in wrappers:
        w.launches = 0

    for dist, x_np in host.items():
        x = torch.from_numpy(x_np).cuda()
        s = xt.exsum(x)
        checks = {
            "math.fsum": math.fsum(x_np.tolist()),
            "parallel=False (C++ backend)": xt.exsum(x, parallel=False),
            "permuted": xt.exsum(x[perm]),
        }
        total = None
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            part = xt.exsum_acc(x[lo:hi])
            total = part if total is None else total + part
        checks["7-way partition"] = float(
            round_superacc_to_f64_bits(total).cpu().view(torch.float64))
        for what, v in checks.items():
            if f64_bits(v) != f64_bits(s):
                raise AssertionError(f"exsum {dist}: {s!r} != {what} {v!r}")
        log(f"exsum n={N_BIG} {dist}: {s!r} bit-equal to "
            + ", ".join(checks))

    for dist in ("lognormal", "ill_cond"):
        a_np = host[dist]
        b_np = make_input(xt, dist, N_BIG, SEED + 7)
        a = torch.from_numpy(a_np).cuda()
        b = torch.from_numpy(b_np).cuda()
        d = xt.exdot(a, b)
        checks = {"exact host dot (TwoProduct + fsum)":
                  exact_dot_host(a_np, b_np),
                  "permuted": xt.exdot(a[perm], b[perm])}
        total = None
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            part = xt.exdot_acc(a[lo:hi], b[lo:hi])
            total = part if total is None else total + part
        checks["7-way partition"] = float(
            round_superacc_to_f64_bits(total).cpu().view(torch.float64))
        for what, v in checks.items():
            if f64_bits(v) != f64_bits(d):
                raise AssertionError(f"exdot {dist}: {d!r} != {what} {v!r}")
        log(f"exdot n={N_BIG} {dist}: {d!r} bit-equal to " + ", ".join(checks))

    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    log("launches on the main path:", launches)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    return launches


def time_ms(fn, reps: int = 7, inner: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        torch.cuda.synchronize()
        samples.append(e0.elapsed_time(e1) / inner)
    return statistics.median(samples)


def phase_timing(xt, smi: str) -> dict:
    from exblas_tpu_torch.ops.kernels import dot_kernel as dk
    from exblas_tpu_torch.ops.kernels import sum_kernel as sk

    out = {}
    for dist in ("narrow", "lognormal", "wide"):
        a = torch.from_numpy(make_input(xt, dist, N_BIG, SEED + 11)).cuda()
        b = torch.from_numpy(make_input(xt, dist, N_BIG, SEED + 12)).cuda()
        rows = (
            ("exsum_acc_cuda", 8, lambda: sk.exsum_acc_cuda(a),
             lambda: sk.exsum_acc_torch(a), lambda: torch.sum(a)),
            ("exsum_bits_cuda", 8, lambda: sk.exsum_bits_cuda(a),
             lambda: sk.exsum_bits_torch(a), lambda: torch.sum(a)),
            ("exdot_acc_cuda", 16, lambda: dk.exdot_acc_cuda(a, b),
             lambda: dk.exdot_acc_torch(a, b), lambda: torch.dot(a, b)),
            ("exdot_bits_cuda", 16, lambda: dk.exdot_bits_cuda(a, b),
             lambda: dk.exdot_bits_torch(a, b), lambda: torch.dot(a, b)),
        )
        for name, bpe, kern, plain, native in rows:
            t_k = time_ms(kern)
            t_p = time_ms(plain, reps=3, inner=1)
            t_n = time_ms(native)
            gbs = bpe * N_BIG / (t_k * 1e-3) / 1e9
            log(f"time n={N_BIG} {dist} {name}: kernel {t_k:.4f} ms "
                f"({gbs:.1f} GB/s), plain torch {t_p:.3f} ms, native "
                f"float64 {t_n:.4f} ms ({bpe * N_BIG / (t_n * 1e-3) / 1e9:.1f}"
                f" GB/s) [{smi}]")
            if dist == "lognormal":
                out[name] = (t_k, t_p)
        # the public entries: the wrappers above plus dispatch and checks
        t_s = time_ms(lambda: xt.exsum_bits(a))
        t_d = time_ms(lambda: xt.exdot_bits(a, b))
        log(f"time n={N_BIG} {dist} public: xt.exsum_bits {t_s:.4f} ms, "
            f"xt.exdot_bits {t_d:.4f} ms [{smi}]")
    return out


KERNELS = (
    ("exsum_acc_cuda", "exblas_tpu_torch/ops/kernels/csrc/sum_kernel.cu",
     "exblas_tpu/ops/kernels/sum_kernel.py:259"),
    ("exsum_bits_cuda", "exblas_tpu_torch/ops/kernels/csrc/sum_kernel.cu",
     "exblas_tpu/ops/kernels/sum_kernel.py:375"),
    ("exdot_acc_cuda", "exblas_tpu_torch/ops/kernels/csrc/dot_kernel.cu",
     "exblas_tpu/ops/kernels/dot_kernel.py:250"),
    ("exdot_bits_cuda", "exblas_tpu_torch/ops/kernels/csrc/dot_kernel.cu",
     "exblas_tpu/ops/kernels/dot_kernel.py:325"),
)


def main() -> None:
    smi = phase_device()
    import exblas_tpu_torch as xt

    phase_build()
    errs = phase_kernels(xt)
    launches = phase_public_api(xt)
    times = phase_timing(xt, smi)
    summary = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, src, rep in KERNELS
    ]
    log(smi)
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
