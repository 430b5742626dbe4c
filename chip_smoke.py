#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``exblas_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(the kernels are built for sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels from the checkout's sources and then, for each
slice of the port:

* ExSUM/ExDOT: holds the exact kernels B2/B4 bit for bit against their
  plain PyTorch versions at n in {1, 17, 2^20+3, 2^24} on every listed
  distribution (specials included), and B2 also on 300-binade data, a
  miss-heavy cancellation and its int32 limbs' spill bound, each at both
  start offsets mod 16; holds the anchored-window kernels B11
  (``sum_flat_cuda``, windows of 96, 128 and 160 bits) and B12
  (``dot_flat_cuda``) against theirs at n in {1, 17, 65539, 2^20+3, 2^24}
  on the BLAS-1 benchmark data and edge cases (subnormals, zeros, all
  negative, cancellation to +0, NaN/+Inf/-Inf, zeros against uncovered
  partners, subnormal products) at the exact anchor, 8 bits above it and
  one bit below it (the flag, the terms and the bits every time: each
  kernel's one-launch window pass, rounded in its last block, against
  the plain ``sum_bits_mxu``/``dot_bits_mxu`` and the two-launch path of
  its terms and B3; the host's exact value on the smaller sizes), B11
  also at four start offsets on the bench lognormal data and on elements
  at its frame's two ends, and B12 at the four start alignments of its
  vectors on the lognormal bench pair and on products at its frame's top
  and bottom; prints B2's, B11's and B12's registers and spills (a spill
  fails); and the rounding kernel B3 (``round_scaled_terms_cuda``) on
  10,000 random term vectors (half of them of full-range int64 terms;
  200 also against Fraction rounding); drives the public API
  (``exsum``, ``exdot`` and their bits and Superacc entries) on CUDA
  tensors at n = 2^24 on the benchmark data of ``benchmarks/bench_sum.py``
  and ``bench_dot.py`` and on data too wide for any window: each call must
  take the tier the JAX package's routing rules give (replayed in numpy),
  launch the kernels that tier names (one window kernel a window pass),
  and match the exact kernels' bits and state, the host's exact value, a
  permutation and a 7-way partition; and checks that this path launched
  six of the seven kernels and not B3, whose rounding runs inside B11 and
  B12;
* ExGEMM: holds the exact kernel and the int8 slice kernel bit for bit
  against their plain versions on five shapes, ten distributions, every
  beta mode, both transposes and the rungs up to (16, 16) and (40, 40)
  (each ``wgmma`` rung also over several k chunks), and the exact kernel
  also on 600-binade pairs of ragged shapes (k = 1 included) in every
  beta mode,
  on signed data whose sums change sign (600 binades, tiny zero-mean
  products, alternating signs) and on a tall shape of more than 2^20 rows;
  drives ``exgemm`` at n = 4096 on the benchmark data (rung (8, 8), the
  slice kernel), on data too wide for any rung (the exact kernel) and on
  data with specials (the override) against exact host values, the exact
  kernel and a permutation of k, and checks that this path launched both
  kernels;
* ExGEMV: holds the row kernel B7, the row analysis B8 and the byte-plane
  kernel B9 bit for bit against their plain versions on five shapes,
  twelve distributions, every beta mode, both transposes and rungs (2, 2),
  (3, 3), (5, 4), (8, 6) and (16, 7) (each case at its narrowest covering
  rung and at the widest), at the largest shape also with the int32 sums
  widened every 64 k; drives ``exgemv`` at 8192^2 on the GEMV benchmark data
  (rung (2, 2): B8 and B9 alone) against B7, exact host values and a
  permutation of k, on a 600-binade A (B7), on data with specials (the
  override), with beta general and with trans "T", and checks that this
  path launched all three kernels; holds B7 and B4, on their warp-owned
  accumulators, against their plain versions on the cases those add: B7
  over its geometries (k split over blocks for small m, m = 1 at k =
  2^22), rows read in place with lda > k (rows 8 bytes off 16), negate_z,
  rows that cancel to +0, NaN/Inf rows and products at the format's two
  ends; B4 at n in {1, 17, 2^20+3, 2^24} on wide300, specials and
  cancellation, at every start alignment of the two vectors; and prints
  both kernels' registers, spills (a spill fails) and shared memory;
* ExTRSV: holds the exact solve B10 (one persistent launch a solve), at
  block heights 64 and 128, bit for bit against its plain version at n
  from 1 to 1000 on eight distributions (specials, a zero diagonal, NaN
  in the triangle that is never read, subnormal x, overflow), unit and
  non-unit, and the public ``extrsv`` in all four (uplo, trans) forms at
  n = 129 and 300 against the public entry on the plain path; drives
  ``extrsv`` at n = 8192 on the TRSV benchmark's data (which overflows
  past row 1593) and on its bounded data (against exact host rows, the
  flipped upper and the transposed solves, and the plain version at
  n = 2048), and checks that this path launched B10 once a solve;

then times kernels, plain versions, the public ladders (with their host
synchronizations) and the native float64 controls with CUDA events --
B5 also on a 600-binade pair no rung covers and on signed data, B10 also
split into the solver warp's phases a step beside an estimate of its
chain; runs the application studies (phase ``apps``); runs the mesh
layer ``exblas_tpu_torch.parallel`` (phase ``parallel``) in worlds of
processes spawned by ``tests/torch_dist.py`` -- one rank over NCCL, then
two and four ranks over Gloo on CUDA tensors, all on this card -- where
every sharded entry must give every rank the single-card entry's bits
and each rank must launch the kernels its route names; holds the
program's own sync counter (``profiling.host_sync.counts``) against
PyTorch's sync debug mode on the benchmark's four calls at 2^24 and 1024
(phase ``syncs``), and their spans in a ``torch.profiler`` trace; and
prints one JSON summary line per the contract below.  Any
failure raises, so the script exits non-zero without the final line.  It
also exits non-zero when no CUDA device is present.

    python3 chip_smoke.py --only gemm_kernels,trsv_timing

runs the build and the named phases alone (``PHASES``; the data each
needs is made as in the full run) and prints no summary: the quick check
of one kernel after a change.

Last line: {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": 1}}.  The line before it: {"kernels": [...]}, one per kernel.
"""

from __future__ import annotations

import collections
import contextlib
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


def s64(v: float) -> int:
    """The binary64 bits of ``v`` as a signed int, as the port holds them."""
    return int(np.float64(v).view(np.int64))


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


def sm_clock_max_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


def phase_build():
    from exblas_tpu_torch.ops.kernels import _build

    for src in _build.sources():
        log("build:", " ".join(_build.object_command(src)(
            _build.object_path(src))))
    log("build:", " ".join(_build.build_command(_build.LIB_PATH)))
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    log(f"build seconds {time.perf_counter() - t0:.2f}")


def same_acc(acc_k, acc_p) -> int:
    """0 if two Superaccs (or batches of them) hold the same exact values
    and counts, else the largest canonical-digit difference (or 1 for a
    sign/count mismatch)."""
    from exblas_tpu_torch.core.rounding import canonicalize_digits

    dk, nk = canonicalize_digits(acc_k.limbs.cpu())
    dp, np_ = canonicalize_digits(acc_p.limbs.cpu())
    err = int((dk.to(torch.int64) - dp.to(torch.int64)).abs().max())
    if not torch.equal(nk, np_) or not torch.equal(acc_k.special.cpu(),
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
    kernel_resources(SUM_RESOURCES)
    n_b2 = 0
    for n in B4_SIZES:
        for name, x_np in b2_cases(xt, n):
            n_b2 += 1
            x0 = torch.from_numpy(x_np).cuda()
            acc_p = sk.exsum_acc_torch(x0)
            bits_p = int(sk.exsum_bits_torch(x0))
            line = [f"B2 n={n} {name}:"]
            for off in (0, 1):
                x = offset_copy(x_np, off)
                bits_k = int(sk.exsum_bits_cuda(x))
                e = same_acc(sk.exsum_acc_cuda(x), acc_p)
                errs["exsum_bits_cuda"] = max(errs["exsum_bits_cuda"],
                                              bits_err(bits_k, bits_p))
                errs["exsum_acc_cuda"] = max(errs["exsum_acc_cuda"], e)
                ok = bits_k == bits_p and e == 0
                if name == "cancellation" and bits_k != 0:
                    ok = False
                line.append(f"at +{off} {'==' if ok else '!='}")
                if not ok:
                    failures.append(f"B2 n={n} {name} at +{off}")
            log(" ".join(line) + f" {u64(bits_p):#018x}")
    torch.cuda.synchronize()
    if failures:
        raise AssertionError(f"kernel != plain version: {failures}")
    log("kernels vs plain versions: bit-equal (tolerance 0) on "
        f"{len(SIZES)} sizes x {len(DOT_DISTS)} distributions, and B2 on "
        f"{n_b2} cases x 2 start offsets")
    return errs


# B2's warp accumulator: the kernel's registers, spills, shared memory and
# resident blocks an SM (a spill fails)
SUM_RESOURCES = (("exsum_attrs", (), "B2 sum kernel"),)


def b2_cases(xt, n: int):
    """(name, x) numpy data of n elements for B2's warp accumulator:
    300 binades (most doubles miss the 64-bit window), a miss-heavy
    cancellation to +0, and the spill bound: x[0] places warp 0's window
    near 2^600, far above doubles whose digit 1 is 2^20 - 1, so each of
    that warp's 2048 doubles between two spills adds 2^20 - 1 to one int32
    limb (2^31 - 2^11 at 2^24)."""
    seed = SEED + 5000 + n % 1009
    yield "wide300", make_input(xt, "wide", n, seed)
    v = make_input(xt, "wide", n // 2, seed + 1)
    yield "cancellation", np.concatenate([v, -v[::-1], np.zeros(n % 2)])
    x = np.full(n, 2.0 - 2.0 ** -52)
    x[0] = 2.0 ** 600
    yield "spill bound", x


def kernel_resources(entries) -> None:
    """Registers, local (spilled) bytes, shared memory and resident
    blocks an SM of each (C entry, arguments, name), as the runtime
    reports them; a spill fails."""
    from exblas_tpu_torch.ops.kernels import _build

    lib = _build.library()
    out = torch.zeros(4, dtype=torch.int32)
    for entry, args, name in entries:
        _build.check(getattr(lib, entry)(*args, _build.ptr(out)), entry)
        regs, local, shared, blocks = out.tolist()
        log(f"{name}: {regs} registers, {local} local bytes, {shared} static "
            f"shared bytes, {blocks} resident blocks an SM")
        if local != 0:
            raise AssertionError(f"{name} spills {local} bytes")


def exact_dot_host(a: np.ndarray, b: np.ndarray, extra=()) -> float:
    """Correctly rounded dot product (plus the doubles ``extra``) of finite
    doubles whose products neither overflow nor underflow: Dekker's exact
    TwoProduct, then math.fsum (correctly rounded) over all products,
    their errors and ``extra``."""
    split = 134217729.0  # 2^27 + 1

    def halves(x):
        t = split * x
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    ah, al = halves(a)
    bh, bl = halves(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return math.fsum(np.concatenate([p, e, np.asarray(extra, np.float64)])
                     .tolist())


# The BLAS-1 benchmark data (benchmarks/bench_sum.py:32-37,
# benchmarks/bench_dot.py:27-37), made by the port's generators with the
# same seeds, plus data too wide for any window (the exact tier).
def bench_sum_data(xt, n: int) -> dict:
    return {"narrow": xt.init_fpuniform(n, 2, 0, seed=7),
            "wide": xt.init_fpuniform(n, 50, -25, seed=8),
            "illcond": xt.init_ill_cond(n, 1e30, seed=9),
            "lognormal": xt.init_lognormal(n, 1.0, 2.0, seed=10),
            "wide300": make_input(xt, "wide", n, SEED + 3)}


def bench_dot_data(xt, n: int) -> dict:
    rng = np.random.default_rng(5)
    return {"narrow": (xt.init_fpuniform(n, 2, 0, seed=7),
                       xt.init_fpuniform(n, 2, 0, seed=8)),
            "wide": (xt.init_fpuniform(n, 50, -25, seed=9),
                     xt.init_fpuniform(n, 50, -25, seed=10)),
            "lognormal": (xt.init_lognormal(n, 1.0, 2.0, seed=11),
                          xt.init_lognormal(n, 1.0, 2.0, seed=12)),
            "illcond_1e30": (xt.init_ill_cond(n, 1e30, seed=13),
                             rng.uniform(0.5, 2.0, n)),
            "wide300": (make_input(xt, "wide", n, SEED + 3),
                        make_input(xt, "wide", n, SEED + 4))}


# The JAX package's routing rules (exblas_tpu/ops/kernels/sum_mxu.py:60-172,
# ops/exsum.py:52-116, ops/exdot.py:44-130) replayed in numpy on the host,
# independently of the port's code: the tiers the ladders must take.

def np_anchor_spread(bits: np.ndarray):
    expf = (bits >> 52) & 0x7FF
    anchor = int(expf.max()) - 1023 + 8
    e1 = expf[expf >= 1]
    return anchor, 61 if e1.size == 0 else anchor - (int(e1.min()) - 1075) + 1


def np_resolved(bits: np.ndarray, boundaries):
    nch = bits.size // 8192
    s = bits
    if nch >= 2:
        s = np.concatenate([bits[:nch * 8192].reshape(nch, 8192)[::8].ravel(),
                            bits[-8192:]])
    e, sp = np_anchor_spread(s)
    if any(b - 16 < sp <= b for b in boundaries):
        e, sp = np_anchor_spread(bits)
    return e, sp


def np_flag(bits: np.ndarray, anchor: int, w: int) -> bool:
    expf = (bits >> 52) & 0x7FF
    special = expf == 0x7FF
    nz = ((bits & 0x7FFFFFFFFFFFFFFF) != 0) & ~special
    sh = np.maximum(expf, 1) - 1075 - (anchor + 1 - w)
    return bool(np.any(special | (nz & ((sh < 0) | (sh > w - 53)))))


def np_exact_anchor(bits: np.ndarray) -> int:
    return int(((bits >> 52) & 0x7FF).max()) - 1023


def np_sum_route(x: np.ndarray) -> tuple:
    bits = x.view(np.int64)
    e, sp = np_resolved(bits, (96, 128, 168))
    for bound, nwa, deslack in ((96, 3, 0), (128, 4, 0), (168, 5, 8)):
        if sp <= bound:
            break
    else:
        return ("exact",)
    if not np_flag(bits, e - deslack, 32 * nwa):
        return (f"nwa{nwa}",)
    if not np_flag(bits, np_exact_anchor(bits), 160):
        return (f"nwa{nwa}", "retry")
    return (f"nwa{nwa}", "retry", "exact")


def np_dot_route(a: np.ndarray, b: np.ndarray) -> tuple:
    ba, bb = a.view(np.int64), b.view(np.int64)
    ea, sa = np_resolved(ba, (168,))
    eb, sb = np_resolved(bb, (168,))
    if sa > 168 or sb > 168:
        return ("exact",)
    ea -= 8 if sa > 160 else 0
    eb -= 8 if sb > 160 else 0
    if not (np_flag(ba, ea, 160) or np_flag(bb, eb, 160)):
        return ("fast",)
    if sa > 160 or sb > 160:
        return ("fast", "exact")
    if not (np_flag(ba, np_exact_anchor(ba), 160)
            or np_flag(bb, np_exact_anchor(bb), 160)):
        return ("fast", "retry")
    return ("fast", "retry", "exact")


def sum_dot_wrappers():
    """Every kernel wrapper of the ExSUM/ExDOT path, by name."""
    from exblas_tpu_torch.ops.kernels import dot_kernel as dk
    from exblas_tpu_torch.ops.kernels import dot_mxu as dm
    from exblas_tpu_torch.ops.kernels import round_in_kernel as rk
    from exblas_tpu_torch.ops.kernels import sum_kernel as sk
    from exblas_tpu_torch.ops.kernels import sum_mxu as sm

    return {w.__name__: w for w in (
        sk.exsum_acc_cuda, sk.exsum_bits_cuda, dk.exdot_acc_cuda,
        dk.exdot_bits_cuda, sm.sum_flat_cuda, dm.dot_flat_cuda,
        rk.round_scaled_terms_cuda)}


def all_wrappers():
    """Every kernel wrapper of the port, by name: the ExSUM/ExDOT ones and
    those of ExGEMM, ExGEMV and ExTRSV."""
    from exblas_tpu_torch.ops.kernels import gemm_kernel as gk
    from exblas_tpu_torch.ops.kernels import gemm_mxu as gm
    from exblas_tpu_torch.ops.kernels import gemv_kernel as vk
    from exblas_tpu_torch.ops.kernels import gemv_mxu as vm
    from exblas_tpu_torch.ops.kernels import trsv_kernel as tk

    return {**sum_dot_wrappers(), **{w.__name__: w for w in (
        gk.gemm_bits_cuda, gm.gemm_bits_mxu_cuda, vk.gemv_rows_acc_cuda,
        vm.analyze_gemv_rows_cuda, vm.gemv_bits_mxu_cuda,
        tk.trsv_lower_x_cuda)}}


@contextlib.contextmanager
def uncounted():
    """Launches inside do not count towards the main path's run: the
    comparisons with other kernels and plain versions."""
    wrappers = sum_dot_wrappers()
    saved = {k: w.launches for k, w in wrappers.items()}
    try:
        yield
    finally:
        for k, w in wrappers.items():
            w.launches = saved[k]


def route_launches(route: tuple, window: str, exact: str) -> dict:
    """The launches a bits call on ``route`` makes: each window pass is one
    launch of its window kernel, which rounds in its last block (B3 is not
    launched), the exact tier one of its exact kernel."""
    passes = sum(t != "exact" for t in route)
    want = {window: passes, exact: int(route[-1] == "exact")}
    return {k: v for k, v in want.items() if v}


def launch_delta(before: dict) -> dict:
    now = {k: w.launches for k, w in sum_dot_wrappers().items()}
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def phase_public_api(xt) -> dict:
    """The port's main path: exsum/exdot and their bits and Superacc
    entries on CUDA tensors at n = 2^24 on the BLAS-1 benchmark data and
    on data too wide for any window.  Each call takes the tier the JAX
    package's rules give (replayed in numpy), launches the kernels that
    tier names, and gives the exact kernels' bits and state, the host's
    exact value, the same bits under a permutation and in a 7-way
    partition.  Returns the launch counts of this run."""
    from exblas_tpu_torch.core.rounding import round_superacc_to_f64_bits
    from exblas_tpu_torch.ops.exdot import (_exdot_acc_mxu_auto,
                                            _exdot_bits_mxu_auto)
    from exblas_tpu_torch.ops.exsum import (_exsum_acc_mxu_auto,
                                            _exsum_bits_mxu_auto)
    from exblas_tpu_torch.ops.kernels import dot_kernel as dk
    from exblas_tpu_torch.ops.kernels import sum_kernel as sk

    wrappers = sum_dot_wrappers()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    perm = torch.randperm(N_BIG, device="cuda", generator=gen)
    bounds = np.linspace(0, N_BIG, 8).astype(int)
    for w in wrappers.values():
        w.launches = 0

    def partition(fn, *vs):
        total = None
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            part = fn(*(v[lo:hi] for v in vs))
            total = part if total is None else total + part
        return float(round_superacc_to_f64_bits(total).cpu().view(
            torch.float64))

    for dist, x_np in bench_sum_data(xt, N_BIG).items():
        x = torch.from_numpy(x_np).cuda()
        before = {k: w.launches for k, w in wrappers.items()}
        bits = int(xt.exsum_bits(x))
        route, delta = _exsum_bits_mxu_auto.route, launch_delta(before)
        want_route = np_sum_route(x_np)
        want_delta = route_launches(route, "sum_flat_cuda", "exsum_bits_cuda")
        if route != want_route or delta != want_delta:
            raise AssertionError(f"exsum_bits {dist}: route {route} launches "
                                 f"{delta}, want {want_route} {want_delta}")
        s = xt.exsum(x)
        acc = xt.exsum_acc(x)
        acc_route = _exsum_acc_mxu_auto.route
        checks = {"exsum_bits": float(np.int64(bits).view(np.float64)),
                  "math.fsum": math.fsum(x_np.tolist()),
                  "parallel=False (C++ backend)": xt.exsum(x,
                                                           parallel=False),
                  "permuted": xt.exsum(x[perm]),
                  "7-way partition": partition(xt.exsum_acc, x),
                  "exsum_acc": float(round_superacc_to_f64_bits(acc).cpu()
                                     .view(torch.float64))}
        with uncounted():
            checks["B2b exsum_bits_cuda"] = float(np.int64(int(
                sk.exsum_bits_cuda(x))).view(np.float64))
            if acc_route != route or same_acc(acc, sk.exsum_acc_cuda(x)):
                raise AssertionError(f"exsum_acc {dist}: route {acc_route} "
                                     "or state differs from B2a's")
        for what, v in checks.items():
            if f64_bits(v) != f64_bits(s):
                raise AssertionError(f"exsum {dist}: {s!r} != {what} {v!r}")
        log(f"exsum n={N_BIG} {dist}: route {route}, launches {delta}; "
            f"{s!r} bit-equal to " + ", ".join(checks)
            + "; exsum_acc state equal to B2a's")

    for dist, (a_np, b_np) in bench_dot_data(xt, N_BIG).items():
        a = torch.from_numpy(a_np).cuda()
        b = torch.from_numpy(b_np).cuda()
        before = {k: w.launches for k, w in wrappers.items()}
        bits = int(xt.exdot_bits(a, b))
        route, delta = _exdot_bits_mxu_auto.route, launch_delta(before)
        want_route = np_dot_route(a_np, b_np)
        want_delta = route_launches(route, "dot_flat_cuda", "exdot_bits_cuda")
        if route != want_route or delta != want_delta:
            raise AssertionError(f"exdot_bits {dist}: route {route} launches "
                                 f"{delta}, want {want_route} {want_delta}")
        d = xt.exdot(a, b)
        acc = xt.exdot_acc(a, b)
        acc_route = _exdot_acc_mxu_auto.route
        checks = {"exdot_bits": float(np.int64(bits).view(np.float64)),
                  "exact host dot (TwoProduct + fsum)":
                  exact_dot_host(a_np, b_np),
                  "permuted": xt.exdot(a[perm], b[perm]),
                  "7-way partition": partition(xt.exdot_acc, a, b),
                  "exdot_acc": float(round_superacc_to_f64_bits(acc).cpu()
                                     .view(torch.float64))}
        with uncounted():
            checks["B4b exdot_bits_cuda"] = float(np.int64(int(
                dk.exdot_bits_cuda(a, b))).view(np.float64))
            if acc_route != route or same_acc(acc, dk.exdot_acc_cuda(a, b)):
                raise AssertionError(f"exdot_acc {dist}: route {acc_route} "
                                     "or state differs from B4a's")
        for what, v in checks.items():
            if f64_bits(v) != f64_bits(d):
                raise AssertionError(f"exdot {dist}: {d!r} != {what} {v!r}")
        log(f"exdot n={N_BIG} {dist}: route {route}, launches {delta}; "
            f"{d!r} bit-equal to " + ", ".join(checks)
            + "; exdot_acc state equal to B4a's")

    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log("launches on the main path:", launches)
    # B3's rounding runs inside the window kernels' last blocks
    missing = [k for k, v in launches.items()
               if v == 0 and k != "round_scaled_terms_cuda"]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    if launches["round_scaled_terms_cuda"] != 0:
        raise AssertionError("the main path launched B3: "
                             f"{launches['round_scaled_terms_cuda']}")
    # numpy input runs on the card
    x_np = bench_sum_data(xt, 1 << 20)["lognormal"]
    with uncounted():
        if (xt.exsum_bits(x_np).device.type != "cuda"
                or f64_bits(xt.exsum(x_np))
                != f64_bits(math.fsum(x_np.tolist()))):
            raise AssertionError("exsum on numpy input did not run on the "
                                 "card")
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
                out[name] = (t_k, t_p, t_n)
        # the public entries: the wrappers above plus dispatch and checks
        t_s = time_ms(lambda: xt.exsum_bits(a))
        t_d = time_ms(lambda: xt.exdot_bits(a, b))
        log(f"time n={N_BIG} {dist} public: xt.exsum_bits {t_s:.4f} ms, "
            f"xt.exdot_bits {t_d:.4f} ms [{smi}]")
    return out


# ---------------------------------------------------------------------------
# The ExSUM/ExDOT fast paths: B11, B12 and B3 against their plain versions
# ---------------------------------------------------------------------------

FAST_SIZES = (1, 17, 65539, (1 << 20) + 3, N_BIG)
FAST_SUM_DISTS = ("bench_narrow", "bench_wide", "bench_illcond",
                  "bench_lognormal", "subnormals", "zeros_mixed",
                  "all_negative", "cancellation", "nan", "pinf", "ninf")
FAST_DOT_DISTS = ("bench_narrow", "bench_wide", "bench_lognormal",
                  "bench_illcond", "zeros_vs_outside", "subnormal_products",
                  "nan", "pinf", "ninf")
B3_VECTORS = 10000
B3_FRACTION = 200


def fast_input(xt, dist: str, n: int, seed: int) -> np.ndarray:
    """One operand of the fast-path kernel checks."""
    rs = np.random.RandomState(seed)
    if dist == "bench_narrow":
        return xt.init_fpuniform(n, 2, 0, seed=seed)
    if dist == "bench_wide":
        return xt.init_fpuniform(n, 50, -25, seed=seed)
    if dist == "bench_illcond":
        return xt.init_ill_cond(n, 1e30, seed=seed)
    if dist == "bench_lognormal":
        return xt.init_lognormal(n, 1.0, 2.0, seed=seed)
    if dist == "subnormals":
        return xt.init_fpuniform(n, 40, -1070, seed=seed) * np.where(
            rs.rand(n) < 0.5, -1.0, 1.0)
    if dist == "zeros_mixed":
        return np.where(rs.rand(n) < 0.4, 0.0,
                        xt.init_fpuniform(n, 30, -10, seed=seed))
    if dist == "all_negative":
        return -xt.init_fpuniform(n, 20, -5, seed=seed)
    if dist == "cancellation":   # sums to +0 exactly
        v = xt.init_fpuniform(n // 2, 40, -20, seed=seed)
        return np.concatenate([v, -v[::-1], np.zeros(n % 2)])
    return make_input(xt, dist, n, seed)   # nan, pinf, ninf


def fast_pair(xt, dist: str, n: int, seed: int):
    if dist == "zeros_vs_outside":
        # zeros in a against partners far below b's window: each side is
        # checked on its own, so b's flag must show
        a = xt.init_fpuniform(n, 20, -10, seed=seed)
        b = xt.init_fpuniform(n, 20, -10, seed=seed + 1)
        k = np.random.RandomState(seed).randint(0, n)
        a[k], b[k] = 0.0, 2.0**-900
        return a, b
    if dist == "subnormal_products":
        return (xt.init_fpuniform(n, 20, -530, seed=seed),
                xt.init_fpuniform(n, 20, -530, seed=seed + 1))
    if dist in ("nan", "pinf", "ninf"):
        return (fast_input(xt, dist, n, seed),
                fast_input(xt, "bench_narrow", n, seed + 1))
    return fast_input(xt, dist, n, seed), fast_input(xt, dist, n, seed + 1)


def frame_value(rel: torch.Tensor) -> int:
    """The exact integer of a B11/B12 frame: term k at bit 32 k."""
    return sum(int(v) << (32 * k) for k, v in enumerate(rel.tolist()))


def host_scaled(x: np.ndarray):
    """(m, e) per finite element: x = m * 2^e with m a signed int64."""
    bits = x.view(np.int64)
    expf = (bits >> 52) & 0x7FF
    frac = bits & ((1 << 52) - 1)
    m = np.where(expf != 0, frac | (1 << 52), frac)
    return np.where(bits < 0, -m, m), np.maximum(expf, 1) - 1075


def host_sum_frame(x: np.ndarray, e0: int) -> int:
    """The exact sum of finite x in units of 2^e0 (an int)."""
    m, e = host_scaled(x)
    return sum(int(mi) << int(ei - e0) for mi, ei in zip(m, e) if mi)


def host_dot_frame(a: np.ndarray, b: np.ndarray, e0: int) -> int:
    ma, la = host_scaled(a)
    mb, lb = host_scaled(b)
    return sum((int(x) * int(y)) << int(p + q - e0)
               for x, y, p, q in zip(ma, mb, la, lb) if x and y)


def frame_err(rk, bk, rp, bp) -> float:
    """0 when two frames agree (flags and terms: the terms are the exact
    sum of the covered elements, flag or not), else their exact difference
    (1 for a flag mismatch)."""
    if bool(bk) != bool(bp):
        return 1.0
    if torch.equal(rk.cpu(), rp.cpu()):
        return 0.0
    return float(abs(frame_value(rk) - frame_value(rp)))


def window_err(terms, flags, bits) -> float:
    """0 when a window pass's versions agree: the two terms tensors and
    the flags (kernel first, plain version second) by frame_err, every
    flag alike, and every bits value alike (each bits value rounds the
    terms, so they agree whatever the flag); else the largest
    difference."""
    err = frame_err(terms[0], flags[0], terms[1], flags[1])
    if len({bool(f) for f in flags}) > 1:
        err = max(err, 1.0)
    ints = [int(b) for b in bits]
    for b in ints[1:]:
        err = max(err, bits_err(b, ints[0]))
    return err


def sum_window_pass(x, anchor, nwa: int):
    """B11 at one window, every way the port has: its terms and flag, its
    fused bits (one launch, rounded in its last block), the two-launch
    path (its terms, then B3) and the plain sum_flat_torch and
    sum_bits_mxu: (the difference as window_err gives it, the kernel's
    terms, its flag)."""
    from exblas_tpu_torch.ops.kernels import round_in_kernel as rk
    from exblas_tpu_torch.ops.kernels import sum_mxu as sm

    rel_k, bad_k = sm.sum_flat_cuda(x, anchor, nwa)
    rel_p, bad_p = sm.sum_flat_torch(x, anchor, nwa)
    fused, fbad = sm.sum_bits_mxu(x, anchor, nwa, True)
    plain, pbad = sm.sum_bits_mxu(x, anchor, nwa, False)
    two = rk.round_scaled_terms_cuda(rel_k, sm.frame_positions(nwa), anchor,
                                     1 - 32 * nwa)
    return window_err((rel_k, rel_p), (bad_k, bad_p, fbad, pbad),
                      (fused, plain, two)), rel_k, bad_k


def dot_window_pass(a, b, ea, eb):
    """B12 as sum_window_pass holds B11."""
    from exblas_tpu_torch.ops.kernels import dot_mxu as dm
    from exblas_tpu_torch.ops.kernels import round_in_kernel as rk

    rel_k, bad_k = dm.dot_flat_cuda(a, b, ea, eb)
    rel_p, bad_p = dm.dot_flat_torch(a, b, ea, eb)
    fused, fbad = dm.dot_bits_mxu(a, b, ea, eb, True)
    plain, pbad = dm.dot_bits_mxu(a, b, ea, eb, False)
    two = rk.round_scaled_terms_cuda(rel_k, dm.frame_positions(
        dm.FRAME_WORDS), ea + eb, dm.FRAME_OFFSET)
    return window_err((rel_k, rel_p), (bad_k, bad_p, fbad, pbad),
                      (fused, plain, two)), rel_k, bad_k


def phase_fast_kernels(xt) -> dict:
    """B11 (nwa 3, 4, 5) and B12 at the exact anchor, 8 bits above it and
    one bit below it, against their plain versions and the two-launch path
    (sum_window_pass, dot_window_pass): flags, terms and bits every time,
    the host's exact value on the smaller sizes; B11 also at four start
    offsets on the bench lognormal data and on elements at the frame's two
    ends; B3 on random term vectors against its plain version on the
    host's CPU and against Fraction rounding."""
    from fractions import Fraction

    from exblas_tpu_torch.ops.kernels import dot_mxu as dm
    from exblas_tpu_torch.ops.kernels import round_in_kernel as rk
    from exblas_tpu_torch.ops.kernels import sum_mxu as sm

    errs = {"sum_flat_cuda": 0.0, "dot_flat_cuda": 0.0,
            "round_scaled_terms_cuda": 0.0}
    failures = []
    cases = 0
    for n in FAST_SIZES:
        for i, dist in enumerate(FAST_SUM_DISTS):
            x_np = fast_input(xt, dist, n, SEED + 31 * i + n % 997)
            x = torch.from_numpy(x_np).cuda()
            e = sm.exact_anchor(x)
            flags = []
            for nwa in (3, 4, 5):
                for de in (0, 8, -1):
                    anchor = e + de
                    err, rk_, bk = sum_window_pass(x, anchor, nwa)
                    errs["sum_flat_cuda"] = max(errs["sum_flat_cuda"], err)
                    cases += 1
                    flags.append(int(bool(bk)))
                    if err:
                        failures.append(f"B11 n={n} {dist} nwa={nwa} de={de}")
                    if de == -1 and not bool(bk) and int(e) > -1023:
                        failures.append(f"B11 n={n} {dist} nwa={nwa}: no "
                                        "flag one bit below the anchor")
                    if (de == 0 and nwa == 5 and n <= 65539 and not bool(bk)
                            and frame_value(rk_) != host_sum_frame(
                                x_np, int(e) + 1 - 160)):
                        failures.append(f"B11 n={n} {dist}: != host sum")
            log(f"B11 n={n} {dist}: flags (nwa 3,4,5 x anchor +0,+8,-1) "
                f"{flags}")
        for i, dist in enumerate(FAST_DOT_DISTS):
            a_np, b_np = fast_pair(xt, dist, n, SEED + 37 * i + n % 991)
            a = torch.from_numpy(a_np).cuda()
            b = torch.from_numpy(b_np).cuda()
            ea, eb = sm.exact_anchor(a), sm.exact_anchor(b)
            flags = []
            for da, db in ((0, 0), (8, 8), (-1, 0), (0, -1)):
                err, rk_, bk = dot_window_pass(a, b, ea + da, eb + db)
                errs["dot_flat_cuda"] = max(errs["dot_flat_cuda"], err)
                cases += 1
                flags.append(int(bool(bk)))
                if err:
                    failures.append(f"B12 n={n} {dist} anchors +{da},+{db}")
                if (da == db == 0 and n <= 65539 and not bool(bk)
                        and frame_value(rk_) != host_dot_frame(
                            a_np, b_np, int(ea) + int(eb) + 2 - 320)):
                    failures.append(f"B12 n={n} {dist}: != host dot")
            if dist == "zeros_vs_outside" and n > 1 and not flags[0]:
                failures.append(f"B12 n={n}: a zero hid b's uncovered element")
            log(f"B12 n={n} {dist}: flags (anchors +0/+0, +8/+8, -1/+0, "
                f"+0/-1) {flags}")
    kernel_resources(SUM_FLAT_RESOURCES + DOT_FLAT_RESOURCES)
    for n in FAST_SIZES:
        seed = SEED + 907 + n % 991
        for nwa in (3, 4, 5):
            for name, x_np in (
                    ("bench_lognormal", fast_input(xt, "bench_lognormal", n,
                                                   seed)),
                    ("frame ends", window_end_sum(n, nwa, seed + 1))):
                e = sm.exact_anchor(torch.from_numpy(x_np).cuda())
                line = [f"B11 n={n} nwa={nwa} {name}:"]
                for off in B11_OFFSETS:
                    x = offset_copy(x_np, off)
                    err, rk_, bk = sum_window_pass(x, e, nwa)
                    if bool(bk):
                        err = max(err, 1.0)  # every element is covered
                    errs["sum_flat_cuda"] = max(errs["sum_flat_cuda"], err)
                    cases += 1
                    line.append(f"at {off} {'==' if err == 0 else '!='}")
                    if err:
                        failures.append(f"B11 n={n} nwa={nwa} {name} at {off}")
                if (n <= 65539 and nwa == 5 and frame_value(rk_)
                        != host_sum_frame(x_np, int(e) + 1 - 160)):
                    failures.append(f"B11 n={n} {name}: != host sum")
                log(" ".join(line))
        for name, (a_np, b_np) in (
                ("bench_lognormal", fast_pair(xt, "bench_lognormal", n, seed)),
                ("frame edges", frame_edge_pair(n, seed + 2))):
            a0, b0 = (torch.from_numpy(v).cuda() for v in (a_np, b_np))
            ea, eb = sm.exact_anchor(a0), sm.exact_anchor(b0)
            rp, bp = dm.dot_flat_torch(a0, b0, ea, eb)
            line = [f"B12 n={n} {name}:"]
            for oa, ob in B4_OFFSETS:
                a, b = offset_copy(a_np, oa), offset_copy(b_np, ob)
                err, rk_, bk = dot_window_pass(a, b, ea, eb)
                err = max(err, frame_err(rk_, bk, rp, bp))
                errs["dot_flat_cuda"] = max(errs["dot_flat_cuda"], err)
                cases += 1
                line.append(f"at ({oa},{ob}) {'==' if err == 0 else '!='}")
                if err:
                    failures.append(f"B12 n={n} {name} at ({oa},{ob})")
            if (n <= 65539 and not bool(bp) and frame_value(rp)
                    != host_dot_frame(a_np, b_np,
                                      int(ea) + int(eb) + 2 - 320)):
                failures.append(f"B12 n={n} {name}: != host dot")
            log(" ".join(line) + f" flag {int(bool(bp))}")
    torch.cuda.synchronize()

    rs = np.random.RandomState(SEED)
    for k in range(B3_VECTORS):
        t = int(rs.randint(1, 129))
        # every other vector takes full-range int64 terms, as B12's or any
        # caller's terms may be; the others the JAX kernel's |v| < 2^52
        top = (1 << 52) if k % 2 else (1 << 63) - 1
        vals = rs.randint(1 - top, top, t, dtype=np.int64)
        pos = tuple(int(p) for p in rs.randint(0, 400, t))
        eadj = int(rs.randint(-1300, 1100))
        v = torch.from_numpy(vals)
        bk = int(rk.round_scaled_terms_cuda(
            v.cuda(), pos, torch.tensor(eadj, dtype=torch.int32).cuda()))
        bp = int(rk.round_scaled_terms_torch(v, pos, eadj))
        err = bits_err(bk, bp)
        if k < B3_FRACTION:
            exact = sum(int(x) << p for x, p in zip(vals.tolist(), pos))
            want = fraction_bits(Fraction(exact) * Fraction(2) ** eadj)
            err = max(err, bits_err(bk, want))
        errs["round_scaled_terms_cuda"] = max(
            errs["round_scaled_terms_cuda"], err)
        if err:
            failures.append(f"B3 vector {k}")
    if failures:
        raise AssertionError(f"fast-path kernel != plain version: "
                             f"{failures[:20]}")
    log(f"fast-path kernels vs plain versions: bit-equal (tolerance 0) on "
        f"{cases} B11/B12 cases (terms, flags, and the fused bits against "
        f"the plain bits and the two-launch path) and {B3_VECTORS} B3 "
        f"vectors, half of them full-range int64 ({B3_FRACTION} also "
        f"against Fraction rounding)")
    return errs


# B11: the kernel's registers, spills, shared memory and resident blocks an
# SM at each window (a spill fails)
SUM_FLAT_RESOURCES = tuple(
    ("sum_flat_attrs", (nwa,), f"B11 sum kernel, nwa={nwa}")
    for nwa in (3, 4, 5))
# B11's start offsets, in elements past a 256-byte boundary: 0, 8, 16 and
# 24 bytes, both alignments mod 16 with the pairs split two ways
B11_OFFSETS = (0, 1, 2, 3)


def window_end_sum(n: int, nwa: int, seed: int) -> np.ndarray:
    """n doubles of full 53-bit significands, each at one end of the
    window of 32 nwa bits below the anchor 0, chosen at random: the LSB at
    the frame's bit 0 (sh = 0) or the leading bit at the anchor (sh =
    32 nwa - 53), signs alternating; x[0] sets the anchor."""
    rs = np.random.RandomState(seed)
    m = rs.randint(1 << 52, 1 << 53, n, dtype=np.int64).astype(np.float64)
    e = np.where(rs.rand(n) < 0.5, -52, 1 - 32 * nwa)
    x = np.ldexp(m, e) * np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    x[0] = 2.0 - 2.0 ** -52
    return x


# B12: the kernel's registers, spills, shared memory and resident blocks
# an SM at both load widths (a spill fails)
DOT_FLAT_RESOURCES = (
    ("dot_flat_attrs", (0,), "B12 dot kernel, 16-byte loads"),
    ("dot_flat_attrs", (1,), "B12 dot kernel, 8-byte loads"))


def frame_edge_pair(n: int, seed: int):
    """(a, b) of full 53-bit significands at each window's top (leading
    bit at the anchor 0) or bottom (LSB at 2^-159), chosen at random, with
    signs alternating every element in a and every two in b: their
    products sit at the frame's top (bit 214), bottom (bit 0) and middle,
    their signs alternating."""
    rs = np.random.RandomState(seed)

    def side(k: int) -> np.ndarray:
        m = rs.randint(1 << 52, 1 << 53, n, dtype=np.int64).astype(np.float64)
        e = np.where(rs.rand(n) < 0.5, -52, -159)
        x = np.ldexp(m, e) * np.where((np.arange(n) >> k) % 2 == 0, 1.0, -1.0)
        x[0] = 2.0 - 2.0 ** -52  # the anchor: the window's top bit
        return x

    return side(0), side(1)


def fraction_bits(v) -> int:
    """The int64 bits of the correctly rounded double of a Fraction."""
    from fractions import Fraction

    # 2^1024 - 2^970: from here on a value rounds to infinity
    bound = Fraction((1 << 2098) - (1 << 2044), 1 << 1074)
    if v >= bound:
        return s64(math.inf)
    if v <= -bound:
        return s64(-math.inf)
    return s64(float(v))


def count_syncs(fn) -> int:
    """Host synchronizations of one call, as PyTorch's sync debug mode
    reports them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def host_ms(fn, reps: int = 21) -> float:
    """Median host-clock time of one call that ends in a synchronize."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples) * 1e3


def ladder_breakdown(xt, x_np: np.ndarray, ab_np, smi: str) -> None:
    """Host-clock times of the ladders' steps on lognormal bench data:
    where a public call's time goes when the card waits for the host."""
    from exblas_tpu_torch.ops.kernels import dot_mxu as dm
    from exblas_tpu_torch.ops.kernels import round_in_kernel as rk
    from exblas_tpu_torch.ops.kernels import sum_kernel as sk
    from exblas_tpu_torch.ops.kernels import sum_mxu as sm

    x = torch.from_numpy(x_np).cuda()
    a, b = (torch.from_numpy(v).cuda() for v in ab_np)
    e = sm.exact_anchor(x)
    ea, eb = sm.exact_anchor(a), sm.exact_anchor(b)
    rel, _ = sm.sum_flat_cuda(x, e, 3)
    parts = {
        "sum public": lambda: xt.exsum_bits(x),
        "sample_anchor (1 sync)": lambda: sm.sample_anchor(x),
        "full_anchor (1 sync)": lambda: sm.full_anchor(x),
        "device_anchor": lambda: sm.device_anchor(0, x.device),
        "B11 sum_flat_cuda": lambda: sm.sum_flat_cuda(x, e, 3),
        "B3 round_scaled_terms_cuda": lambda: rk.round_scaled_terms_cuda(
            rel, sm.frame_positions(3), e, 1 - 96),
        "window pass + flag (1 sync)": lambda: bool(
            sm.sum_bits_mxu(x, e, 3, True)[1]),
        "B2b exsum_bits_cuda": lambda: sk.exsum_bits_cuda(x),
        "dot public": lambda: xt.exdot_bits(a, b),
        "B12 dot_flat_cuda": lambda: dm.dot_flat_cuda(a, b, ea, eb),
        "dot window pass + flag (1 sync)": lambda: bool(
            dm.dot_bits_mxu(a, b, ea, eb, True)[1]),
    }
    log(f"host-clock breakdown, n={N_BIG} lognormal bench data [{smi}]: "
        + ", ".join(f"{k} {host_ms(f):.4f} ms" for k, f in parts.items()))


def phase_fast_timing(xt, smi: str) -> dict:
    """CUDA-event times at n = 2^24 on the benchmark data: B11 at each
    window and its window pass (one launch, rounded in its last block)
    beside the two-launch path (B11, then B3), B12 and its window pass
    likewise, B3 alone (and an empty launch, its bound), their plain
    versions, the public ladders per distribution against the exact
    kernels and the native float64 calls, and the ladder against the exact
    kernel from n = 2^16 to 2^22 on lognormal data."""
    from exblas_tpu_torch.ops.exdot import _exdot_bits_mxu_auto
    from exblas_tpu_torch.ops.exsum import _exsum_bits_mxu_auto
    from exblas_tpu_torch.ops.kernels import dot_kernel as dk
    from exblas_tpu_torch.ops.kernels import dot_mxu as dm
    from exblas_tpu_torch.ops.kernels import round_in_kernel as rk
    from exblas_tpu_torch.ops.kernels import sum_kernel as sk
    from exblas_tpu_torch.ops.kernels import sum_mxu as sm

    out = {}
    sums = bench_sum_data(xt, N_BIG)
    dots = bench_dot_data(xt, N_BIG)
    with uncounted():
        x = torch.from_numpy(sums["lognormal"]).cuda()
        a, b = (torch.from_numpy(v).cuda() for v in dots["lognormal"])
        _exsum_bits_mxu_auto(x, True)
        nwa_main = int(_exsum_bits_mxu_auto.route[0][3:])
        e = sm.exact_anchor(x)
        t_lib = time_ms(lambda: torch.sum(x))
        for nwa in (3, 4, 5):
            pos = sm.frame_positions(nwa)
            t_k = time_ms(lambda: sm.sum_flat_cuda(x, e, nwa))
            t_w = time_ms(lambda: sm.sum_bits_mxu(x, e, nwa, True))
            t_2 = time_ms(lambda: rk.round_scaled_terms_cuda(
                sm.sum_flat_cuda(x, e, nwa)[0], pos, e, 1 - 32 * nwa))
            log(f"time n={N_BIG} lognormal B11 sum_flat_cuda nwa={nwa}: "
                f"{t_k:.4f} ms ({8 * N_BIG / (t_k * 1e-3) / 1e9:.1f} GB/s); "
                f"window pass sum_bits_mxu (one launch) {t_w:.4f} ms; "
                f"two-launch path (B11, then B3) {t_2:.4f} ms; torch.sum "
                f"{t_lib:.4f} ms [{smi}]")
            if nwa == nwa_main:
                t_p = time_ms(lambda: sm.sum_flat_torch(x, e, nwa), reps=3,
                              inner=1)
                out["sum_flat_cuda"] = dict(
                    ms=t_k, plain_ms=t_p, bound_ms=8 * N_BIG / HBM_BYTES * 1e3,
                    bound_by="bytes", library_ms=t_lib, shape=[N_BIG],
                    library="torch.sum", window_bits=32 * nwa,
                    window_pass_ms=t_w)
        ea, eb = sm.exact_anchor(a), sm.exact_anchor(b)
        dpos = sm.frame_positions(dm.FRAME_WORDS)
        t_k = time_ms(lambda: dm.dot_flat_cuda(a, b, ea, eb))
        t_w = time_ms(lambda: dm.dot_bits_mxu(a, b, ea, eb, True))
        t_2 = time_ms(lambda: rk.round_scaled_terms_cuda(
            dm.dot_flat_cuda(a, b, ea, eb)[0], dpos, ea + eb,
            dm.FRAME_OFFSET))
        t_p = time_ms(lambda: dm.dot_flat_torch(a, b, ea, eb), reps=3, inner=1)
        t_lib = time_ms(lambda: torch.dot(a, b))
        out["dot_flat_cuda"] = dict(
            ms=t_k, plain_ms=t_p, bound_ms=16 * N_BIG / HBM_BYTES * 1e3,
            bound_by="bytes", library_ms=t_lib, shape=[N_BIG],
            library="torch.dot", window_pass_ms=t_w)
        log(f"time n={N_BIG} lognormal B12 dot_flat_cuda: {t_k:.4f} ms "
            f"({16 * N_BIG / (t_k * 1e-3) / 1e9:.1f} GB/s), plain {t_p:.3f} ms,"
            f" window pass dot_bits_mxu (one launch) {t_w:.4f} ms, two-launch "
            f"path (B12, then B3) {t_2:.4f} ms, torch.dot {t_lib:.4f} ms "
            f"[{smi}]")
        rel, _ = sm.sum_flat_cuda(x, e, nwa_main)
        pos = sm.frame_positions(nwa_main)
        t_k = time_ms(lambda: rk.round_scaled_terms_cuda(
            rel, pos, e, 1 - 32 * nwa_main), reps=7, inner=50)
        t_p = time_ms(lambda: rk.round_scaled_terms_torch(
            rel, pos, e, 1 - 32 * nwa_main), reps=3, inner=5)
        t_empty = time_ms(lambda: torch.cuda._sleep(0), reps=7, inner=50)
        out["round_scaled_terms_cuda"] = dict(
            ms=t_k, plain_ms=t_p, bound_ms=t_empty,
            bound_by="operations", library_ms=None, shape=[len(pos)],
            library=None)
        log(f"time B3 round_scaled_terms_cuda ({len(pos)} terms): "
            f"{t_k:.4f} ms, plain {t_p:.3f} ms, empty launch "
            f"(torch.cuda._sleep(0)) {t_empty:.4f} ms [{smi}]")

        for dist, x_np in sums.items():
            x = torch.from_numpy(x_np).cuda()
            xt.exsum_bits(x)
            route = _exsum_bits_mxu_auto.route
            syncs = count_syncs(lambda: xt.exsum_bits(x))
            t_pub = time_ms(lambda: xt.exsum_bits(x))
            t_b2 = time_ms(lambda: sk.exsum_bits_cuda(x))
            t_lib = time_ms(lambda: torch.sum(x))
            log(f"time n={N_BIG} bench {dist} public xt.exsum_bits: "
                f"{t_pub:.4f} ms, route {route}, {syncs} host syncs; B2b "
                f"exsum_bits_cuda {t_b2:.4f} ms; torch.sum {t_lib:.4f} ms "
                f"[{smi}]")
        for dist, (a_np, b_np) in dots.items():
            a = torch.from_numpy(a_np).cuda()
            b = torch.from_numpy(b_np).cuda()
            xt.exdot_bits(a, b)
            route = _exdot_bits_mxu_auto.route
            syncs = count_syncs(lambda: xt.exdot_bits(a, b))
            t_pub = time_ms(lambda: xt.exdot_bits(a, b))
            t_b4 = time_ms(lambda: dk.exdot_bits_cuda(a, b))
            t_lib = time_ms(lambda: torch.dot(a, b))
            log(f"time n={N_BIG} bench {dist} public xt.exdot_bits: "
                f"{t_pub:.4f} ms, route {route}, {syncs} host syncs; B4b "
                f"exdot_bits_cuda {t_b4:.4f} ms; torch.dot {t_lib:.4f} ms "
                f"[{smi}]")

        ladder_breakdown(xt, sums["lognormal"], dots["lognormal"], smi)

        for lg in (16, 18, 20, 22):
            n = 1 << lg
            x = torch.from_numpy(xt.init_lognormal(n, 1.0, 2.0, seed=10)).cuda()
            a = torch.from_numpy(xt.init_lognormal(n, 1.0, 2.0, seed=11)).cuda()
            b = torch.from_numpy(xt.init_lognormal(n, 1.0, 2.0, seed=12)).cuda()
            t_ls = time_ms(lambda: _exsum_bits_mxu_auto(x, True))
            t_es = time_ms(lambda: sk.exsum_bits_cuda(x))
            t_ld = time_ms(lambda: _exdot_bits_mxu_auto(a, b, True))
            t_ed = time_ms(lambda: dk.exdot_bits_cuda(a, b))
            log(f"time n=2^{lg} lognormal: sum ladder {t_ls:.4f} ms "
                f"{_exsum_bits_mxu_auto.route} vs B2b {t_es:.4f} ms; dot "
                f"ladder {t_ld:.4f} ms {_exdot_bits_mxu_auto.route} vs B4b "
                f"{t_ed:.4f} ms [{smi}]")
    return out


# ---------------------------------------------------------------------------
# ExGEMM
# ---------------------------------------------------------------------------

GEMM_SHAPES = ((1, 1, 1), (5, 7, 9), (17, 130, 33), (128, 256, 128),
               (257, 1000, 129))
GEMM_DISTS = ("narrow", "mixed", "wide", "very_wide", "subnormal",
              "overflow", "edge", "cancellation", "nan", "inf",
              "inf_times_zero", "both_inf")
# covered data without specials: the slice kernel must give B5's bits
GEMM_COVERED = ("narrow", "mixed", "wide", "very_wide", "overflow", "edge")
# rungs (8, 8) and (16, 16) with k above one exact chunk (two launches
# and their words), on distributions each covers
B6_LONG_K = (((8, 8), (257, 8192 + 33, 129), ("narrow", "edge")),
             ((16, 16), (129, 2 * 4096 + 65, 65), ("edge", "wide")))
# rungs held besides every wgmma rung of gemm_mxu.WG_RUNGS: wg88's and one
# of the mma.sync class kernel
GEMM_RUNGS = ((8, 8), (40, 40))
# B5's tile is 16 x 16 and its k chunk 32: ragged shapes, k = 1 included
B5_WIDE_SHAPES = ((33, 1, 47), (40, 65, 31), (70, 300, 50))
# signed data whose sums change sign, which B5's biased words must absorb
B5_SIGNED = ("signed600", "tiny", "alternating")
# more row tiles than a grid's y extent (65535) may hold
B5_TALL = ((1 << 20) + 17, 3, 2)
BETA_MODES = (("one", 1.0), ("general", -0.75), ("zero", 0.0))
TRANS = ("NN", "TN", "NT", "TT")
N_GEMM = 4096
ONE_BITS = s64(1.0)


def rand_mat(m: int, n: int, lo: int, hi: int, seed: int,
             signed: bool = True) -> np.ndarray:
    """Doubles with uniform significands and exponents in [lo, hi)."""
    rs = np.random.RandomState(seed)
    x = (1.0 + rs.rand(m, n)) * np.exp2(rs.randint(lo, hi, size=(m, n)))
    if signed:
        x *= np.where(rs.rand(m, n) < 0.5, -1.0, 1.0)
    return x


def edge_mat(m: int, n: int, top: int, seed: int) -> np.ndarray:
    """Doubles whose leading bits lie in [top - 11, top], with odd
    significands: 64 bits from the largest leading bit to the lowest lsb,
    the coverage edge of GEMM rung (8, 8) and GEMV rung (2, 2).  Every
    eighth is +-(2 - 2^-52) 2^top, whose top byte carries into the carry
    digit; signs are random."""
    rs = np.random.RandomState(seed)
    frac = rs.randint(0, 1 << 52, size=(m, n), dtype=np.int64) | 1
    e = rs.randint(top - 11, top + 1, size=(m, n)).astype(np.int64)
    x = (((e + 1023) << 52) | frac).view(np.float64)
    x = np.where(rs.rand(m, n) < 0.125, (2.0 - 2.0 ** -52) * 2.0 ** top, x)
    return x * np.where(rs.rand(m, n) < 0.5, -1.0, 1.0)


def gemm_case(dist: str, m: int, k: int, n: int, seed: int):
    """(a (m, k), b (k, n), c (m, n)) of distribution ``dist``."""
    rs = np.random.RandomState(seed)
    c = rand_mat(m, n, 0, 10, seed + 2)
    if dist == "overflow":  # products near 2^1030: most sums overflow
        return (rand_mat(m, k, 505, 515, seed),
                rand_mat(k, n, 505, 515, seed + 1), c)
    if dist == "edge":  # the recode's edge cases
        return edge_mat(m, k, 5, seed), edge_mat(k, n, -3, seed + 1), c
    spans = {"narrow": (0, 10, 0, 10), "mixed": (0, 10, -20, 20),
             "wide": (-35, 35, -35, 35), "very_wide": (-130, 130, -130, 130),
             "subnormal": (-545, -535, -545, -535)}
    if dist in spans:
        la, ha, lb, hb = spans[dist]
        a = rand_mat(m, k, la, ha, seed)
        b = rand_mat(k, n, lb, hb, seed + 1)
        if dist == "subnormal":  # products near and below 2^-1074
            c = np.zeros((m, n))
        return a, b, c
    if dist == "cancellation":  # [x, -x] @ [y; y] == 0 exactly: +0.0
        if k == 1:
            return np.zeros((m, 1)), np.ones((1, n)), np.zeros((m, n))
        h = k // 2
        x = rand_mat(m, h, -30, 30, seed)
        y = rand_mat(h, n, -30, 30, seed + 1)
        a = np.concatenate([x, -x, np.zeros((m, k - 2 * h))], axis=1)
        b = np.concatenate([y, y, np.zeros((k - 2 * h, n))], axis=0)
        return a, b, np.zeros((m, n))
    a = rand_mat(m, k, 0, 10, seed)
    b = rand_mat(k, n, 0, 10, seed + 1)
    i, kk, j = rs.randint(0, m), rs.randint(0, k), rs.randint(0, n)
    if dist == "nan":  # a NaN with a payload and the sign set
        a[i, kk] = np.array([0xFFF0000000000123], np.uint64).view(
            np.float64)[0]
    elif dist == "inf":
        a[i, kk] = np.inf
        b[rs.randint(0, k), j] = -np.inf
    elif dist == "inf_times_zero":
        a[i, kk] = np.inf
        b[kk, :] = 0.0
    elif dist == "both_inf":
        a[i, :] = np.inf
        b[:, j] = np.where(np.arange(k) % 2 == 0, 1.0, -1.0)
    else:
        raise ValueError(dist)
    return a, b, c


def b5_signed_pair(dist: str, m: int, k: int, n: int, seed: int):
    """(z (m, k), b (k, n)) of signed data whose exact sums change sign:
    600 binades each way, tiny zero-mean values (products near 2^-2110,
    in the accumulator's lowest word), or z[i, k] = -(-1)^k t against
    b = t, t = 2^-1060, so that every product takes the sum across
    zero."""
    if dist == "signed600":
        return (rand_mat(m, k, -300, 300, seed),
                rand_mat(k, n, -300, 300, seed + 1))
    if dist == "tiny":
        return (rand_mat(m, k, -1060, -1050, seed),
                rand_mat(k, n, -1060, -1050, seed + 1))
    if dist == "alternating":
        t = 2.0 ** -1060
        sign = np.where(np.arange(k) % 2 == 0, -1.0, 1.0)
        return np.tile(sign * t, (m, 1)), np.full((k, n), t)
    raise ValueError(dist)


def cuda_bits(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float64)).cuda().view(
        torch.int64)


def mismatch_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """0.0 if the bit patterns agree, else the largest |difference| of the
    values that differ (inf where a difference is not finite)."""
    bad = got != want
    if not bool(bad.any()):
        return 0.0
    d = (got[bad].view(torch.float64) - want[bad].view(torch.float64)).abs()
    d = torch.where(torch.isnan(d), torch.full_like(d, math.inf), d)
    return max(float(d.max()), 1e-300)


def phase_gemm_kernels(xt) -> dict:
    """B5 and B6 against their plain versions on the card, and the public
    entry on the kernels against the public entry on the plain path."""
    from exblas_tpu_torch.ops.exgemm import (_c_cover_bounds, _mxu_c_cover,
                                             plan_gemm)
    from exblas_tpu_torch.ops.kernels import gemm_kernel as gk
    from exblas_tpu_torch.ops.kernels import gemm_mxu as gm

    errs = {"gemm_bits_cuda": 0.0, "gemm_bits_mxu_cuda": 0.0}
    failures = []
    n_rungs = n_turns = 0
    for si, (m, k, n) in enumerate(GEMM_SHAPES):
        for di, dist in enumerate(GEMM_DISTS):
            seed = SEED + 1000 * si + 31 * di
            a_np, b_np, c_np = gemm_case(dist, m, k, n, seed)
            mode, beta = BETA_MODES[(si + di) % 3]
            tr = TRANS[(si + 2 * di) % 4]
            za, zb, zc = cuda_bits(a_np), cuda_bits(b_np), cuda_bits(c_np)
            bb = s64(beta)
            line = [f"gemm {m}x{k}x{n} {dist} {mode} {tr}:"]
            ek = gk.gemm_bits_cuda(za, zb, zc, bb, mode)
            ep = gk.gemm_bits_torch(za, zb, zc, bb, mode)
            e = mismatch_err(ek, ep)
            errs["gemm_bits_cuda"] = max(errs["gemm_bits_cuda"], e)
            line.append(f"B5 {'==' if e == 0 else '!='}")
            if e != 0:
                failures.append(f"B5 {m}x{k}x{n} {dist} {mode}")
            if dist == "cancellation" and bool((ek != 0).any()):
                failures.append(f"B5 {m}x{k}x{n} cancellation is not +0.0")
            ea, fb, sp_a, sp_b, _ = gm.analyze_gemm_operands(za, zb)
            ea0 = torch.where(ea < -9000, 0, ea)
            fb0 = torch.where(fb < -9000, 0, fb)
            lo, hi = (_c_cover_bounds(zc, bb, ea0, fb0) if mode != "zero"
                      else (torch.tensor(0), torch.tensor(0)))
            sp_a, sp_b, lo, hi = (int(sp_a), int(sp_b), int(lo), int(hi))
            for sa, sb in (GEMM_RUNGS[0], *gm.WG_RUNGS, *GEMM_RUNGS[1:]):
                if not (sp_a <= 8 * sa and sp_b <= 8 * sb
                        and _mxu_c_cover(lo, hi, sa, sb)):
                    continue  # uncovered: the dispatcher never sends it
                kw = dict(ea=ea0, fb=fb0)
                mk = gm.gemm_bits_mxu_cuda(za, zb, zc, bb, mode, sa, sb, **kw)
                mp = gm.gemm_bits_mxu_torch(za, zb, zc, bb, mode, sa, sb,
                                            **kw)
                e = mismatch_err(mk, mp)
                dk = gm.mxu_operands_cuda(za, zb, sa, sb, **kw)
                dp = gm.mxu_operands(za, zb, sa, sb, **kw)
                if not (torch.equal(dk.ad, dp.ad)
                        and torch.equal(dk.bd, dp.bd)):
                    failures.append(f"digits ({sa},{sb}) {m}x{k}x{n} {dist}")
                errs["gemm_bits_mxu_cuda"] = max(errs["gemm_bits_mxu_cuda"],
                                                 e)
                n_rungs += 1
                line.append(f"B6({sa},{sb}) {'==' if e == 0 else '!='}")
                if e != 0:
                    failures.append(f"B6 ({sa},{sb}) {m}x{k}x{n} {dist}")
                if dist in GEMM_COVERED and not torch.equal(mk, ek):
                    failures.append(f"B6 != B5 ({sa},{sb}) {m}x{k}x{n} "
                                    f"{dist}")
                if si == len(GEMM_SHAPES) - 1:
                    # the wgmma rungs one launch a chunk of 64 k, their
                    # words carried between launches; the wider rungs'
                    # class sums in turns of 64 rows, as a large m x n
                    # takes them
                    wg = (sa, sb) == (8, 8) or (sa, sb) in gm.WG_RUNGS
                    name, small = ("K_CHUNK", 64) if wg else ("CLS_BYTES", 1)
                    whole = getattr(gm, name)
                    setattr(gm, name, small)
                    try:
                        mt = gm.gemm_bits_mxu_cuda(za, zb, zc, bb, mode, sa,
                                                   sb, **kw)
                    finally:
                        setattr(gm, name, whole)
                    n_turns += 1
                    same = torch.equal(mt, mk)
                    line.append(f"{name} {small} {'==' if same else '!='}")
                    if not same:
                        failures.append(f"B6 ({sa},{sb}) {m}x{k}x{n} {dist} "
                                        f"{name} {small}")
            # the public entry: transposes, the ladder and the override
            sa_np = a_np.T.copy() if tr[0] == "T" else a_np
            sb_np = b_np.T.copy() if tr[1] == "T" else b_np
            args = (tr[0], tr[1], 1.0, torch.from_numpy(sa_np).cuda(),
                    torch.from_numpy(sb_np).cuda())
            kw = dict(beta=beta, c=torch.from_numpy(c_np).cuda())
            pk = xt.exgemm_bits(*args, impl="cuda", **kw)
            pp = xt.exgemm_bits(*args, impl="torch", **kw)
            if not torch.equal(pk, pp) or not torch.equal(pk, ek):
                failures.append(f"public {m}x{k}x{n} {dist} {tr}")
            line.append(f"public {'==' if torch.equal(pk, pp) else '!='}")
            log(" ".join(line))
    # k above one exact chunk, every beta mode
    for (sa, sb), (m, k, n), dists in B6_LONG_K:
        for di, dist in enumerate(dists):
            a_np, b_np, c_np = gemm_case(dist, m, k, n, SEED + 95 + di)
            za, zb, zc = cuda_bits(a_np), cuda_bits(b_np), cuda_bits(c_np)
            for mode, beta in BETA_MODES:
                bb = s64(beta)
                mk = gm.gemm_bits_mxu_cuda(za, zb, zc, bb, mode, sa, sb)
                e = mismatch_err(mk, gm.gemm_bits_mxu_torch(
                    za, zb, zc, bb, mode, sa, sb))
                errs["gemm_bits_mxu_cuda"] = max(errs["gemm_bits_mxu_cuda"],
                                                 e)
                same5 = torch.equal(mk, gk.gemm_bits_cuda(za, zb, zc, bb,
                                                          mode))
                log(f"B6 ({sa}, {sb}) {m}x{k}x{n} {dist} {mode} (k above one "
                    f"chunk of {gm.wg_chunk(sa, sb)}): "
                    f"{'==' if e == 0 else '!='} plain, "
                    f"{'==' if same5 else '!='} B5")
                if e != 0 or not same5:
                    failures.append(f"B6 ({sa}, {sb}) {m}x{k}x{n} {dist} "
                                    f"{mode}")
    n_wide = 0
    for si, (m, k, n) in enumerate(B5_WIDE_SHAPES):
        # a 600-binade pair: no rung covers it, so only B5 ever takes it
        a_np = xt.init_fpuniform_matrix(m, k, 600, -300, seed=si + 61)
        b_np = xt.init_fpuniform_matrix(k, n, 600, -300, seed=si + 62)
        c_np = rand_mat(m, n, -10, 10, SEED + 63 + si)
        za, zb, zc = cuda_bits(a_np), cuda_bits(b_np), cuda_bits(c_np)
        for mode, beta in BETA_MODES:
            bb = s64(beta)
            # one element a row is no spread: k = 1 may take a rung
            if k > 1 and plan_gemm(za, zb, zc, bb, mode).rung is not None:
                failures.append(f"600-binade {m}x{k}x{n} {mode} took a rung")
            e = mismatch_err(gk.gemm_bits_cuda(za, zb, zc, bb, mode),
                             gk.gemm_bits_torch(za, zb, zc, bb, mode))
            errs["gemm_bits_cuda"] = max(errs["gemm_bits_cuda"], e)
            if e != 0:
                failures.append(f"B5 600-binade {m}x{k}x{n} {mode}")
            n_wide += 1
    for si, (m, k, n) in enumerate(B5_WIDE_SHAPES):
        for di, dist in enumerate(B5_SIGNED):
            a_np, b_np = b5_signed_pair(dist, m, k, n, SEED + 70 + 3 * si
                                        + 11 * di)
            c_np = rand_mat(m, n, -10, 10, SEED + 64 + si)
            za, zb, zc = cuda_bits(a_np), cuda_bits(b_np), cuda_bits(c_np)
            for mode, beta in BETA_MODES:
                bb = s64(beta)
                e = mismatch_err(gk.gemm_bits_cuda(za, zb, zc, bb, mode),
                                 gk.gemm_bits_torch(za, zb, zc, bb, mode))
                errs["gemm_bits_cuda"] = max(errs["gemm_bits_cuda"], e)
                if e != 0:
                    failures.append(f"B5 {dist} {m}x{k}x{n} {mode}")
                n_wide += 1
    # a tall shape: its row tiles exceed a grid's y extent; the plain
    # version takes it in row turns (a row of C needs its row of z alone)
    m, k, n = B5_TALL
    a_np, b_np, c_np = gemm_case("wide", m, k, n, SEED + 90)
    za, zb, zc = cuda_bits(a_np), cuda_bits(b_np), cuda_bits(c_np)
    bb = s64(-0.75)
    ek = gk.gemm_bits_cuda(za, zb, zc, bb, "general")
    for r in range(0, m, 1 << 18):
        e = mismatch_err(ek[r:r + (1 << 18)], gk.gemm_bits_torch(
            za[r:r + (1 << 18)], zb, zc[r:r + (1 << 18)], bb, "general"))
        errs["gemm_bits_cuda"] = max(errs["gemm_bits_cuda"], e)
        if e != 0:
            failures.append(f"B5 tall {m}x{k}x{n} rows {r}..")
    del za, zb, zc, ek
    torch.cuda.synchronize()
    if failures:
        raise AssertionError(f"GEMM kernel != plain version: {failures}")
    log(f"GEMM kernels vs plain versions: bit-equal (tolerance 0) on "
        f"{len(GEMM_SHAPES)} shapes x {len(GEMM_DISTS)} distributions, "
        f"{n_rungs} slice-kernel rung runs ({n_turns} of them again with a "
        f"chunk of 64 k at rungs up to (16, 16), in turns of {gm.ROW_TILE} "
        f"rows at the wider ones), B6 with k above one chunk "
        f"({[(r, s) for r, s, _ in B6_LONG_K]}) in every beta mode; B5 also "
        f"on {n_wide} 600-binade and signed {B5_SIGNED} cases (shapes {B5_WIDE_SHAPES}, every "
        f"beta mode; no rung taken by 600 binades where k > 1) and at "
        f"{B5_TALL} (m x k x n, {-(-B5_TALL[0] // 16)} row tiles)")
    return errs


def gemm_bench_data(xt, n: int):
    """The benchmark configuration's operands (bench.py:34-37)."""
    return (xt.init_fpuniform_matrix(n, n, 10, 0, seed=1),
            xt.init_fpuniform_matrix(n, n, 10, 0, seed=2),
            xt.init_fpuniform_matrix(n, n, 10, 0, seed=3))


def phase_gemm_public(xt, bench) -> tuple[dict, dict]:
    """The GEMM main path: ``exgemm`` at n = 4096 on the benchmark data
    (the slice kernel), at n = 1024 on data no rung covers (the exact
    kernel) and on data with specials (the slice kernel and the override).
    Returns the launch counts of this run and, per kernel, the largest
    difference from its plain version on the main path's inputs."""
    from exblas_tpu_torch.ops.exgemm import plan_gemm
    from exblas_tpu_torch.ops.kernels import gemm_kernel as gk
    from exblas_tpu_torch.ops.kernels import gemm_mxu as gm

    a_np, b_np, c_np = bench
    a, b, c = (torch.from_numpy(x).cuda() for x in bench)
    m = 1024
    wa_np = rand_mat(m, m, -300, 300, SEED + 51)   # spread > 384 bits
    wb_np = rand_mat(m, m, -300, 300, SEED + 52)
    wc_np = rand_mat(m, m, -10, 10, SEED + 53)
    xa_np, xb_np, xc_np = (x[:m, :m].copy() for x in bench)
    xa_np[3, 5] = np.inf
    xa_np[7, 9] = np.array([0x7FF0000000000ABC], np.uint64).view(
        np.float64)[0]
    xb_np[5, 11] = 0.0
    xb_np[:, 13] = -1.0
    xc_np[17, 19] = -np.inf
    wa, wb, wc, xa, xb, xc = (torch.from_numpy(x).cuda() for x in
                              (wa_np, wb_np, wc_np, xa_np, xb_np, xc_np))
    wrappers = (gk.gemm_bits_cuda, gm.gemm_bits_mxu_cuda)

    for w in wrappers:
        w.launches = 0
    extra = (gm.gemm_bits_mxu_cuda.class_buffers,
             gm.gemm_bits_mxu_cuda.round_launches)
    bits = xt.exgemm_bits("N", "N", 1.0, a, b, beta=1.0, c=c)
    torch.cuda.synchronize()
    if (gm.gemm_bits_mxu_cuda.launches, gk.gemm_bits_cuda.launches) != (1, 0):
        raise AssertionError("exgemm at n=4096 did not run the slice kernel "
                             "alone")
    if (gm.gemm_bits_mxu_cuda.class_buffers,
            gm.gemm_bits_mxu_cuda.round_launches) != extra:
        raise AssertionError("exgemm at n=4096 (rung (8, 8)) allocated an "
                             "int64 class-sum buffer or launched the "
                             "rounding kernel")
    log("exgemm n=4096, rung (8, 8): no int64 class-sum buffer, no "
        "rounding-kernel launch (rounded in the class kernel's epilogue)")
    wide = xt.exgemm_bits("N", "N", 1.0, wa, wb, beta=1.0, c=wc)
    spec = xt.exgemm_bits("N", "N", 1.0, xa, xb, beta=1.0, c=xc)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    log("GEMM launches on the main path:", launches)
    if launches != {"gemm_bits_cuda": 1, "gemm_bits_mxu_cuda": 2}:
        raise AssertionError(f"unexpected GEMM launches {launches}")
    check_gemm_range50(xt)

    # n = 4096, the benchmark data: rung (8, 8), as B5 gives it, as exact
    # host values give it, and as a permutation of k gives it
    ab, bbits, cb = (x.view(torch.int64) for x in (a, b, c))
    plan = plan_gemm(ab, bbits, cb, ONE_BITS, "one")
    if plan.rung != (8, 8) or plan.override:
        raise AssertionError(f"n={N_GEMM}: plan {plan.rung}, override "
                             f"{plan.override}")
    if not torch.equal(bits, gk.gemm_bits_cuda(ab, bbits, cb, ONE_BITS,
                                               "one")):
        raise AssertionError(f"n={N_GEMM}: slice kernel != exact kernel")
    rs = np.random.RandomState(SEED + 54)
    got = bits.cpu().numpy()
    for i, j in zip(rs.randint(0, N_GEMM, 256), rs.randint(0, N_GEMM, 256)):
        want = exact_dot_host(a_np[i, :], b_np[:, j], [c_np[i, j]])
        if int(got[i, j]) != s64(want):
            raise AssertionError(f"n={N_GEMM} C[{i},{j}]: "
                                 f"{got[i, j]:#x} != exact {want!r}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    perm = torch.randperm(N_GEMM, device="cuda", generator=gen)
    if not torch.equal(bits, xt.exgemm_bits("N", "N", 1.0, a[:, perm],
                                            b[perm, :], beta=1.0, c=c)):
        raise AssertionError(f"n={N_GEMM}: not invariant under a "
                             "permutation of k")
    # each kernel against its plain version on the main path's inputs
    t0 = time.perf_counter()
    errs = {"gemm_bits_mxu_cuda": mismatch_err(bits, gm.gemm_bits_mxu_torch(
                ab, bbits, cb, ONE_BITS, "one", 8, 8)),
            "gemm_bits_cuda": mismatch_err(wide, gk.gemm_bits_torch(
                wa.view(torch.int64), wb.view(torch.int64),
                wc.view(torch.int64), ONE_BITS, "one"))}
    if any(errs.values()):
        raise AssertionError(f"main path != plain versions: {errs}")
    log(f"main path bit-equal to the plain versions: gemm_bits_mxu_torch at "
        f"n={N_GEMM}, gemm_bits_torch at n={m} "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"exgemm n={N_GEMM} beta=1 bench data: rung {plan.rung}, bit-equal "
        "to the exact kernel (all 16.7M elements), to 256 exact host values "
        "and under a permutation of k")

    # n = 1024: too wide for any rung -> the exact kernel; exact host values
    if plan_gemm(wa.view(torch.int64), wb.view(torch.int64),
                 wc.view(torch.int64), ONE_BITS, "one").rung is not None:
        raise AssertionError("wide data found a rung")
    got = wide.cpu().numpy()
    for i, j in zip(rs.randint(0, m, 64), rs.randint(0, m, 64)):
        want = exact_dot_host(wa_np[i, :], wb_np[:, j], [wc_np[i, j]])
        if int(got[i, j]) != s64(want):
            raise AssertionError(f"wide C[{i},{j}]: {got[i, j]:#x} != "
                                 f"exact {want!r}")
    # n = 1024 with specials: the slice kernel plus the override, equal to
    # the exact kernel, which counts the specials itself
    xplan = plan_gemm(xa.view(torch.int64), xb.view(torch.int64),
                      xc.view(torch.int64), ONE_BITS, "one")
    ref = gk.gemm_bits_cuda(xa.view(torch.int64), xb.view(torch.int64),
                            xc.view(torch.int64), ONE_BITS, "one")
    if xplan.rung is None or not xplan.override or not torch.equal(spec, ref):
        raise AssertionError(f"specials: plan {xplan.rung}, override "
                             f"{xplan.override}, equal "
                             f"{torch.equal(spec, ref)}")
    # numpy input runs on the card
    spec_np = xt.exgemm_bits("N", "N", 1.0, xa_np, xb_np, beta=1.0, c=xc_np)
    if spec_np.device.type != "cuda" or not torch.equal(spec_np, spec):
        raise AssertionError("exgemm on numpy input did not run on the card")
    n_nan = int((spec == 0x7FF8000000000000).sum())
    log(f"exgemm n={m}: wide data (spread > 384 bits) took the exact kernel, "
        f"bit-equal to 64 exact host values; data with specials took rung "
        f"{xplan.rung} and the override, bit-equal to the exact kernel "
        f"({n_nan} NaN results, all canonical); the same numpy arrays ran on "
        "the card")
    check_empty_gemm(xt)
    return launches, errs


def check_gemm_range50(xt) -> None:
    """``exgemm`` at n = 4096 on exponents in [0, 50) (the benchmark's
    range50 traffic): rung (16, 16) on the wgmma kernel alone, one launch
    (k = 4096 is one exact chunk), no int64 class-sum buffer and no
    rounding kernel; bit-equal to B5 and to 64 exact host values."""
    from exblas_tpu_torch.ops.exgemm import plan_gemm
    from exblas_tpu_torch.ops.kernels import gemm_kernel as gk
    from exblas_tpu_torch.ops.kernels import gemm_mxu as gm

    w = gm.gemm_bits_mxu_cuda
    data = [xt.init_fpuniform_matrix(N_GEMM, N_GEMM, 50, 0, seed=s)
            for s in (21, 22, 23)]
    a, b, c = (torch.from_numpy(x).cuda() for x in data)
    ab, bbits, cb = (x.view(torch.int64) for x in (a, b, c))
    plan = plan_gemm(ab, bbits, cb, ONE_BITS, "one")
    if plan.rung != (16, 16) or plan.override:
        raise AssertionError(f"range50 n={N_GEMM}: plan {plan.rung}, "
                             f"override {plan.override}")
    before = (w.class_buffers, w.round_launches, w.wg_launches)
    bits = xt.exgemm_bits("N", "N", 1.0, a, b, beta=1.0, c=c)
    torch.cuda.synchronize()
    moved = tuple(x - y for x, y in zip(
        (w.class_buffers, w.round_launches, w.wg_launches), before))
    if moved != (0, 0, 1):
        raise AssertionError(f"range50 n={N_GEMM}: class buffers, rounding "
                             f"and wgmma launches moved by {moved}, not "
                             "(0, 0, 1)")
    if not torch.equal(bits, gk.gemm_bits_cuda(ab, bbits, cb, ONE_BITS,
                                               "one")):
        raise AssertionError(f"range50 n={N_GEMM}: slice kernel != exact "
                             "kernel")
    rs = np.random.RandomState(SEED + 55)
    got = bits.cpu().numpy()
    for i, j in zip(rs.randint(0, N_GEMM, 64), rs.randint(0, N_GEMM, 64)):
        want = exact_dot_host(data[0][i, :], data[1][:, j], [data[2][i, j]])
        if int(got[i, j]) != s64(want):
            raise AssertionError(f"range50 C[{i},{j}]: {got[i, j]:#x} != "
                                 f"exact {want!r}")
    log(f"exgemm n={N_GEMM} range50: rung (16, 16), one wgmma launch, no "
        "int64 class-sum buffer, no rounding-kernel launch; bit-equal to "
        "the exact kernel (all 16.7M elements) and to 64 exact host values")


def check_empty_gemm(xt) -> None:
    """An empty m, n or k (ROADMAP queue C, C3): the rounded beta*C alone
    (zeros without C, an empty array for m or n = 0).  At k = 0 B5 runs
    with an empty loop over k and rounds beta*C in its epilogue, one
    launch a call; its bits, through the public entry and through the
    wrapper, equal the plain version's on the host.  An empty m or n
    launches nothing, and the slice kernel B6 is never taken."""
    from exblas_tpu_torch.ops.exgemm import plan_gemm
    from exblas_tpu_torch.ops.kernels import gemm_kernel as gk
    from exblas_tpu_torch.ops.kernels import gemm_mxu as gm

    before = gk.gemm_bits_cuda.launches, gm.gemm_bits_mxu_cuda.launches
    c_host = torch.arange(15.0, dtype=torch.float64).reshape(5, 3) - 4.0
    cases = b5_calls = 0
    for m, k, n in ((5, 0, 3), (0, 4, 3), (5, 4, 0)):
        a = torch.zeros((m, k), dtype=torch.float64)
        b = torch.zeros((k, n), dtype=torch.float64)
        for beta in (0.0, 1.0, 2.0, math.inf):
            for c in (c_host[:m, :n], None):
                want = xt.exgemm_bits("N", "N", 1.0, a, b, beta, c)
                got = xt.exgemm_bits("N", "N", 1.0, a.cuda(), b.cuda(), beta,
                                     None if c is None else c.cuda())
                mode = ("zero" if beta == 0.0 or c is None else
                        "one" if beta == 1.0 else "general")
                bb = s64(beta)
                ab, b_b = a.view(torch.int64), b.view(torch.int64)
                cb = (torch.zeros((m, n), dtype=torch.int64) if c is None
                      else c.contiguous().view(torch.int64))
                plain = gk.gemm_bits_torch(ab, b_b, cb, bb, mode)
                kern = gk.gemm_bits_cuda(ab.cuda(), b_b.cuda(), cb.cuda(),
                                         bb, mode)
                if (got.device.type != "cuda"
                        or not torch.equal(got.cpu(), want)
                        or not torch.equal(kern.cpu(), plain)
                        or not torch.equal(plain, want.reshape(m, n))):
                    raise AssertionError(f"exgemm ({m}, {k}, {n}) beta "
                                         f"{beta} c {c is not None}: "
                                         f"{got} / {kern} != {want}")
                if plan_gemm(ab, b_b, cb, bb, mode).rung is not None:
                    raise AssertionError(f"exgemm ({m}, {k}, {n}): a rung")
                cases += 1
                b5_calls += 2 * (m * n > 0)
    after = gk.gemm_bits_cuda.launches, gm.gemm_bits_mxu_cuda.launches
    if (after[0] - before[0], after[1] - before[1]) != (b5_calls, 0):
        raise AssertionError(f"exgemm on an empty dimension: launches "
                             f"{before} -> {after}, want {b5_calls} of B5 "
                             "and none of B6")
    log(f"exgemm on an empty m, n or k: {cases} cases (beta 0, 1, 2, inf, "
        "with and without C) bit-equal to the plain path on the host; B5 "
        f"launched {b5_calls} times at k = 0 (public entry and wrapper), "
        "nothing at m or n = 0")


MXU_KERNELS = {
    "gemm": (("gemm_mxu", 0, "B6 class kernel, rung (8, 8)"),
             ("gemm_mxu", 1, "B6 digit kernel, 8 slices"),
             ("gemm_mxu", 2, "B6 digit kernel, other slices")),
    "gemv": (("gemv_mxu", 0, "B9 class kernel, rung (2, 2)"),),
}


def mxu_resources(kind: str) -> None:
    """Registers a thread, local (spilled) bytes and shared memory of the
    int8 kernels of ``kind``, as the runtime reports them; a spill fails
    the run."""
    from exblas_tpu_torch.ops.kernels import _build
    from exblas_tpu_torch.ops.kernels.gemm_mxu import WG_RUNGS

    lib = _build.library()
    out = torch.zeros(4, dtype=torch.int32)
    kernels = MXU_KERNELS[kind]
    if kind == "gemm":  # gemm_mxu_attrs 3 + i: the class kernel of rung i
        kernels += tuple(("gemm_mxu", 3 + i, f"B6 class kernel, rung {r}")
                         for i, r in enumerate(WG_RUNGS))
    for src, which, name in kernels:
        _build.check(getattr(lib, f"{src}_attrs")(which, _build.ptr(out)),
                     f"{src}_attrs")
        regs, local, static, dynamic = out.tolist()
        log(f"{name}: {regs} registers, {local} local bytes, {static} static "
            f"+ {dynamic} dynamic shared bytes")
        if local != 0:
            raise AssertionError(f"{name} spills {local} bytes")


def phase_gemm_timing(xt, smi: str, bench) -> dict:
    """n = 4096, beta = 1, the benchmark data: the plan, the slice kernel
    (and its digit, class and rounding launches apart), the public entry,
    the exact kernel (also on a 600-binade pair no rung covers, and its
    rounding apart, at k = 32) and the float64 control; the plain versions
    at (257, 1000, 129)."""
    from exblas_tpu_torch.ops.kernels import _build
    from exblas_tpu_torch.ops.kernels import gemm_kernel as gk
    from exblas_tpu_torch.ops.kernels import gemm_mxu as gm

    mxu_resources("gemm")
    n = N_GEMM
    a, b, c = (torch.from_numpy(x).cuda() for x in bench)
    ab, bbits, cb = (x.view(torch.int64) for x in (a, b, c))
    flops = 2.0 * n ** 3

    def rate(t_ms):
        return f"{t_ms:.3f} ms ({flops / (t_ms * 1e-3) / 1e12:.3f} " \
            "TFLOP-equiv/s)"

    out = {}
    from exblas_tpu_torch.ops.exgemm import plan_gemm

    t_plan = time_ms(lambda: plan_gemm(ab, bbits, cb, ONE_BITS, "one"),
                     reps=3, inner=1)
    plan = plan_gemm(ab, bbits, cb, ONE_BITS, "one")
    anchors = dict(ea=plan.ea0, fb=plan.fb0)
    t_prep = time_ms(lambda: gm.mxu_operands_cuda(ab, bbits, 8, 8), reps=3,
                     inner=1)
    t_digits = time_ms(lambda: gm.mxu_operands_cuda(ab, bbits, 8, 8,
                                                    **anchors),
                       reps=3, inner=1)
    # the digit kernel on A, and on B with B's transposed copy
    t_dig_a = time_ms(lambda: gm._digits_cuda(ab, plan.ea0, n, n, 8))
    t_dig_b = time_ms(lambda: gm._digits_cuda(bbits.t(), plan.fb0, n, n, 8))
    t_prep_plain = time_ms(lambda: gm.mxu_operands(ab, bbits, 8, 8), reps=3,
                           inner=1)
    ops = gm.mxu_operands_cuda(ab, bbits, 8, 8, **anchors)
    t_b6 = time_ms(lambda: gm.gemm_bits_mxu_cuda(ab, bbits, cb, ONE_BITS,
                                                 "one", 8, 8, **anchors),
                   reps=5, inner=1)
    # the class kernel with its epilogue alone: one launch, k = one chunk
    lib = _build.library()
    n_pad, k_pad = ops.bd.shape[1], ops.ad.shape[2]
    outb = torch.empty((n, n), dtype=torch.int64, device="cuda")
    stream = _build.stream_of(a.device)
    t_cls = time_ms(lambda: _build.check(lib.mxu_gemm88_cuda(
        _build.ptr(ops.ad), _build.ptr(ops.bd), n_pad, n_pad, k_pad, 0,
        k_pad, _build.ptr(ops.ea), _build.ptr(ops.fb), _build.ptr(cb),
        ONE_BITS, 1, n, n, None, 1, 1, _build.ptr(outb), stream),
        "mxu_gemm88_cuda"), reps=5, inner=1)
    del outb
    # rung (16, 16) on exponents in [0, 50): the wgmma kernel with its
    # epilogue, the whole wrapper, and the mma.sync path it replaced
    wa, wb, wc = (cuda_bits(xt.init_fpuniform_matrix(n, n, 50, 0, seed=s))
                  for s in (21, 22, 23))
    plan16 = plan_gemm(wa, wb, wc, ONE_BITS, "one")
    ops16 = gm.mxu_operands_cuda(wa, wb, 16, 16, ea=plan16.ea0,
                                 fb=plan16.fb0)
    out16 = torch.empty((n, n), dtype=torch.int64, device="cuda")
    old16 = torch.empty_like(out16)
    t_wide = time_ms(lambda: gm._gemm_wide_cuda(ops16, wc, 1, ONE_BITS,
                                                out16), reps=5, inner=1)
    t_b6_16 = time_ms(lambda: gm.gemm_bits_mxu_cuda(
        wa, wb, wc, ONE_BITS, "one", 16, 16, ea=plan16.ea0, fb=plan16.fb0),
        reps=3, inner=1)
    t_sync16 = time_ms(lambda: gm._gemm_classes_cuda(
        ops16, wc, 1, ONE_BITS, "one", old16), reps=1, inner=1)
    if not torch.equal(out16, old16):
        raise AssertionError("rung (16, 16): wgmma kernel != mma.sync path")
    del wa, wb, wc, ops16, out16, old16
    t_pub = time_ms(lambda: xt.exgemm_bits("N", "N", 1.0, a, b, beta=1.0,
                                           c=c), reps=3, inner=1)
    t_b5 = time_ms(lambda: gk.gemm_bits_cuda(ab, bbits, cb, ONE_BITS, "one"),
                   reps=2, inner=1)
    # B5 on data of other kinds, with the bench data's c: the 600-binade
    # pair of bench.py's generator (all positive), the signed pairs of
    # b5_signed_pair, and a 2000-binade pair of the same generator, whose
    # exponents past 1023 make about half of its elements +Inf
    b5_data = {"600binade": (
        xt.init_fpuniform_matrix(n, n, 600, -300, seed=11),
        xt.init_fpuniform_matrix(n, n, 600, -300, seed=12))}
    for di, dist in enumerate(B5_SIGNED):
        b5_data[dist] = b5_signed_pair(dist, n, n, n, SEED + 80 + 2 * di)
    with np.errstate(over="ignore"):
        b5_data["2000binade"] = (
            xt.init_fpuniform_matrix(n, n, 2000, -1000, seed=13),
            xt.init_fpuniform_matrix(n, n, 2000, -1000, seed=14))
    t_b5_data = {}
    for name, (wa_np, wb_np) in b5_data.items():
        wa, wb = cuda_bits(wa_np), cuda_bits(wb_np)
        if name == "600binade" and plan_gemm(wa, wb, cb, ONE_BITS,
                                             "one").rung is not None:
            raise AssertionError("the 600-binade pair found a rung")
        t_b5_data[name] = time_ms(lambda: gk.gemm_bits_cuda(
            wa, wb, cb, ONE_BITS, "one"), reps=2, inner=1)
        del wa, wb
    del b5_data
    a32, b32 = ab[:, :32].contiguous(), bbits[:32, :].contiguous()
    t_b5_k32 = time_ms(lambda: gk.gemm_bits_cuda(a32, b32, cb, ONE_BITS,
                                                 "one"), reps=3, inner=1)
    t_lib = time_ms(lambda: torch.addmm(c, a, b), reps=5, inner=3)
    log(f"time n={n} beta=1 bench data [{smi}]:")
    log(f"  B6 gemm_bits_mxu_cuda rung (8, 8): {rate(t_b6)}; class kernel "
        f"with its epilogue (wgmma, rounded from registers) {t_cls:.3f} ms")
    log(f"  B6 gemm_bits_mxu_cuda rung (16, 16), exponents in [0, 50): "
        f"{rate(t_b6_16)}; class kernel with its epilogue (wgmma) "
        f"{t_wide:.3f} ms, bit-equal to the mma.sync class and rounding "
        f"kernels' {t_sync16:.3f} ms")
    log(f"  B6 preparation (analysis, digits): {t_prep:.3f} ms; the digit "
        f"kernel alone (anchors given): {t_digits:.3f} ms (A {t_dig_a:.4f} "
        f"ms, B with its transposed copy {t_dig_b:.4f} ms); the plain "
        f"preparation: {t_prep_plain:.3f} ms")
    log(f"  plan (analysis, coverage, special flags, one host sync): "
        f"{t_plan:.3f} ms")
    log(f"  public xt.exgemm_bits: {rate(t_pub)}")
    log(f"  B5 gemm_bits_cuda: {rate(t_b5)}; at k=32 (setting up and "
        f"rounding 16.7M elements, 32 products each): {t_b5_k32:.3f} ms")
    for name, t in t_b5_data.items():
        log(f"  B5 gemm_bits_cuda on {name} data: {rate(t)}")
    log(f"  float64 control torch.addmm(c, a, b): {rate(t_lib)}")

    # the plain versions, at a shape where they finish in seconds
    pm, pk, pn = GEMM_SHAPES[-1]
    pa, pb, pc = (cuda_bits(x) for x in gemm_case("narrow", pm, pk, pn, SEED))
    t_p5 = time_ms(lambda: gk.gemm_bits_torch(pa, pb, pc, ONE_BITS, "one"),
                   reps=2, inner=1)
    t_p6 = time_ms(lambda: gm.gemm_bits_mxu_torch(pa, pb, pc, ONE_BITS, "one",
                                                  8, 8),
                   reps=3, inner=1)
    log(f"time {pm}x{pk}x{pn} plain versions [{smi}]: gemm_bits_torch "
        f"{t_p5:.3f} ms, gemm_bits_mxu_torch (8, 8) {t_p6:.3f} ms")

    # bounds: B6 by its int8 operations (or bytes), B5 by instruction issue
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_max_hz()
    ops8 = 2.0 * 81 * n ** 3
    bytes6 = 18.0 * n * n + 16.0 * n * n
    b6_ops, b6_bytes = ops8 / INT8_OPS * 1e3, bytes6 / HBM_BYTES * 1e3
    b6_16 = 2.0 * 289 * n ** 3 / INT8_OPS * 1e3
    b5_issue = B5_INT_OPS * n ** 3 / (INT32_LANES * sms * clock) * 1e3
    b5_bytes = 32.0 * n * n / HBM_BYTES * 1e3
    log(f"bounds n={n}: B6 {b6_ops:.3f} ms by int8 operations "
        f"({b6_bytes:.3f} ms by bytes), at (16, 16) {b6_16:.3f} ms; B5 "
        f"{B5_INT_OPS} int32 operations "
        f"per product -> {b5_issue:.3f} ms at {INT32_LANES} per clock per "
        f"SM on {sms} SMs at {clock / 1e6:.0f} MHz ({b5_bytes:.3f} ms by "
        f"bytes)")
    shape = [n, n, n]
    out["gemm_bits_cuda"] = dict(
        ms=t_b5, ms_by_data=t_b5_data, plain_ms=t_p5,
        bound_ms=max(b5_issue, b5_bytes),
        bound_by="operations" if b5_issue >= b5_bytes else "bytes",
        library_ms=t_lib, shape=shape, plain_shape=[pm, pk, pn])
    out["gemm_bits_mxu_cuda"] = dict(
        ms=t_b6, ms_rung16=t_b6_16, bound_ms_rung16=b6_16,
        plain_ms=t_p6, bound_ms=max(b6_ops, b6_bytes),
        bound_by="operations" if b6_ops >= b6_bytes else "bytes",
        library_ms=t_lib, shape=shape, plain_shape=[pm, pk, pn])
    return out


# ---------------------------------------------------------------------------
# ExGEMV
# ---------------------------------------------------------------------------

GEMV_SHAPES = ((1, 1), (7, 13), (130, 300), (257, 1000), (1000, 257))
# distribution -> exponent ranges of A and x: the narrowest rung each
# reaches (A spread = range + 53 bits)
GEMV_SPANS = {"narrow": (0, 10, 0, 10),           # (2, 2)
              "mixed": (0, 10, -20, 20),          # (3, 3)
              "wide": (-45, 45, -35, 35),         # (5, 4)
              "very_wide": (-98, 99, -60, 60),    # (8, 6)
              "huge": (-220, 220, -30, 30),       # (16, 7)
              "beyond": (-300, 300, -10, 10),     # no rung: B7
              "subnormal": (-545, -535, -545, -535)}
GEMV_DISTS = tuple(GEMV_SPANS) + ("edge", "cancellation", "nan", "inf",
                                  "inf_times_zero", "both_inf")
GEMV_RUNGS = ((2, 2), (3, 3), (5, 4), (8, 6), (16, 7))
N_GEMV = 8192


def gemv_case(dist: str, m: int, k: int, seed: int):
    """(a (m, k), x (k,), y (m,)) of distribution ``dist``."""
    rs = np.random.RandomState(seed)
    y = rand_mat(1, m, 0, 10, seed + 2)[0]
    if dist in GEMV_SPANS:
        la, ha, lx, hx = GEMV_SPANS[dist]
        a = rand_mat(m, k, la, ha, seed)
        x = rand_mat(1, k, lx, hx, seed + 1)[0]
        if dist == "subnormal":  # products near and below 2^-1074
            y = np.zeros(m)
        return a, x, y
    if dist == "edge":  # the recode's edge cases, at rung (2, 2)
        return edge_mat(m, k, 5, seed), edge_mat(1, k, 0, seed + 1)[0], y
    if dist == "cancellation":  # [v, -v] . [w, w] == 0 exactly: +0.0
        h = k // 2
        v = rand_mat(m, h, -30, 30, seed)
        w = rand_mat(1, h, -30, 30, seed + 1)[0]
        a = np.concatenate([v, -v, np.zeros((m, k - 2 * h))], axis=1)
        x = np.concatenate([w, w, np.zeros(k - 2 * h)])
        return a, x, np.zeros(m)
    a = rand_mat(m, k, 0, 10, seed)
    x = rand_mat(1, k, 0, 10, seed + 1)[0]
    i, kk = rs.randint(0, m), rs.randint(0, k)
    if dist == "nan":  # a NaN with a payload and the sign set
        a[i, kk] = np.array([0xFFF0000000000123], np.uint64).view(
            np.float64)[0]
    elif dist == "inf":
        a[i, kk] = np.inf
        a[rs.randint(0, m), rs.randint(0, k)] = -np.inf
        y[rs.randint(0, m)] = -np.inf
    elif dist == "inf_times_zero":
        a[i, kk] = np.inf
        x[kk] = 0.0
    elif dist == "both_inf":
        a[i, :] = np.inf
        x[:] = np.where(np.arange(k) % 2 == 0, 1.0, -1.0)
    else:
        raise ValueError(dist)
    return a, x, y


def gemv_exact_kernel(ab, zb, yb, beta_bits: int, mode: str):
    """B7 and the host-side beta term and rounding: the exact route."""
    from exblas_tpu_torch.ops.exgemv import _apply_beta_rows, round_rows
    from exblas_tpu_torch.ops.kernels import gemv_kernel as vk

    limbs, special = vk.gemv_rows_acc_cuda(ab, zb)
    limbs, special = _apply_beta_rows(limbs, special, beta_bits, yb, mode)
    return round_rows(limbs, special)


def rows_err(acc_k, acc_p) -> int:
    """:func:`same_acc` of two (limbs (m, L), counts (m, 3)) row
    accumulator pairs."""
    from exblas_tpu_torch.core.types import DOT_FORMAT, Superacc

    return same_acc(Superacc(*acc_k, fmt=DOT_FORMAT),
                    Superacc(*acc_p, fmt=DOT_FORMAT))


def phase_gemv_kernels(xt) -> dict:
    """B7, B8 and B9 against their plain versions on the card, and the
    public entry on the kernels against the public entry on the plain
    path."""
    from exblas_tpu_torch.ops.kernels import gemv_kernel as vk
    from exblas_tpu_torch.ops.kernels import gemv_mxu as vm

    errs = {"gemv_rows_acc_cuda": 0.0, "analyze_gemv_rows_cuda": 0.0,
            "gemv_bits_mxu_cuda": 0.0}
    failures = []
    n_rungs = n_chunked = 0
    modes = (("one", 1.0), ("general", -0.75), ("zero", 0.0))
    for si, (m, k) in enumerate(GEMV_SHAPES):
        for di, dist in enumerate(GEMV_DISTS):
            seed = SEED + 2000 + 1000 * si + 31 * di
            a_np, x_np, y_np = gemv_case(dist, m, k, seed)
            mode, beta = modes[(si + di) % 3]
            tr = "NT"[(si + di) % 2]
            ab, zb, yb = cuda_bits(a_np), cuda_bits(x_np), cuda_bits(y_np)
            bb = s64(beta)
            line = [f"gemv {m}x{k} {dist} {mode} {tr}:"]
            # B7: the accumulators as canonical digits, sign and counts
            e = rows_err(vk.gemv_rows_acc_cuda(ab, zb),
                         vk.gemv_rows_acc_torch(ab, zb))
            errs["gemv_rows_acc_cuda"] = max(errs["gemv_rows_acc_cuda"], e)
            line.append(f"B7 {'==' if e == 0 else '!='}")
            if e != 0:
                failures.append(f"B7 {m}x{k} {dist}")
            ek = gemv_exact_kernel(ab, zb, yb, bb, mode)
            if dist == "cancellation" and bool((ek != 0).any()):
                failures.append(f"B7 {m}x{k} cancellation is not +0.0")
            # B8
            gk_ = vm.analyze_gemv_rows_cuda(ab)
            gp_ = vm.analyze_gemv_rows_torch(ab)
            same = all(torch.equal(u, v) for u, v in zip(gk_, gp_))
            if not same:
                errs["analyze_gemv_rows_cuda"] = 1.0
                failures.append(f"B8 {m}x{k} {dist}")
            line.append(f"B8 {'==' if same else '!='}")
            ea, sp_a, _ = gp_
            f, sp_z, _ = vm.analyze_z(zb)
            ea0 = torch.where(ea < -9000, 0, ea)
            f0 = torch.where(f < -9000, 0, f)
            sp_a, sp_z = int(sp_a), int(sp_z)
            # the narrowest rung that covers the data (the dispatcher's
            # choice) and the widest; uncovered rungs are never sent data
            covered = [(nwa, nwz) for nwa, nwz in GEMV_RUNGS
                       if sp_a <= 32 * nwa and sp_z <= 32 * nwz]
            for nwa, nwz in sorted(set(covered[:1] + covered[-1:])):
                args = (ab, zb, ea0, f0, yb, bb, mode, nwa, nwz)
                mk = vm.gemv_bits_mxu_cuda(*args)
                mp = vm.gemv_bits_mxu_torch(*args)
                e = mismatch_err(mk, mp)
                errs["gemv_bits_mxu_cuda"] = max(errs["gemv_bits_mxu_cuda"],
                                                 e)
                n_rungs += 1
                line.append(f"B9({nwa},{nwz}) {'==' if e == 0 else '!='}")
                if e != 0:
                    failures.append(f"B9 ({nwa},{nwz}) {m}x{k} {dist}")
                if (dist in GEMV_SPANS or dist == "edge") and \
                        not torch.equal(mk, ek):
                    failures.append(f"B9 != B7 ({nwa},{nwz}) {m}x{k} {dist}")
                if si == len(GEMV_SHAPES) - 1:
                    # the int32 sums widened every 64 k, not every 2^16
                    whole, vm.K_CHUNK = vm.K_CHUNK, vm.KS
                    try:
                        mc = vm.gemv_bits_mxu_cuda(*args)
                    finally:
                        vm.K_CHUNK = whole
                    n_chunked += 1
                    if not torch.equal(mc, mk):
                        failures.append(f"B9 ({nwa},{nwz}) {m}x{k} {dist} "
                                        "small k chunk")
            # the public entry: trans, the ladder and the override
            a_in = a_np.T.copy() if tr == "T" else a_np
            args = (tr, 1.0, torch.from_numpy(a_in).cuda(),
                    torch.from_numpy(x_np).cuda())
            kw = dict(beta=beta, y=torch.from_numpy(y_np).cuda())
            pk = xt.exgemv_bits(*args, impl="cuda", **kw)
            pp = xt.exgemv_bits(*args, impl="torch", **kw)
            if not torch.equal(pk, pp) or not torch.equal(pk, ek):
                failures.append(f"public {m}x{k} {dist} {tr}")
            line.append(f"public {'==' if torch.equal(pk, pp) else '!='}")
            log(" ".join(line))
    torch.cuda.synchronize()
    if failures:
        raise AssertionError(f"GEMV kernel != plain version: {failures}")
    log(f"GEMV kernels vs plain versions: bit-equal (tolerance 0) on "
        f"{len(GEMV_SHAPES)} shapes x {len(GEMV_DISTS)} distributions, "
        f"{n_rungs} byte-plane rung runs ({n_chunked} of them again with "
        f"the int32 sums widened every {vm.KS} k)")
    return errs


def gemv_bench_data(xt, n: int):
    """The GEMV benchmark configuration's operands
    (benchmarks/bench_gemv.py:29-32)."""
    return (xt.init_fpuniform_matrix(n, n, 10, 0, seed=1),
            xt.init_fpuniform(n, 10, 0, seed=2))


def phase_gemv_public(xt, bench) -> tuple[dict, dict]:
    """The GEMV path at 8192^2: ``exgemv`` on the benchmark data (B8 and
    B9), on a 600-binade A (B7), on data with NaN/Inf (B9 and the
    override), with beta general and with trans "T".  Returns the launch
    counts of this run and, per kernel, the largest difference from its
    plain version on the path's inputs."""
    from exblas_tpu_torch.ops.exgemv import plan_gemv
    from exblas_tpu_torch.ops.kernels import gemv_kernel as vk
    from exblas_tpu_torch.ops.kernels import gemv_mxu as vm

    n = N_GEMV
    a_np, x_np = bench
    a, x = torch.from_numpy(a_np).cuda(), torch.from_numpy(x_np).cuda()
    ab, zb = a.view(torch.int64), x.view(torch.int64)
    wa_np = xt.init_fpuniform_matrix(n, n, 600, -300, seed=SEED + 61)
    wa = torch.from_numpy(wa_np).cuda()
    sa = a.clone()
    sa[3, 5] = math.inf
    sa[7, 9] = float(np.array([0x7FF0000000000ABC], np.uint64).view(
        np.float64)[0])
    sa[11, :] = -math.inf
    sx = x.clone()
    sx[13] = 0.0           # -inf * 0 in row 11: NaN
    y = torch.from_numpy(xt.init_fpuniform(n, 10, 0, seed=3)).cuda()
    beta = -0.75
    wrappers = (vk.gemv_rows_acc_cuda, vm.analyze_gemv_rows_cuda,
                vm.gemv_bits_mxu_cuda)

    for w in wrappers:
        w.launches = 0
    bits = xt.exgemv_bits("N", 1.0, a, x)
    torch.cuda.synchronize()
    first = tuple(w.launches for w in wrappers)
    if first != (0, 1, 1):
        raise AssertionError(f"exgemv at {n}^2 did not run B8 and B9 alone: "
                             f"launches (B7, B8, B9) = {first}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    perm = torch.randperm(n, device="cuda", generator=gen)
    permuted = xt.exgemv_bits("N", 1.0, a[:, perm], x[perm])
    wide = xt.exgemv_bits("N", 1.0, wa, x)
    spec = xt.exgemv_bits("N", 1.0, sa, sx)
    general = xt.exgemv_bits("N", 1.0, a, x, beta=beta, y=y)
    trans = xt.exgemv_bits("T", 1.0, a, x, beta=beta, y=y)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    log("GEMV launches on the path:", launches)
    if launches != {"gemv_rows_acc_cuda": 1, "analyze_gemv_rows_cuda": 6,
                    "gemv_bits_mxu_cuda": 5}:
        raise AssertionError(f"unexpected GEMV launches {launches}")

    # the benchmark data: the plain plan's rung, as B7 gives it, as exact
    # host values give it, and as a permutation of k gives it
    plan = plan_gemv(ab, zb, None, 0, "zero", True)
    plain_plan = plan_gemv(ab, zb, None, 0, "zero", False)
    if plan.rung != plain_plan.rung or plan.rung != (2, 2) or plan.override:
        raise AssertionError(f"{n}^2: plan {plan.rung} (plain "
                             f"{plain_plan.rung}), override {plan.override}")
    if not torch.equal(bits, gemv_exact_kernel(ab, zb, None, 0, "zero")):
        raise AssertionError(f"{n}^2: B9 != B7")
    rs = np.random.RandomState(SEED + 62)
    got = bits.cpu().numpy()
    for i in rs.randint(0, n, 256):
        want = exact_dot_host(a_np[i, :], x_np)
        if int(got[i]) != s64(want):
            raise AssertionError(f"{n}^2 y[{i}]: {got[i]:#x} != exact "
                                 f"{want!r}")
    if not torch.equal(bits, permuted):
        raise AssertionError(f"{n}^2: not invariant under a permutation of "
                             "k")
    log(f"exgemv {n}^2 beta=0 bench data: rung {plan.rung} (the plain plan's"
        "), B8 and B9 once each, B7 never; bit-equal to B7 (all rows), to "
        "256 exact host values and under a permutation of k")

    # a 600-binade A: no rung, B7; exact host values
    wab = wa.view(torch.int64)
    if plan_gemv(wab, zb, None, 0, "zero", True).rung is not None:
        raise AssertionError("600-binade data found a rung")
    got = wide.cpu().numpy()
    for i in rs.randint(0, n, 64):
        want = exact_dot_host(wa_np[i, :], x_np)
        if int(got[i]) != s64(want):
            raise AssertionError(f"wide y[{i}]: {got[i]:#x} != exact "
                                 f"{want!r}")
    # specials: B9 plus the override, equal to B7, which counts them itself
    sab, szb = sa.view(torch.int64), sx.view(torch.int64)
    splan = plan_gemv(sab, szb, None, 0, "zero", True)
    ref = gemv_exact_kernel(sab, szb, None, 0, "zero")
    if splan.rung is None or not splan.override or not torch.equal(spec, ref):
        raise AssertionError(f"specials: plan {splan.rung}, override "
                             f"{splan.override}, equal "
                             f"{torch.equal(spec, ref)}")
    n_nan = int((spec == 0x7FF8000000000000).sum())
    # beta general and trans "T": B7 and the beta term
    bb, yb = s64(beta), y.view(torch.int64)
    at = a.t().contiguous().view(torch.int64)
    for what, got_t, aa in (("beta", general, ab), ("trans T", trans, at)):
        if not torch.equal(got_t, gemv_exact_kernel(aa, zb, yb, bb,
                                                    "general")):
            raise AssertionError(f"{n}^2 {what}: B9 != B7 + beta term")
    # numpy input runs on the card
    spec_np = xt.exgemv_bits("N", 1.0, sa.cpu().numpy(), sx.cpu().numpy())
    if spec_np.device.type != "cuda" or not torch.equal(spec_np, spec):
        raise AssertionError("exgemv on numpy input did not run on the card")
    log(f"exgemv {n}^2: a 600-binade A took B7, bit-equal to 64 exact host "
        f"values; data with NaN/Inf took rung {splan.rung} and the override, "
        f"bit-equal to B7 ({n_nan} NaN rows, canonical); beta={beta} and "
        "trans T bit-equal to B7 with the beta term; numpy input ran on the "
        "card")

    # each kernel against its plain version on the path's inputs
    t0 = time.perf_counter()
    ea_k = vm.analyze_gemv_rows_cuda(ab)
    ea_p = vm.analyze_gemv_rows_torch(ab)
    errs = {
        "analyze_gemv_rows_cuda": 0.0 if all(
            torch.equal(u, v) for u, v in zip(ea_k, ea_p)) else 1.0,
        "gemv_bits_mxu_cuda": mismatch_err(bits, vm.gemv_bits_mxu_torch(
            ab, zb, plan.ea0, plan.f0, None, 0, "zero", *plan.rung)),
        "gemv_rows_acc_cuda": rows_err(vk.gemv_rows_acc_cuda(wab, zb),
                                       vk.gemv_rows_acc_torch(wab, zb))}
    if any(errs.values()):
        raise AssertionError(f"GEMV path != plain versions: {errs}")
    log(f"GEMV path bit-equal to the plain versions: analyze_gemv_rows_torch "
        f"and gemv_bits_mxu_torch on the bench data, gemv_rows_acc_torch on "
        f"the 600-binade A ({time.perf_counter() - t0:.1f} s)")
    return launches, errs


def phase_gemv_timing(xt, smi: str, bench) -> dict:
    """8192^2, the benchmark data: B8, B9 (and its z-digit, class and
    rounding launches apart), the plan, the public entry (beta zero and
    general, trans "T" and its copy), B7 (also on the 600-binade A) and
    the float64 controls; the plain versions at (257, 1000)."""
    from exblas_tpu_torch.ops.exgemv import plan_gemv
    from exblas_tpu_torch.ops.kernels import _build
    from exblas_tpu_torch.ops.kernels import gemm_mxu as gm
    from exblas_tpu_torch.ops.kernels import gemv_kernel as vk
    from exblas_tpu_torch.ops.kernels import gemv_mxu as vm

    mxu_resources("gemv")
    n = N_GEMV
    a, x = (torch.from_numpy(v).cuda() for v in bench)
    y = torch.from_numpy(xt.init_fpuniform(n, 10, 0, seed=3)).cuda()
    ab, zb, yb = (v.view(torch.int64) for v in (a, x, y))
    wa = torch.from_numpy(xt.init_fpuniform_matrix(
        n, n, 600, -300, seed=SEED + 61)).cuda().view(torch.int64)
    beta, bb = -0.75, s64(-0.75)
    plan = plan_gemv(ab, zb, None, 0, "zero", True)
    nwa, nwz = plan.rung
    kw = dict(ea=plan.ea0, f=plan.f0)

    def b9(y_bits=None, beta_bits=0, mode="zero"):
        return vm.gemv_bits_mxu_cuda(ab, zb, kw["ea"], kw["f"], y_bits,
                                     beta_bits, mode, nwa, nwz)

    t = {}
    t["b8"] = time_ms(lambda: vm.analyze_gemv_rows_cuda(ab))
    t["b9"] = time_ms(b9)
    t["b9_beta"] = time_ms(lambda: b9(yb, bb, "general"), reps=5, inner=2)
    # B9's parts, as its wrapper launches them
    _, _, ns, nz, r0, _ = vm._rung_params(nwa, nwz)
    k_pad = n
    f64 = plan.f0.to(torch.int64).reshape(1)
    t["zdig"] = time_ms(lambda: gm._digits_cuda(zb.reshape(1, n), f64, 1,
                                                k_pad, 4 * nwz))
    zd = gm._digits_cuda(zb.reshape(1, n), f64, 1, k_pad, 4 * nwz)
    ea32 = plan.ea0.to(torch.int32).contiguous()
    f32 = plan.f0.to(torch.int32).reshape(1)
    cls = torch.zeros((n, ns + nz), dtype=torch.int64, device="cuda")
    out = torch.empty(n, dtype=torch.int64, device="cuda")
    lib, stream = _build.library(), _build.stream_of(a.device)
    t["cls"] = time_ms(lambda: _build.check(lib.gemv_mxu_classes_cuda(
        _build.ptr(ab), _build.ptr(ea32), _build.ptr(zd), n, n, k_pad, nwa,
        nwz, vm.K_CHUNK, _build.ptr(cls), stream), "gemv_mxu_classes_cuda"))
    t["rnd"] = time_ms(lambda: _build.check(lib.gemv_mxu_round_cuda(
        _build.ptr(cls), ns + nz, _build.ptr(ea32), _build.ptr(f32), None, 0,
        0, n, vm.rel_limbs_count(r0), r0, _build.ptr(out), stream),
        "gemv_mxu_round_cuda"))
    t["plan"] = time_ms(lambda: plan_gemv(ab, zb, None, 0, "zero", True),
                        reps=5, inner=2)
    t["z"] = time_ms(lambda: vm.analyze_z(zb))
    t["pub"] = time_ms(lambda: xt.exgemv_bits("N", 1.0, a, x), reps=5,
                       inner=2)
    t["pub_beta"] = time_ms(lambda: xt.exgemv_bits("N", 1.0, a, x, beta=beta,
                                                   y=y), reps=5, inner=2)
    t["pub_t"] = time_ms(lambda: xt.exgemv_bits("T", 1.0, a, x, beta=beta,
                                                y=y), reps=5, inner=2)
    t["t_copy"] = time_ms(lambda: a.t().contiguous())
    t["b7"] = time_ms(lambda: vk.gemv_rows_acc_cuda(ab, zb), reps=5, inner=2)
    t["b7_wide"] = time_ms(lambda: vk.gemv_rows_acc_cuda(wa, zb), reps=3,
                           inner=1)
    t["mv"] = time_ms(lambda: torch.mv(a, x))
    t["addmv"] = time_ms(lambda: torch.addmv(y, a, x, beta=beta))
    del cls, out, wa
    log(f"time {n}^2 bench data [{smi}]:")
    log(f"  public xt.exgemv_bits beta=0: {t['pub']:.4f} ms; beta={beta}: "
        f"{t['pub_beta']:.4f} ms; trans T, beta={beta}: {t['pub_t']:.4f} ms "
        f"(its copy a.t().contiguous() {t['t_copy']:.4f} ms)")
    log(f"  plan (B8, z analysis, one host sync): {t['plan']:.4f} ms; B8 "
        f"analyze_gemv_rows_cuda {t['b8']:.4f} ms; analyze_z "
        f"{t['z']:.4f} ms")
    log(f"  B9 gemv_bits_mxu_cuda rung {plan.rung} beta=0: {t['b9']:.4f} ms "
        f"(z digits {t['zdig']:.4f} ms, class kernel {t['cls']:.4f} ms, "
        f"rounding kernel {t['rnd']:.4f} ms); beta={beta}: "
        f"{t['b9_beta']:.4f} ms")
    log(f"  B7 gemv_rows_acc_cuda: {t['b7']:.4f} ms on the bench data, "
        f"{t['b7_wide']:.4f} ms on the 600-binade A")
    log(f"  float64 controls: torch.mv {t['mv']:.4f} ms, torch.addmv "
        f"{t['addmv']:.4f} ms")

    # the plain versions, at a shape where they finish in seconds
    pm, pk = 257, 1000
    pa_np, px_np, _ = gemv_case("narrow", pm, pk, SEED)
    pa, px = cuda_bits(pa_np), cuda_bits(px_np)
    pplan = plan_gemv(pa, px, None, 0, "zero", False)
    t_p7 = time_ms(lambda: vk.gemv_rows_acc_torch(pa, px), reps=3, inner=1)
    t_p8 = time_ms(lambda: vm.analyze_gemv_rows_torch(pa), reps=3, inner=1)
    t_p9 = time_ms(lambda: vm.gemv_bits_mxu_torch(
        pa, px, pplan.ea0, pplan.f0, None, 0, "zero", *pplan.rung), reps=3,
        inner=1)
    log(f"time {pm}x{pk} plain versions [{smi}]: gemv_rows_acc_torch "
        f"{t_p7:.3f} ms, analyze_gemv_rows_torch {t_p8:.3f} ms, "
        f"gemv_bits_mxu_torch {pplan.rung} {t_p9:.3f} ms")

    # bounds: A's bytes (z, y and the output are 0.2% of them); the int8
    # operations of B9 and the integer operations of B7's products are far
    # below
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_max_hz()
    bytes_ = 8.0 * n * n + 16.0 * n
    by_bytes = bytes_ / HBM_BYTES * 1e3
    b9_ops = 2.0 * (ns + 1) * nz * n * n / INT8_OPS * 1e3
    b7_ops = B5_INT_OPS * n * n / (INT32_LANES * sms * clock) * 1e3
    log(f"bounds {n}^2: {by_bytes:.4f} ms by A's bytes; B9 rung {plan.rung} "
        f"{b9_ops:.4f} ms by int8 operations; B7 {b7_ops:.4f} ms by "
        f"{B5_INT_OPS} int32 operations per product")
    shape, plain_shape = [n, n], [pm, pk]
    out_ = {}
    for name, ms, plain_ms, ops in (
            ("gemv_rows_acc_cuda", t["b7"], t_p7, b7_ops),
            ("analyze_gemv_rows_cuda", t["b8"], t_p8, 0.0),
            ("gemv_bits_mxu_cuda", t["b9"], t_p9, b9_ops)):
        out_[name] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(by_bytes, ops),
            bound_by="operations" if ops > by_bytes else "bytes",
            library_ms=None if name == "analyze_gemv_rows_cuda" else t["mv"],
            shape=shape, plain_shape=plain_shape,
            library=None if name == "analyze_gemv_rows_cuda" else "torch.mv")
    return out_


# ---------------------------------------------------------------------------
# B7 and B4 on their warp-owned accumulators: geometries, alignments, edges
# ---------------------------------------------------------------------------

ROW_DOT_KERNELS = (("exdot_attrs", (0,), "B4 dot kernel, 16-byte loads"),
                   ("exdot_attrs", (1,), "B4 dot kernel, 8-byte loads"),
                   ("gemv_rows_attrs", (), "B7 row kernel, 8 warps"))
# (m, k) of the row kernel's geometry sweep: k split for small m (m = 1
# up to 2^22), whole rows from 132 * 8 = 1056 rows on; k around the 1024 k
# of a staged chunk of z
B7_SHAPES = ((1, 1), (1, 1 << 22), (3, 1000), (7, 1023), (8, 1024),
             (9, 1025), (1055, 4097), (1056, 3000), (1057, 700))
B4_SIZES = (1, 17, (1 << 20) + 3, N_BIG)
# the starts of a and b, in elements past a 16-byte boundary: both aligned
# (16-byte loads), both 8 bytes off (one element apart, then 16-byte
# loads), and one of each (8-byte loads)
B4_OFFSETS = ((0, 0), (1, 1), (1, 0), (0, 1))


def b7_cases():
    """(name, a (m, k) bits on the card -- some read in place with lda >
    k --, z bits, negate_z) for B7."""
    for i, (m, k) in enumerate(B7_SHAPES):
        seed = SEED + 3000 + 17 * i
        span = (-300, 300) if i % 2 else (-30, 30)  # miss-heavy / window
        yield (f"{m}x{k} range {span[1] - span[0]}",
               cuda_bits(rand_mat(m, k, *span, seed)),
               cuda_bits(rand_mat(1, k, -20, 20, seed + 1)[0]), False)
    # blocks of rows and columns read in place: lda 1501 (rows alternate
    # between 16-byte aligned and 8 bytes off) and 1500 (all 8 bytes off)
    for lda, r0, c0 in ((1501, 5, 7), (1500, 3, 1)):
        big = cuda_bits(rand_mat(300, lda, -200, 200, SEED + lda))
        yield (f"200x1000 in place, lda {lda}, at ({r0}, {c0})",
               big[r0:r0 + 200, c0:c0 + 1000],
               cuda_bits(rand_mat(1, 1000, -50, 50, SEED + 7)[0]), False)
    a = rand_mat(257, 1000, -300, 300, SEED + 8)
    z = rand_mat(1, 1000, -10, 10, SEED + 9)[0]
    yield "257x1000 negate_z", cuda_bits(a), cuda_bits(z), True
    # rows that cancel to +0: [v, -v] . [w, w]
    v = rand_mat(64, 700, -300, 300, SEED + 10)
    w = rand_mat(1, 700, -20, 20, SEED + 11)[0]
    yield ("64x1400 cancelling rows", cuda_bits(np.concatenate([v, -v], 1)),
           cuda_bits(np.concatenate([w, w])), False)
    # NaN (with a payload), +Inf, -Inf, Inf * 0 and both infinities in rows
    a = rand_mat(40, 3000, -300, 300, SEED + 12)
    z = rand_mat(1, 3000, -10, 10, SEED + 13)[0]
    z[17] = 0.0
    a[0, 5] = np.array([0xFFF0000000000123], np.uint64).view(np.float64)[0]
    a[1, 6], a[2, 7] = np.inf, -np.inf
    a[3, 17] = np.inf                   # Inf * 0: NaN
    a[4, 8], a[4, 2999] = np.inf, -np.inf
    a[5, :] = np.inf
    yield "40x3000 specials", cuda_bits(a), cuda_bits(z), False
    # products at the format's two ends: of two subnormals (base limb 0) and
    # of two doubles near 2^1023 (the top limbs)
    rs = np.random.RandomState(SEED + 14)
    sub = rs.randint(1, 1 << 20, size=(33, 2000)) * 5e-324
    yield ("33x2000 subnormal products", cuda_bits(sub),
           cuda_bits(rs.randint(1, 1 << 20, size=2000) * 5e-324), False)
    yield ("33x2000 top products", cuda_bits(rand_mat(33, 2000, 990, 1023,
                                                      SEED + 15)),
           cuda_bits(rand_mat(1, 2000, 990, 1023, SEED + 16)[0]), False)


def b4_cases(xt, n: int):
    """(name, a, b) numpy pairs of n elements for B4."""
    seed = SEED + 4000 + n % 1009
    a = make_input(xt, "wide", n, seed)
    b = make_input(xt, "wide", n, seed + 1)
    yield "wide300", a, b
    sa, sb = a.copy(), b.copy()
    rs = np.random.RandomState(seed + 2)
    sa[rs.randint(0, n)] = np.inf
    sb[rs.randint(0, n)] = -np.inf
    if n > 2:
        sa[n - 1] = np.array([0xFFF0000000000123], np.uint64).view(
            np.float64)[0]
    yield "wide300 with NaN and +-Inf", sa, sb
    h = n // 2
    v = make_input(xt, "wide", h, seed + 3)
    w = make_input(xt, "wide", h, seed + 4)
    yield ("cancellation", np.concatenate([v, -v, np.ones(n % 2)]),
           np.concatenate([w, w, np.zeros(n % 2)]))


def offset_copy(x: np.ndarray, off: int) -> torch.Tensor:
    """x on the card starting ``off`` elements past a 16-byte boundary."""
    buf = torch.empty(x.size + off, dtype=torch.float64, device="cuda")
    out = buf[off:]
    out.copy_(torch.from_numpy(x))
    return out


def phase_rowdot_kernels(xt) -> dict:
    """B7 and B4 bit for bit against their plain versions on the cases
    their warp-owned accumulators add: B7 over its geometries (k split
    for small m), rows read in place, negate_z, cancellation, specials
    and the format's two ends; B4 at every start alignment."""
    from exblas_tpu_torch.ops.exgemv import round_rows
    from exblas_tpu_torch.ops.kernels import dot_kernel as dk
    from exblas_tpu_torch.ops.kernels import gemv_kernel as vk

    kernel_resources(ROW_DOT_KERNELS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {"gemv_rows_acc_cuda": 0.0, "exdot_acc_cuda": 0.0,
            "exdot_bits_cuda": 0.0}
    failures = []
    n_rows = 0
    for name, ab, zb, neg in b7_cases():
        n_rows += 1
        m, k = ab.shape
        geo = vk.row_geometry(m, k, sms)
        got = vk.gemv_rows_acc_cuda(ab, zb, negate_z=neg)
        want = vk.gemv_rows_acc_torch(ab, zb, negate_z=neg)
        e = rows_err(got, want)
        errs["gemv_rows_acc_cuda"] = max(errs["gemv_rows_acc_cuda"], e)
        ok = e == 0
        if "cancelling" in name:
            ok = ok and not bool((round_rows(*got) != 0).any())
        log(f"B7 {name} ({geo.warps} warps, {geo.splits} splits of "
            f"{geo.span} k): {'==' if ok else '!='}")
        if not ok:
            failures.append(f"B7 {name}")
    for n in B4_SIZES:
        for name, a_np, b_np in b4_cases(xt, n):
            a0, b0 = (torch.from_numpy(v).cuda() for v in (a_np, b_np))
            acc_p = dk.exdot_acc_torch(a0, b0)
            bits_p = int(dk.exdot_bits_torch(a0, b0))
            line = [f"B4 n={n} {name}:"]
            for oa, ob in B4_OFFSETS:
                a, b = offset_copy(a_np, oa), offset_copy(b_np, ob)
                bits_k = int(dk.exdot_bits_cuda(a, b))
                e = same_acc(dk.exdot_acc_cuda(a, b), acc_p)
                errs["exdot_bits_cuda"] = max(errs["exdot_bits_cuda"],
                                              bits_err(bits_k, bits_p))
                errs["exdot_acc_cuda"] = max(errs["exdot_acc_cuda"], e)
                ok = bits_k == bits_p and e == 0
                if name == "cancellation" and bits_k != 0:
                    ok = False
                line.append(f"at ({oa},{ob}) {'==' if ok else '!='}")
                if not ok:
                    failures.append(f"B4 n={n} {name} at ({oa},{ob})")
            log(" ".join(line) + f" {u64(bits_p):#018x}")
    torch.cuda.synchronize()
    if failures:
        raise AssertionError(f"B7/B4 != plain version: {failures}")
    log(f"B7 and B4 vs plain versions: bit-equal (tolerance 0) on "
        f"{n_rows} row cases and {len(B4_SIZES)} sizes x 3 data "
        f"x {len(B4_OFFSETS)} alignments")
    return errs


# ---------------------------------------------------------------------------
# ExTRSV
# ---------------------------------------------------------------------------

TRSV_SIZES = (1, 2, 127, 128, 129, 300, 1000)
TRSV_DISTS = ("fpuniform4", "fpuniform600", "lognormal", "subnormal",
              "zero_diag", "specials_b", "nan_ignored", "overflow")
# The distributions also run at n = 300 and 1000: each sequential step of
# the plain version takes milliseconds on the card.
TRSV_LARGE = {300: ("fpuniform600", "zero_diag", "overflow"),
              1000: ("overflow",)}
# These act through the diagonal, so they run non-unit only.
TRSV_NON_UNIT = ("subnormal", "zero_diag", "overflow")
TRSV_BLOCKS = (64, 128)
# sizes at which every (uplo, trans) form of the public entry is held
# against the public entry on the plain path (on the CPU)
TRSV_FORMS_N = (129, 300)
N_TRSV = 8192
N_TRSV_PLAIN = 2048
QNAN_PAYLOAD = float(np.array([0xFFF0000000000123], np.uint64).view(
    np.float64)[0])


def trsv_case(xt, dist: str, n: int, seed: int, unit: bool):
    """(a, b) of distribution ``dist``: T in a's lower triangle."""
    rs = np.random.RandomState(seed)
    if dist == "fpuniform600":
        a = xt.init_fpuniform_tr_matrix("L", "N", n, 600, 300, seed=seed)
        b = xt.init_fpuniform(n, 600, 300, seed=seed + 1)
    elif dist == "lognormal":
        a = xt.init_lognormal_tr_matrix("L", "N", n, 0.0, 2.0, seed=seed)
        b = xt.init_lognormal(n, 0.0, 2.0, seed=seed + 1)
    else:  # the TRSV benchmark's distribution (bench_trsv.py:66,73)
        a = xt.init_fpuniform_tr_matrix("L", "N", n, 4, 0, seed=seed)
        b = xt.init_fpuniform(n, 4, 0, seed=seed + 1)
    if dist == "subnormal":      # x_i ~ 2^-1050 and below
        a[np.diag_indices(n)] *= 2.0 ** 700
        b = xt.init_fpuniform(n, 8, -350, seed=seed + 1)
    elif dist == "zero_diag":    # x_k = +-Inf, NaN further down
        k = n // 3
        a[k, k] = 0.0
        a[k + 1::2, k] = 0.0     # strictly-lower zeros times Inf: NaN
    elif dist == "specials_b":
        b[rs.randint(0, n)] = np.inf
        b[rs.randint(0, n)] = -np.inf
        b[rs.randint(0, n)] = QNAN_PAYLOAD
    elif dist == "nan_ignored":  # never read: the upper part (and a unit
        a[np.triu_indices(n, 0 if unit else 1)] = QNAN_PAYLOAD  # diagonal)
    elif dist == "overflow":     # the benchmark data's overflow, sooner
        a[np.diag_indices(n)] *= 2.0 ** -6
    elif dist not in ("fpuniform4", "fpuniform600", "lognormal"):
        raise ValueError(dist)
    return a, b


def phase_trsv_kernels(xt) -> dict:
    """B10 at both block heights against its plain version.  The plain
    version runs on the host's CPU from the same bits: its n steps are
    sequential, each a few hundred small PyTorch operations, which cost
    about five times less on the CPU than as launches on the card."""
    from exblas_tpu_torch.ops.kernels import trsv_kernel as tk

    err = 0.0
    failures = []
    n_cases = 0
    t0 = time.perf_counter()
    for si, n in enumerate(TRSV_SIZES):
        for di, dist in enumerate(TRSV_LARGE.get(n, TRSV_DISTS)):
            unit = (si + di) % 2 == 1 and dist not in TRSV_NON_UNIT
            seed = SEED + 3000 + 1000 * si + 31 * di
            a_np, b_np = trsv_case(xt, dist, n, seed, unit)
            tb, bb = cuda_bits(a_np), cuda_bits(b_np)
            xp = tk.trsv_lower_x_torch(tb.cpu(), bb.cpu(), unit)
            line = [f"trsv n={n} {dist} {'unit' if unit else 'non-unit'}:"]
            for block in TRSV_BLOCKS:
                xk = tk.trsv_lower_x_cuda(tb, bb, unit, block=block).cpu()
                e = mismatch_err(xk, xp)
                err = max(err, e)
                line.append(f"B10({block}) {'==' if e == 0 else '!='}")
                if e != 0:
                    failures.append(f"B10({block}) n={n} {dist}")
            if dist == "nan_ignored":  # the same bits as without the NaNs
                clean = np.tril(a_np, -1 if unit else 0)
                same = torch.equal(tk.trsv_lower_x_cuda(
                    cuda_bits(clean), bb, unit).cpu(), xp)
                line.append(f"masked {'==' if same else '!='}")
                if not same:
                    failures.append(f"B10 n={n} reads the ignored triangle")
            if n in TRSV_FORMS_N:  # every (uplo, trans) of the public entry
                # op(A) is T for L/N on a and U/T on a^T, T^T for L/T on a
                # and U/N on a^T; the L/T plain solve runs on the CPU
                diag = "U" if unit else "N"
                at = np.ascontiguousarray(a_np.T)
                forms = {}
                for uplo, trans, m_np in (("L", "N", a_np), ("L", "T", a_np),
                                          ("U", "N", at), ("U", "T", at)):
                    forms[uplo + trans] = xt.extrsv_bits(
                        uplo, trans, diag, cuda_bits(m_np).view(torch.float64),
                        bb.view(torch.float64)).cpu()
                plain_lt = xt.extrsv_bits("L", "T", diag, torch.from_numpy(
                    a_np), torch.from_numpy(b_np.copy()))
                same = (torch.equal(forms["LN"], xp)
                        and torch.equal(forms["UT"], xp)
                        and torch.equal(forms["LT"], plain_lt)
                        and torch.equal(forms["UN"], plain_lt))
                line.append(f"public L/N U/T L/T U/N {'==' if same else '!='}")
                if not same:
                    failures.append(f"public forms n={n} {dist}")
            xf = xp.view(torch.float64)
            n_nan = int(torch.isnan(xf).sum())
            if n_nan and not bool((xp[torch.isnan(xf)]
                                   == 0x7FF8000000000000).all()):
                failures.append(f"n={n} {dist}: a NaN is not canonical")
            line.append(f"({int(torch.isfinite(xf).sum())} finite, {n_nan} "
                        "NaN)")
            n_cases += 1
            log(" ".join(line))
    torch.cuda.synchronize()
    if failures:
        raise AssertionError(f"TRSV kernel != plain version: {failures}")
    log(f"TRSV kernel vs plain version (on the CPU): bit-equal (tolerance "
        f"0) on {n_cases} cases, block heights {TRSV_BLOCKS} "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"trsv_lower_x_cuda": err}


def trsv_bench_data(xt, n: int):
    """(T of bench_trsv.py:73, the bounded T of bench_trsv.py:16-53, b).

    The first overflows: its float64 solution is finite up to row 1593
    only.  The second keeps x bounded -- diagonal in [1, 2) with random
    mantissas, strict lower part 2^-60 * [1, 2), upper part +0.0 -- and is
    made here with numpy from SEED (the JAX benchmark drew it with
    jax.random).  b is the benchmark's for both."""
    a = xt.init_fpuniform_tr_matrix("L", "N", n, 4, 0, seed=1)
    b = xt.init_fpuniform(n, 4, 0, seed=2)
    rs = np.random.RandomState(SEED + 71)
    bits = rs.randint(0, 1 << 20, size=(n, n), dtype=np.uint32).astype(
        np.uint64)
    bits |= np.uint64(0x3C300000)
    bits[np.diag_indices(n)] |= np.uint64(0x3FF00000)
    bits <<= np.uint64(32)
    bits |= rs.randint(0, 1 << 32, size=(n, n), dtype=np.uint64)
    return a, np.tril(bits).view(np.float64), b


def phase_trsv_public(xt, bench) -> tuple[dict, dict]:
    """The TRSV path at n = 8192: ``extrsv`` on the benchmark's data
    (overflowing) and on its bounded data, the upper solve of the flipped
    system and the transposed solve of T^T stored.  Returns the launch
    counts of this run and B10's largest difference from its plain
    version on the path's data."""
    from exblas_tpu_torch.ops.kernels import gemv_kernel as vk
    from exblas_tpu_torch.ops.kernels import trsv_kernel as tk

    n = N_TRSV
    a_np, t_np, b_np = bench
    a, t, b = (torch.from_numpy(v).cuda() for v in bench)
    tt = t.t().contiguous()          # T^T stored: op(A) = T with ("U", "T")
    tflip, bflip = t.flip((0, 1)), b.flip(0)

    tk.trsv_lower_x_cuda.launches = 0
    xa = xt.extrsv("L", "N", "N", a, b)
    x = xt.extrsv("L", "N", "N", t, b)
    xu = xt.extrsv("U", "N", "N", tflip, bflip)
    xtr = xt.extrsv("U", "T", "N", tt, b)
    torch.cuda.synchronize()
    launches = {"trsv_lower_x_cuda": tk.trsv_lower_x_cuda.launches}
    log("TRSV launches on the path:", launches)
    if launches["trsv_lower_x_cuda"] != 4:
        raise AssertionError(f"unexpected TRSV launches {launches}")
    del tflip, bflip, tt

    # the benchmark data: the finite rows are a prefix, as in float64
    xa_np = xa.cpu().numpy()
    fin = np.isfinite(xa_np)
    n_fin = int(fin.sum())
    if not fin[:n_fin].all():
        raise AssertionError("bench data: the finite rows are no prefix")
    log(f"extrsv n={n} bench data (bench_trsv.py:73): {n_fin} of {n} "
        f"entries finite (rows 0..{n_fin - 1}; float64 forward "
        "substitution: 1594), the rest +-Inf or NaN "
        f"({int(np.isnan(xa_np).sum())} NaN, all canonical: "
        f"{bool((xa_np[np.isnan(xa_np)].view(np.uint64) == 0x7FF8000000000000).all())})")
    # rows whose products cannot overflow the Dekker split: exact checks
    top = np.maximum.accumulate(np.abs(np.where(fin, xa_np, np.inf)))
    safe = np.nonzero(top < 2.0 ** 900)[0]
    rs = np.random.RandomState(SEED + 72)
    for i in rs.choice(safe, 64, replace=False):
        want = exact_dot_host(-a_np[i, :i], xa_np[:i], [b_np[i]]) / a_np[i, i]
        if s64(xa_np[i]) != s64(want):
            raise AssertionError(f"bench x[{i}]: {xa_np[i]!r} != {want!r}")

    # the bounded data: 256 rows exactly, the flips, the leading block
    x_np = x.cpu().numpy()
    if not np.isfinite(x_np).all():
        raise AssertionError("bounded data: x is not finite")
    for i in rs.randint(0, n, 256):
        want = exact_dot_host(-t_np[i, :i], x_np[:i], [b_np[i]]) / t_np[i, i]
        if s64(x_np[i]) != s64(want):
            raise AssertionError(f"bounded x[{i}]: {x_np[i]!r} != exact "
                                 f"{want!r}")
    if not torch.equal(xu.flip(0), x) or not torch.equal(xtr, x):
        raise AssertionError("the U/N flipped or U/T transposed solve "
                             "differs from L/N")
    m = N_TRSV_PLAIN
    tm, bm = t[:m, :m].contiguous().view(torch.int64), b[:m].view(torch.int64)
    t0 = time.perf_counter()
    xp = tk.trsv_lower_x_torch(tm.cpu(), bm.cpu(), False)  # on the CPU
    t_plain = time.perf_counter() - t0
    errs = {"trsv_lower_x_cuda": mismatch_err(
        tk.trsv_lower_x_cuda(tm, bm, False).cpu(), xp)}
    if errs["trsv_lower_x_cuda"] or not torch.equal(x[:m].cpu(), xp.view(
            torch.float64)):
        raise AssertionError(f"n={m}: B10 != plain version or the leading "
                             f"rows of the n={n} solve")
    # B7 with a row stride and x negated: T's last rows read in place
    base = n - tk.B
    panel = t.view(torch.int64)[base:, :base]
    xb = x.view(torch.int64)[:base]
    if rows_err(vk.gemv_rows_acc_cuda(panel, xb, negate_z=True),
                vk.gemv_rows_acc_torch(panel, xb, negate_z=True)):
        raise AssertionError("B7 with a row stride and -x != plain version")
    # numpy input runs on the card
    x_np_in = xt.extrsv("L", "N", "N", t_np[:m, :m], b_np[:m])
    if x_np_in.device.type != "cuda" or not torch.equal(x_np_in, x[:m]):
        raise AssertionError("extrsv on numpy input did not run on the card")
    log(f"extrsv n={n} bounded data: bit-equal to 256 exact host rows, to "
        "the U/N solve of the flipped system and to the U/T solve of T^T; "
        f"64 finite bench rows exact too; n={m}: bit-equal to the plain "
        f"version ({t_plain:.1f} s on the CPU) and to the leading rows; B7 "
        f"on T's rows {base}.. in place (row stride {n}, -x) bit-equal "
        "to its plain version; numpy input ran on the card")
    return launches, errs


def phase_trsv_timing(xt, smi: str, bench) -> dict:
    """n = 8192: B10 (both block heights) and the solver warp's step
    split, the public entry (L/N, and U/T with its copy of T) and the
    float64 control on the bounded data; B10 on the benchmark's
    overflowing data; the plain version at n = 1024; an estimate of the
    chain from assumed latencies."""
    from exblas_tpu_torch.ops.kernels import trsv_kernel as tk

    n = N_TRSV
    a, t, b = (torch.from_numpy(v).cuda() for v in bench)
    ab, tb, bb = (v.view(torch.int64) for v in (a, t, b))
    tt = t.t().contiguous()
    tm = {}
    tm["b10"] = time_ms(lambda: tk.trsv_lower_x_cuda(tb, bb, False), reps=5,
                        inner=1)
    tm["b10_64"] = time_ms(lambda: tk.trsv_lower_x_cuda(tb, bb, False,
                                                        block=64),
                           reps=3, inner=1)
    tm["b10_bench"] = time_ms(lambda: tk.trsv_lower_x_cuda(ab, bb, False),
                              reps=3, inner=1)
    # the solver warp's step split, from one launch with its stamps on
    split = tk.trsv_step_split(tb, bb, False)
    tm["pub"] = time_ms(lambda: xt.extrsv("L", "N", "N", t, b), reps=3,
                        inner=1)
    tm["pub_ut"] = time_ms(lambda: xt.extrsv("U", "T", "N", tt, b), reps=3,
                           inner=1)
    tm["copy"] = time_ms(lambda: tt.t().contiguous(), reps=3, inner=1)
    bcol = b.reshape(-1, 1)
    tm["lib"] = time_ms(lambda: torch.linalg.solve_triangular(
        t, bcol, upper=False), reps=5, inner=1)
    del tt
    # the plain version once, at n = 1024 (its steps are sequential)
    pm = 1024
    pt, pb = tb[:pm, :pm].contiguous(), bb[:pm]
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    tk.trsv_lower_x_torch(pt, pb, False)
    e1.record()
    torch.cuda.synchronize()
    tm["plain"] = e0.elapsed_time(e1)

    # bound: the lower triangle's bytes (b read, x written) against the
    # integer work of the exact products
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_max_hz()
    bytes_ = 8.0 * n * (n + 1) / 2 + 16.0 * n
    by_bytes = bytes_ / HBM_BYTES * 1e3
    products = n * (n - 1) / 2
    by_ops = B5_INT_OPS * products / (INT32_LANES * sms * clock) * 1e3
    log(f"time n={n} [{smi}]:")
    log(f"  B10 trsv_lower_x_cuda bounded data: {tm['b10']:.4f} ms at block "
        f"{tk.B} ({tm['b10'] / n * 1e3:.3f} us a row), {tm['b10_64']:.4f} ms "
        f"at block 64; bench data (special-dominated past row 1593): "
        f"{tm['b10_bench']:.4f} ms")
    step = sum(split.values())
    phases = ", ".join(f"{k} {v:.1f}" for k, v in split.items())
    log(f"  B10 step split (solver warp, clock64 cycles a step): {phases}; "
        f"{step:.1f} cycles a step, {step * n / clock * 1e3:.4f} ms at "
        f"{clock / 1e6:.0f} MHz")
    chain = n * TRSV_CHAIN_CYCLES / clock * 1e3
    log(f"  B10 chain estimate (not measured): n x {TRSV_CHAIN_CYCLES} "
        f"cycles, a step's dependent latency summed from assumed "
        f"instruction latencies, = {chain:.4f} ms")
    log(f"  public xt.extrsv L/N: {tm['pub']:.4f} ms; U/T on T^T stored: "
        f"{tm['pub_ut']:.4f} ms (its copy of T {tm['copy']:.4f} ms)")
    log(f"  float64 control torch.linalg.solve_triangular: {tm['lib']:.4f} "
        "ms")
    log(f"  plain trsv_lower_x_torch n={pm}: {tm['plain']:.1f} ms")
    log(f"bounds n={n}: {by_bytes:.4f} ms by the lower triangle's bytes; "
        f"{by_ops:.4f} ms by {B5_INT_OPS} int32 operations per exact "
        f"product ({products:.4g} products)")
    return {"trsv_lower_x_cuda": dict(
        ms=tm["b10"], plain_ms=tm["plain"], bound_ms=max(by_bytes, by_ops),
        bound_by="bytes" if by_bytes >= by_ops else "operations",
        library_ms=tm["lib"], shape=[n, n], plain_shape=[pm, pm],
        library="torch.linalg.solve_triangular", step_cycles=split)}


# ---------------------------------------------------------------------------
# The application studies (exblas_tpu_torch.apps) at the repo's own sizes
# ---------------------------------------------------------------------------

N_RNG = N_BIG                        # rng_sum: elements
M_SPMV, NNZ_SPMV = 1 << 18, 32       # spmv: rows, nonzeros a row
N_GRID, CELLS_GRID = 1 << 22, 1 << 16  # gridding: samples, cells
# k-means: benchmarks/bench_kmeans.py's shape (points, features, clusters)
N_KM, NF_KM, K_KM = 1 << 20, 32, 64


def fraction_dot(a: np.ndarray, b: np.ndarray) -> float:
    """The correctly rounded dot of finite a and b, by Fraction
    arithmetic (int true division rounds correctly)."""
    from fractions import Fraction

    return float(sum(Fraction(float(u)) * Fraction(float(v))
                     for u, v in zip(a, b)))


def host_split(fn, reps: int = 7) -> dict:
    """Per call: its CUDA-event time, and the host-clock time until the
    call returns (its launches enqueued); then one call under
    ``torch.profiler``: its kernels, their summed device time, and the
    host waits on the device in it (synchronize calls and device-to-host
    copies).  Where the device is busy for a small share of the event
    time, the host's launch chain sets the pace, not the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    ev, enq = [], []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        fn()
        enq.append((time.perf_counter() - t0) * 1e3)
        e1.record()
        torch.cuda.synchronize()
        ev.append(e0.elapsed_time(e1))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    kernels, busy_us, waits = 0, 0.0, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if "Memcpy DtoH" in e.name:
                waits.append(e.name)
            elif "Memcpy" not in e.name and "Memset" not in e.name:
                kernels += 1
                busy_us += e.time_range.elapsed_us()
        elif "Synchronize" in e.name:
            waits.append(e.name)
    return {"event_ms": ev, "enqueue_ms": enq, "kernels": kernels,
            "busy_ms": busy_us / 1e3, "waits": sorted(set(waits)),
            "n_waits": len(waits)}


def check_utils_on_card() -> None:
    """The timing and profiling utilities on CUDA tensors: ``bench_min``
    synchronizes the output's device, ``amortized_seconds`` times with
    CUDA events, and ``trace`` writes a Chrome trace with the ``annotate``
    span (under build/, which git ignores)."""
    import pathlib
    import shutil

    from exblas_tpu_torch.utils import bench_utils, profiling, timing

    x = torch.ones(1 << 20, dtype=torch.float64, device="cuda")
    best, out = timing.bench_min(torch.sum, x, iters=3)
    if not (best > 0 and out.item() == float(1 << 20)):
        raise AssertionError(f"bench_min on the card: {best}, {out}")
    t = bench_utils.amortized_seconds(
        lambda R: (lambda v: [v.sum() for _ in range(R)]), (x,), R=4)
    if not t > 0:
        raise AssertionError(f"amortized_seconds on the card: {t}")
    log_dir = pathlib.Path(__file__).resolve().parent / "build" / "trace"
    shutil.rmtree(log_dir, ignore_errors=True)
    with profiling.trace(str(log_dir)):
        with profiling.annotate("exblas_card_span"):
            x.sum().item()
    files = list(log_dir.glob("*.pt.trace.json"))
    if len(files) != 1 or "exblas_card_span" not in files[0].read_text():
        raise AssertionError(f"trace on the card wrote {files}")
    log(f"utils on the card: bench_min {best * 1e3:.4f} ms, "
        f"amortized_seconds {t * 1e3:.4f} ms a call, trace "
        f"{files[0].stat().st_size} bytes with the annotate span")


def phase_apps(xt, smi: str) -> tuple[dict, dict]:
    """The four application studies on the card through the port's app
    functions, at the repo's sizes: rng_sum (n = 2^24, 4 shuffled repeats
    of 2-15 random parts, and one partition with a part below and one
    above the ladder's 2^20), spmv (2^18 rows of 32 nonzeros, 3 repeats
    with the nnz order permuted), gridding (2^22 complex samples into 2^16
    cells, 3 shuffles) and the device k-means (bench_kmeans's 2^20 x 32
    points, 64 clusters, 3 iterations, two shuffles), each against exact
    host values; then each reproducible call timed beside a float64
    PyTorch control.  Returns the kernel launches of the apps' run (the
    counts set to 0 just before it) and the times."""
    from exblas_tpu_torch.apps import gridding, kmeans, rng_sum, spmv
    from exblas_tpu_torch.ops.exsum import exsum_segmented_bits

    t_phase = time.perf_counter()
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0

    # rng_sum: the experiment, then a fixed partition across the ladder's
    # threshold, both against math.fsum of the experiment's data
    r = rng_sum.rng_sum_experiment(n=N_RNG, repeats=4, seed=SEED)
    rs = np.random.RandomState(SEED)
    x = rs.uniform(-1, 1, N_RNG) * np.exp2(rs.randint(-30, 30, N_RNG))
    fs = math.fsum(x.tolist())
    if not (r["repro_unique"] == 1 and r["repro_equals_single_pass"]
            and f64_bits(r["value"]) == f64_bits(fs)):
        raise AssertionError(f"rng_sum n={N_RNG}: {r}, fsum {fs!r}")
    xd = torch.from_numpy(x).cuda()
    parts = [xd[(1 << 19) + 5:], xd[:(1 << 19) + 5]]
    before = {k: w.launches for k, w in sum_dot_wrappers().items()}
    v = rng_sum._exsum_parts(parts)
    delta = launch_delta(before)
    if f64_bits(v) != f64_bits(fs) or not (
            delta.get("exsum_acc_cuda") and delta.get("sum_flat_cuda")):
        raise AssertionError(f"rng_sum parts {[len(p) for p in parts]}: "
                             f"{v!r} (fsum {fs!r}), launches {delta}")
    log(f"apps rng_sum n={N_RNG}: {r}; equal to math.fsum; partition "
        f"{[len(p) for p in parts]} launched {delta}, equal to math.fsum")
    with uncounted():
        empty = xt.exsum_acc(xd[:0])
        if int(torch.count_nonzero(empty.limbs)) or xt.exsum(xd[:0]) != 0.0:
            raise AssertionError("exsum_acc of an empty part is not zero")

    # spmv: the columns of a row distinct (a start and 32 increments whose
    # sum stays below m), made vectorized
    rs = np.random.RandomState(SEED + 1)
    m, nnz = M_SPMV, NNZ_SPMV
    vals = rs.uniform(-1, 1, (m, nnz)) * np.exp2(rs.randint(-25, 25,
                                                            (m, nnz)))
    cols = (rs.randint(0, m, (m, 1))
            + np.cumsum(rs.randint(1, m // nnz, (m, nnz)), axis=1)) % m
    xv = rs.uniform(-1, 1, m) * np.exp2(rs.randint(-25, 25, m))
    outs = []
    for _ in range(3):
        perm = rs.permutation(nnz)
        outs.append(spmv.spmv_repro(vals[:, perm], cols[:, perm], xv))
    if len({o.tobytes() for o in outs}) != 1:
        raise AssertionError("spmv: the repeats differ")
    y = outs[0]
    rows = rs.choice(m, 256, replace=False)
    for i in rows:
        want = fraction_dot(vals[i], xv[cols[i]])
        if f64_bits(y[i]) != f64_bits(want):
            raise AssertionError(f"spmv row {i}: {y[i]!r} != {want!r}")
    host = spmv.spmv_repro(vals[:4096], cols[:4096], xv, device="cpu")
    if host.tobytes() != y[:4096].tobytes():
        raise AssertionError("spmv: the card differs from the host path")
    log(f"apps spmv m={m} nnz={nnz}: 3 permuted repeats bit-equal, 256 rows "
        "equal to Fraction dots, the first 4096 rows equal to the plain "
        "path on the host CPU")

    # gridding
    rs = np.random.RandomState(SEED + 2)
    cells = rs.randint(0, CELLS_GRID, N_GRID)
    mag = np.exp2(rs.randint(-25, 25, N_GRID).astype(np.float64))
    values = (rs.uniform(-1, 1, N_GRID) * mag
              + 1j * rs.uniform(-1, 1, N_GRID) * mag)
    outs = []
    for _ in range(3):
        perm = rs.permutation(N_GRID)
        outs.append(gridding.grid_repro(cells[perm], values[perm],
                                        CELLS_GRID))
    if len({o.tobytes() for o in outs}) != 1:
        raise AssertionError("gridding: the shuffles differ")
    g = outs[0]
    for c in rs.choice(CELLS_GRID, 64, replace=False):
        members = values[cells == c]
        want = (math.fsum(members.real.tolist()),
                math.fsum(members.imag.tolist()))
        if (f64_bits(g[c].real), f64_bits(g[c].imag)) != tuple(
                map(f64_bits, want)):
            raise AssertionError(f"gridding cell {c}: {g[c]!r} != {want}")
    log(f"apps gridding {N_GRID} samples into {CELLS_GRID} cells: 3 "
        "shuffles bit-equal, 64 cells equal to math.fsum of their real and "
        "imaginary parts")

    # k-means on the device
    rs = np.random.RandomState(SEED + 3)
    pts = rs.uniform(-1, 1, (N_KM, NF_KM)) * np.exp2(
        rs.randint(-8, 8, (N_KM, NF_KM)))
    init = pts[:K_KM].copy()
    centers, mem = kmeans.kmeans_device(pts, K_KM, iters=3, init=init)
    for _ in range(2):
        perm = rs.permutation(N_KM)
        c2, m2 = kmeans.kmeans_device(pts[perm], K_KM, iters=3, init=init)
        if (c2.tobytes() != centers.tobytes()
                or not np.array_equal(m2[np.argsort(perm)], mem)):
            raise AssertionError("kmeans_device: a shuffle differs")
    order = np.argsort(mem, kind="stable")
    counts = np.bincount(mem, minlength=K_KM)
    ends = np.cumsum(counts)
    for c in range(K_KM):
        cols_c = pts[order[ends[c] - counts[c]:ends[c]]].T.tolist()
        for f in range(NF_KM):
            want = (math.fsum(cols_c[f]) / counts[c]) if counts[c] else 0.0
            if f64_bits(centers[c, f]) != f64_bits(want):
                raise AssertionError(f"kmeans center ({c}, {f}): "
                                     f"{centers[c, f]!r} != {want!r}")
    log(f"apps kmeans_device n={N_KM} nf={NF_KM} k={K_KM}, 3 iterations: 2 "
        "shuffles give the same center bits and membership; every center "
        f"equals math.fsum(members) / count ({int((counts == 0).sum())} "
        "empty clusters)")
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log("launches on the apps' path (all four apps):",
        {k: v for k, v in launches.items() if v})
    if not (launches["exsum_acc_cuda"] and launches["sum_flat_cuda"]):
        raise AssertionError("the apps' path never launched B2a or B11")

    # times: each reproducible call beside a float64 PyTorch control
    tm, spread = {}, {}
    with uncounted():
        tm["rng_sum"] = time_ms(lambda: rng_sum._exsum_parts(parts), reps=5,
                                inner=1)
        spread["rng_sum"] = host_split(lambda: rng_sum._exsum_parts(parts))
        tm["rng_sum_ctl"] = time_ms(
            lambda: float(sum(p.sum() for p in parts)), reps=5, inner=1)
        vd, cd, xvd = (torch.from_numpy(a).cuda() for a in (vals, cols, xv))
        tm["spmv"] = time_ms(lambda: spmv._rows_dot_exact(vd, xvd[cd]),
                             reps=3, inner=1)
        spread["spmv"] = host_split(lambda: spmv._rows_dot_exact(vd,
                                                                 xvd[cd]))
        tm["spmv_ctl"] = time_ms(lambda: (vd * xvd[cd]).sum(1))
        ids = torch.from_numpy(cells).cuda()
        re = torch.from_numpy(values.real.copy()).cuda()
        im = torch.from_numpy(values.imag.copy()).cuda()
        def grid():
            return (exsum_segmented_bits(re.view(torch.int64), ids,
                                         CELLS_GRID),
                    exsum_segmented_bits(im.view(torch.int64), ids,
                                         CELLS_GRID))

        tm["grid"] = time_ms(grid, reps=7, inner=1)
        spread["grid"] = host_split(grid)
        zeros = torch.zeros(CELLS_GRID, dtype=torch.float64, device="cuda")
        tm["grid_ctl"] = time_ms(lambda: (
            zeros.clone().index_add_(0, ids, re),
            zeros.clone().index_add_(0, ids, im)))
        pd, cen = (torch.from_numpy(a).cuda() for a in (pts, centers))
        tm["km_step"] = time_ms(lambda: kmeans.kmeans_step_device(pd, cen,
                                                                  K_KM),
                                reps=3, inner=1)
        md = torch.from_numpy(mem).cuda().long()
        seg = (md[:, None] * NF_KM
               + torch.arange(NF_KM, device="cuda")[None, :]).reshape(-1)
        def km_update():
            return exsum_segmented_bits(pd.view(torch.int64), seg,
                                        K_KM * NF_KM)

        tm["km_update"] = time_ms(km_update, reps=7, inner=1)
        spread["km_update"] = host_split(km_update)
        kz = torch.zeros((K_KM, NF_KM), dtype=torch.float64, device="cuda")
        tm["km_ctl"] = time_ms(lambda: kz.clone().index_add_(0, md, pd))
    log(f"time apps [{smi}] (CUDA events, median):")
    log(f"  rng_sum parts {[len(p) for p in parts]}: exact (B11 + B2a, "
        f"merge, rounding) {tm['rng_sum']:.4f} ms; float64 control torch.sum "
        f"over the parts {tm['rng_sum_ctl']:.4f} ms")
    log(f"  spmv m={m} nnz={nnz}: exact rows (gather, dot_rows_acc, "
        f"round_rows) {tm['spmv']:.4f} ms; float64 control "
        f"(vals * x[cols]).sum(1) {tm['spmv_ctl']:.4f} ms")
    log(f"  gridding {N_GRID} -> {CELLS_GRID}: two exsum_segmented_bits "
        f"passes {tm['grid']:.4f} ms; float64 control index_add_ x2 "
        f"{tm['grid_ctl']:.4f} ms")
    log(f"  kmeans n={N_KM} nf={NF_KM} k={K_KM}: kmeans_step_device "
        f"{tm['km_step']:.4f} ms, of which the exact update "
        f"(exsum_segmented_bits of {N_KM * NF_KM} elements into "
        f"{K_KM * NF_KM} segments) {tm['km_update']:.4f} ms; float64 "
        f"control index_add_ {tm['km_ctl']:.4f} ms")
    for name, sp in spread.items():
        med = statistics.median(sp["event_ms"])
        log(f"  {name} over {len(sp['event_ms'])} calls: event ms min "
            f"{min(sp['event_ms']):.4f} median {med:.4f} max "
            f"{max(sp['event_ms']):.4f}; host enqueue ms median "
            f"{statistics.median(sp['enqueue_ms']):.4f}; one profiled "
            f"call: {sp['kernels']} kernels, device busy "
            f"{sp['busy_ms']:.4f} ms ({100 * sp['busy_ms'] / med:.1f}% of "
            f"the median), {sp['n_waits']} host waits {sp['waits']}")
    check_utils_on_card()
    log(f"apps phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches, tm


# ---------------------------------------------------------------------------
# The mesh layer: worlds of processes on the card
# ---------------------------------------------------------------------------

# Worlds of the phase: one rank over NCCL, then two and four ranks over
# Gloo on CUDA tensors (NCCL refuses two ranks on one card).
PAR_WORLDS = (1, 2, 4)
PAR_DIR = "build/parallel"         # the phase's data, saved once as .npy
N_PAR_SUMS = (N_BIG, N_BIG + 3)
N_GEMM_K = (512, 4096, 512)        # exgemm_sharded_k: m, k, n
N_TRSV_SMALL = 2048                # the solve in worlds of 2 and 4
# the four (uplo, trans) forms and an uneven unit solve: n in world 1,
# and in worlds 2 and 4, whose owners' panel solves (about 5 ms a row,
# host-bound) take turns on the one card
TRSV_FORMS_PAR = {1: 300, 2: 64, 4: 64}
PAR_2D = {1: ((1, 1),), 2: ((1, 2), (2, 1)), 4: ((1, 4), (2, 2), (4, 1))}

Ref = collections.namedtuple("Ref", "name")  # an array of the phase's data


def parallel_data(xt) -> dict:
    """The phase's arrays, by name: the BLAS-1 bench data at 2^24 and
    2^24 + 3 (narrow: a window tier; wide300: the exact tier), +Inf and
    -Inf at the two ends of a short vector, the GEMV and GEMM bench
    operands with a y, uneven shapes, exgemm_sharded_k's operands, and
    the bounded TRSV data with its leading blocks."""
    d = {}
    for n in N_PAR_SUMS:
        d[f"narrow_{n}"] = xt.init_fpuniform(n, 2, 0, seed=7)
        d[f"narrow_b_{n}"] = xt.init_fpuniform(n, 2, 0, seed=8)
    d["wide300"] = make_input(xt, "wide", N_BIG, SEED + 3)
    d["wide300_b"] = make_input(xt, "wide", N_BIG, SEED + 4)
    pm = np.ones(1003)
    pm[0], pm[-1] = np.inf, -np.inf
    d["sum_pm_inf"] = pm
    d["gemv_a"], d["gemv_x"] = gemv_bench_data(xt, N_GEMV)
    d["gemv_y"] = xt.init_fpuniform(N_GEMV, 10, 0, seed=3)
    # 600 binades: no GEMV rung covers them, so row shards take B7
    d["gemv_ua"] = xt.init_fpuniform_matrix(1001, 999, 600, -300, seed=4)
    d["gemv_ux"] = xt.init_fpuniform(999, 600, -300, seed=5)
    d["gemv_uy"] = xt.init_fpuniform(1001, 30, 0, seed=6)
    d["gemm_a"], d["gemm_b"], d["gemm_c"] = gemm_bench_data(xt, N_GEMM)
    m, k, n = N_GEMM_K
    d["gemmk_a"] = xt.init_fpuniform_matrix(m, k, 10, 0, seed=11)
    d["gemmk_b"] = xt.init_fpuniform_matrix(k, n, 10, 0, seed=12)
    d["gemmk_c"] = xt.init_fpuniform_matrix(m, n, 10, 0, seed=13)
    d["gemm_ua"] = xt.init_fpuniform_matrix(257, 300, 10, 0, seed=14)
    d["gemm_ub"] = xt.init_fpuniform_matrix(300, 129, 10, 0, seed=15)
    _, t, b = trsv_bench_data(xt, N_TRSV)
    d["trsv_t"], d["trsv_b"] = t, b
    s = N_TRSV_SMALL
    d["trsv_t_small"] = np.ascontiguousarray(t[:s, :s])
    d["trsv_b_small"] = b[:s].copy()
    for f in set(TRSV_FORMS_PAR.values()):
        d[f"trsv_l{f}"] = np.ascontiguousarray(t[:f, :f])
        d[f"trsv_u{f}"] = np.ascontiguousarray(t[:f, :f].T)
        d[f"trsv_b{f}"] = b[:f].copy()
        d[f"trsv_l{f + 1}"] = np.ascontiguousarray(t[:f + 1, :f + 1])
        d[f"trsv_b{f + 1}"] = b[:f + 1].copy()
    return d


def parallel_calls(world: int) -> list:
    """The calls of a world: dicts of ``name`` (the logical call: one
    result in every world and mesh shape), ``entry`` (of
    ``exblas_tpu_torch.parallel``), ``args``, ``kwargs``, ``mesh`` (a
    ``tests/torch_dist.py`` mesh spec) and ``ref`` (the single-card public
    entry with its arguments); data by ``Ref``."""
    calls = []

    def add(name, entry, args, ref, mesh=("1d",), **kwargs):
        calls.append(dict(name=name, entry=entry, args=args, kwargs=kwargs,
                          mesh=mesh, ref=(*ref, {}) if len(ref) == 2
                          else ref))

    for a, b in [(f"narrow_{n}", f"narrow_b_{n}") for n in N_PAR_SUMS] + [
            ("wide300", "wide300_b")]:
        add(f"sum_{a}", "exsum_sharded", (Ref(a),), ("exsum_bits", (Ref(a),)))
        ab = (Ref(a), Ref(b))
        add(f"dot_{a}", "exdot_sharded", ab, ("exdot_bits", ab))
    x = Ref("sum_pm_inf")
    add("sum_pm_inf", "exsum_sharded", (x,), ("exsum_bits", (x,)))

    a, xv, y = Ref("gemv_a"), Ref("gemv_x"), Ref("gemv_y")
    for beta in (0.0, 1.0, -2.5):
        for trans in ("N", "T"):
            kw = dict(alpha=1.0, beta=beta, y=y if beta else None,
                      trans=trans)
            ref = ("exgemv_bits", (trans, 1.0, a, xv),
                   dict(beta=beta, y=y if beta else None))
            tag = f"{beta}_{trans}"
            for shard in ("rows", "k"):
                add(f"gemv_{tag}", "exgemv_sharded", (a, xv), ref,
                    shard=shard, **kw)
            for shape in PAR_2D[world]:
                add(f"gemv_{tag}", "exgemv_sharded_2d", (a, xv), ref,
                    mesh=("2d", shape, ("rows", "k")), **kw)
    ua, ux, uy = Ref("gemv_ua"), Ref("gemv_ux"), Ref("gemv_uy")
    kw = dict(alpha=-0.75, beta=-2.5, y=uy)
    ref = ("exgemv_bits", ("N", -0.75, ua, ux), dict(beta=-2.5, y=uy))
    for shard in ("rows", "k"):
        add("gemv_uneven", "exgemv_sharded", (ua, ux), ref, shard=shard, **kw)
    add("gemv_uneven", "exgemv_sharded_2d", (ua, ux), ref,
        mesh=("2d", PAR_2D[world][-1], ("rows", "k")), **kw)

    ga, gb, gc = Ref("gemm_a"), Ref("gemm_b"), Ref("gemm_c")
    kw = dict(alpha=1.0, beta=1.0, c=gc)
    ref = ("exgemm_bits", ("N", "N", 1.0, ga, gb), dict(beta=1.0, c=gc))
    add("gemm", "exgemm_sharded", (ga, gb), ref, **kw)
    for shape in PAR_2D[world]:
        add("gemm", "exgemm_sharded_2d", (ga, gb), ref,
            mesh=("2d", shape, ("rows", "cols")), **kw)
    ka, kb, kc = Ref("gemmk_a"), Ref("gemmk_b"), Ref("gemmk_c")
    add("gemm_k", "exgemm_sharded_k", (ka, kb),
        ("exgemm_bits", ("N", "N", -0.5, ka, kb), dict(beta=2.5, c=kc)),
        alpha=-0.5, beta=2.5, c=kc)
    ua, ub = Ref("gemm_ua"), Ref("gemm_ub")
    ref = ("exgemm_bits", ("N", "N", 3.0, ua, ub), dict(beta=0.0))
    add("gemm_uneven", "exgemm_sharded", (ua, ub), ref, alpha=3.0)
    add("gemm_uneven", "exgemm_sharded_2d", (ua, ub), ref, alpha=3.0,
        mesh=("2d", PAR_2D[world][-1], ("rows", "cols")))
    add("gemm_uneven", "exgemm_sharded_k", (ua, ub), ref, alpha=3.0)

    for suffix in ("_small",) if world > 1 else ("",):
        tb = (Ref("trsv_t" + suffix), Ref("trsv_b" + suffix))
        add("trsv" + suffix, "extrsv_sharded", ("L", "N", "N", *tb),
            ("extrsv_bits", ("L", "N", "N", *tb)))
    f = TRSV_FORMS_PAR[world]
    for uplo in ("L", "U"):
        for trans in ("N", "T"):
            args = (uplo, trans, "N", Ref(f"trsv_{uplo.lower()}{f}"),
                    Ref(f"trsv_b{f}"))
            add(f"trsv{f}_{uplo}{trans}", "extrsv_sharded", args,
                ("extrsv_bits", args))
    args = ("L", "N", "U", Ref(f"trsv_l{f + 1}"), Ref(f"trsv_b{f + 1}"))
    add(f"trsv{f + 1}_unit", "extrsv_sharded", args, ("extrsv_bits", args))
    return calls


# The calls world 1 times, each sharded entry (and each GEMV shard)
# beside its single-card entry, and those timed (1, 1): warm-up and one
# call, each 0.4-10 s.
PAR_TIMED = (f"sum_narrow_{N_BIG}", f"dot_narrow_{N_BIG}", "gemv_0.0_N",
             "gemm", "gemm_k", "trsv")
PAR_HEAVY = ("gemm", "gemm_k", "trsv")


def _resolve(v, data):
    return data[v.name] if isinstance(v, Ref) else v


def _load_par_data(names, dev) -> dict:
    import pathlib

    root = pathlib.Path(__file__).resolve().parent / PAR_DIR
    return {n: torch.from_numpy(np.load(root / f"{n}.npy")).to(dev)
            for n in sorted(names)}


def _par_names(calls, ref: bool = False) -> set:
    """The data a list of calls reads (or their references read)."""
    return {v.name for c in calls for v in (
        (*c["ref"][1], *c["ref"][2].values()) if ref
        else (*c["args"], *c["kwargs"].values())) if isinstance(v, Ref)}


def _par_label(c: dict) -> str:
    return " ".join([c["entry"], c["name"], *(
        [c["kwargs"]["shard"]] if "shard" in c["kwargs"] else [])])


def parallel_child(rank: int, world: int, calls: list, time_them: bool):
    """One rank of a phase world: every call on this rank's card, with its
    launches (the counts before and after it), the ladder route a sum or
    dot took, and its bits; with ``time_them`` CUDA-event times of the
    ``PAR_TIMED`` calls: the ``PAR_HEAVY`` ones (0.4-45 s a call) on the
    checked call itself, the others over repeats that count towards no
    call's launches."""
    import torch_dist
    from exblas_tpu_torch.ops.exdot import _exdot_acc_mxu_auto
    from exblas_tpu_torch.ops.exsum import _exsum_acc_mxu_auto
    from exblas_tpu_torch.ops.kernels import _build

    _build.library()
    dev = torch.device("cuda", torch.cuda.current_device())
    data = _load_par_data(_par_names(calls), dev)
    wrappers = all_wrappers()
    meshes, out, times = {}, [], {}
    for c in calls:
        if c["mesh"] not in meshes:
            meshes[c["mesh"]] = torch_dist.build_mesh(c["mesh"], world,
                                                      "cuda")
        mesh = meshes[c["mesh"]]
        fn = torch_dist.entry(c["entry"])
        args = [_resolve(v, data) for v in c["args"]]
        kwargs = {k: _resolve(v, data) for k, v in c["kwargs"].items()}
        timed = time_them and c["name"] in PAR_TIMED
        _exsum_acc_mxu_auto.route = ()
        _exdot_acc_mxu_auto.route = ()
        before = {k: w.launches for k, w in wrappers.items()}
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        bits = fn(*args, mesh=mesh, **kwargs)
        e1.record()
        torch.cuda.synchronize()
        launches = {k: w.launches - before[k] for k, w in wrappers.items()
                    if w.launches != before[k]}
        route = _exsum_acc_mxu_auto.route or _exdot_acc_mxu_auto.route
        out.append(dict(name=c["name"], entry=c["entry"], mesh=c["mesh"],
                        bits=bits.cpu().numpy(), launches=launches,
                        route=route))
        if timed and c["name"] in PAR_HEAVY:
            times[_par_label(c)] = e0.elapsed_time(e1)
        elif timed:
            times[_par_label(c)] = time_ms(
                lambda: fn(*args, mesh=mesh, **kwargs))
    return dict(calls=out, times=times,
                device=torch.cuda.get_device_name(dev),
                backend=torch.distributed.get_backend())


def parallel_refs(calls: list) -> tuple[dict, dict]:
    """Each call name's single-card public entry on the card, as numpy
    bits, and CUDA-event times of the ``PAR_TIMED`` ones."""
    import exblas_tpu_torch as xt

    dev = torch.device("cuda", torch.cuda.current_device())
    data = _load_par_data(_par_names(calls, ref=True), dev)
    refs, times = {}, {}
    for c in calls:
        if c["name"] in refs:
            continue
        name, args, kwargs = c["ref"]
        fn = getattr(xt, name)
        args = [_resolve(v, data) for v in args]
        kwargs = {k: _resolve(v, data) for k, v in kwargs.items()}
        refs[c["name"]] = fn(*args, **kwargs).cpu().numpy()
        if c["name"] in PAR_TIMED:
            times[f"{name} {c['name']}"] = time_ms(
                lambda: fn(*args, **kwargs))
    del data
    torch.cuda.empty_cache()
    return refs, times


def expected_par_launches(c: dict, route: tuple, world: int, rank: int,
                          n: int) -> dict:
    """The launches one rank's call ``c`` must make: a sum or dot its ladder
    ``route``'s (one window kernel a window pass, the exact kernel for the
    exact tier), or the exact kernel alone below 2^20 elements a shard;
    the GEMV rows a rank owns B8, then B9 (the bench data's rung (2, 2))
    or B7 (600 binades, no rung); the k shard and the 2-D GEMV B7; each
    GEMM block B5; the sharded solve of ``n`` rows B7 for each trailing
    update of the rank's own panel solve and for each deposit into the
    rank's rows; exgemm_sharded_k none (the plain gemm_acc)."""
    from exblas_tpu_torch.ops.extrsv import _choose_block

    e = c["entry"]
    if e in ("exsum_sharded", "exdot_sharded"):
        window, exact = (("sum_flat_cuda", "exsum_acc_cuda")
                         if e == "exsum_sharded"
                         else ("dot_flat_cuda", "exdot_acc_cuda"))
        if not route:
            return {exact: 1}
        passes = sum(t != "exact" for t in route)
        want = {window: passes, exact: int(route[-1] == "exact")}
        return {k: v for k, v in want.items() if v}
    if e == "exgemv_sharded" and c["kwargs"].get("shard", "rows") == "rows":
        return {"analyze_gemv_rows_cuda": 1,
                "gemv_rows_acc_cuda" if c["name"] == "gemv_uneven"
                else "gemv_bits_mxu_cuda": 1}
    if e in ("exgemv_sharded", "exgemv_sharded_2d"):
        return {"gemv_rows_acc_cuda": 1}
    if e in ("exgemm_sharded", "exgemm_sharded_2d"):
        return {"gemm_bits_cuda": 1}
    if e == "extrsv_sharded":
        nb = -(-n // world)
        updates = (-(-nb // _choose_block(nb)) - 1) + rank
        return {"gemv_rows_acc_cuda": updates} if updates else {}
    return {}


def phase_parallel(xt, smi: str) -> tuple[dict, dict]:
    """The mesh layer (``exblas_tpu_torch.parallel``) on the card: every
    sharded entry at the benchmark widths in a world of one rank over
    NCCL, then in worlds of two and four ranks over Gloo on CUDA tensors
    (one card: every rank on cuda:0), 2-D meshes (1, 1); (1, 2), (2, 1);
    (1, 4), (2, 2), (4, 1) and uneven sizes.  Every rank's bits must equal
    every other rank's, the other worlds' and the single-card public
    entry's (and, on samples, the host's exact values); each rank's
    launches must be those its route names; +Inf and -Inf on two ranks
    must give the canonical NaN.  World 1 times each sharded entry beside
    its single-card entry.  Returns the launches of the sharded calls
    (every rank of every world, by kernel) and world 1's times."""
    import pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent
                           / "tests"))
    import torch_dist

    t_phase = time.perf_counter()
    root = pathlib.Path(__file__).resolve().parent / PAR_DIR
    root.mkdir(parents=True, exist_ok=True)
    data = parallel_data(xt)
    for name, arr in data.items():
        np.save(root / f"{name}.npy", arr)
    log(f"parallel: {len(data)} arrays, "
        f"{sum(a.nbytes for a in data.values()) / 2**30:.2f} GiB made and "
        f"saved in {time.perf_counter() - t_phase:.1f} s")
    calls = {w: parallel_calls(w) for w in PAR_WORLDS}
    t0 = time.perf_counter()
    refs, single = parallel_refs([c for w in calls for c in calls[w]])
    log(f"parallel: {len(refs)} single-card references in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    worlds = {1: torch_dist.spawn_world(
        parallel_child, 1, (calls[1], True), backend="nccl",
        device_type="cuda", rendezvous_dir=str(root), timeout=600)}
    t1 = time.perf_counter()
    # worlds 2 and 4 side by side: six ranks on the card and the host
    worlds.update(torch_dist.spawn_worlds(
        parallel_child, {w: (calls[w], False) for w in (2, 4)},
        max_ranks=6, backend="gloo", device_type="cuda",
        rendezvous_dir=str(root), timeout=400))
    seconds = (t1 - t0, time.perf_counter() - t1)
    for world, ranks in worlds.items():
        log(f"parallel: world {world} over {ranks[0]['backend']}, every "
            f"rank on {ranks[0]['device']}")

    launches, checked = {}, 0
    for world, ranks in worlds.items():
        for i, c in enumerate(calls[world]):
            results = [rk["calls"][i] for rk in ranks]
            want = refs[c["name"]]
            for rank, r in enumerate(results):
                if r["bits"].tobytes() != want.tobytes():
                    raise AssertionError(
                        f"parallel world {world} rank {rank}: {c['entry']} "
                        f"{c['name']} {c['mesh']} differs from the "
                        "single-card entry")
                want_l = expected_par_launches(
                    c, r["route"], world, rank, want.shape[0] if want.ndim
                    else 0)
                if r["launches"] != want_l:
                    raise AssertionError(
                        f"parallel world {world} rank {rank}: {c['entry']} "
                        f"{c['name']} {c['mesh']} route {r['route']} "
                        f"launched {r['launches']}, expected {want_l}")
                for k, v in r["launches"].items():
                    launches[k] = launches.get(k, 0) + v
                checked += 1
    if refs["sum_pm_inf"].view(np.uint64)[()] != 0x7FF8000000000000:
        raise AssertionError("parallel: +Inf and -Inf on two ranks did not "
                             "give the canonical NaN")
    # exact host values on the uneven bench sizes and on samples
    n = N_BIG + 3
    host = {"sum": math.fsum(data[f"narrow_{n}"].tolist()),
            "dot": exact_dot_host(data[f"narrow_{n}"], data[f"narrow_b_{n}"])}
    for key, name in (("sum", f"sum_narrow_{n}"), ("dot", f"dot_narrow_{n}")):
        if f64_bits(float(refs[name].view(np.float64))) != f64_bits(
                host[key]):
            raise AssertionError(f"parallel {name}: not the host's exact "
                                 "value")
    rs = np.random.RandomState(SEED + 12)
    a, x = data["gemv_a"], data["gemv_x"]
    got = refs["gemv_0.0_N"].view(np.float64)
    for i in rs.choice(N_GEMV, 16, replace=False):
        if f64_bits(got[i]) != f64_bits(exact_dot_host(a[i], x)):
            raise AssertionError(f"parallel gemv row {i}: not exact")
    ga, gb, gc = data["gemm_a"], data["gemm_b"], data["gemm_c"]
    got = refs["gemm"].view(np.float64)
    for i, j in rs.randint(0, N_GEMM, (16, 2)):
        if f64_bits(got[i, j]) != f64_bits(exact_dot_host(
                ga[i], gb[:, j], extra=(gc[i, j],))):
            raise AssertionError(f"parallel gemm ({i}, {j}): not exact")
    times = worlds[1][0]["times"]
    log(f"parallel: {checked} rank results bit-equal across ranks, worlds "
        f"(1, 2, 4) and to the single-card entries; the uneven sum and dot "
        f"equal to math.fsum and the exact host dot, 16 GEMV rows and 16 "
        f"GEMM elements to exact host dots; +Inf/-Inf on two ranks give "
        f"0x7FF8000000000000; launches of the sharded calls {launches}")
    log(f"time parallel [{smi}] (world 1 over NCCL, CUDA events: the "
        f"median of 7 x 5 calls, the {', '.join(PAR_HEAVY)} calls once; "
        f"the single-card entry in the parent process, median of 7 x 5):")
    ref_of = {c["name"]: c["ref"][0] for c in calls[1]}
    for label, ms in times.items():
        name = label.split()[1]
        log(f"  {label}: {ms:.4f} ms; {ref_of[name]} "
            f"{single[f'{ref_of[name]} {name}']:.4f} ms")
    log(f"  world 1 {seconds[0]:.1f} s of wall time with its start-up, "
        f"checks and timings; worlds 2 and 4 side by side (Gloo, one shared "
        f"card, the host as the wire; not a scaling figure) "
        f"{seconds[1]:.1f} s")
    log(f"parallel phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches, times


# ---------------------------------------------------------------------------
# Summary
# ---------------------------------------------------------------------------

HBM_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
INT8_OPS = 1979e12    # H100 SXM dense int8 tensor-core ops/s
INT32_LANES = 64      # int32 operations per clock per H100 SM
# Integer operations an exact product needs at least on 32-bit units: four
# 32x32->64 multiply-adds form the 106-bit product of two 53-bit
# significands, three shifts place it at its bit offset, four adds with
# carry add it to a 128-bit sum.  Decoding is per element of A and B, not
# per product, and is left out.
B5_INT_OPS = 11
# An estimate, not a measurement: the dependent latency of one step of
# B10's chain, in cycles, summed from assumed H100 instruction latencies
# (shared load or store about 30, integer operation 4, warp vote or
# shuffle about 25, fp64 operation 8): the flag's load 30; the deposit 90 (three word loads 30, six carry-chained adds 24, the
# stores 30, a warp barrier 6); the rounding 170 (the words' loads 30, two
# rounds of three ballots 50, the magnitude 12, two shuffles 25, window and
# encoding 13 dependent operations 52); the divide 96 (a reciprocal and
# Newton steps, 12 dependent fp64 operations); the publish 64 (store, block
# fence, flag store).
TRSV_CHAIN_CYCLES = 30 + 90 + 170 + 96 + 64

KERNELS = (
    ("exsum_acc_cuda", "exblas_tpu_torch/ops/kernels/csrc/sum_kernel.cu",
     "exblas_tpu/ops/kernels/sum_kernel.py:259", 8, "torch.sum"),
    ("exsum_bits_cuda", "exblas_tpu_torch/ops/kernels/csrc/sum_kernel.cu",
     "exblas_tpu/ops/kernels/sum_kernel.py:375", 8, "torch.sum"),
    ("exdot_acc_cuda", "exblas_tpu_torch/ops/kernels/csrc/dot_kernel.cu",
     "exblas_tpu/ops/kernels/dot_kernel.py:250", 16, "torch.dot"),
    ("exdot_bits_cuda", "exblas_tpu_torch/ops/kernels/csrc/dot_kernel.cu",
     "exblas_tpu/ops/kernels/dot_kernel.py:325", 16, "torch.dot"),
)
GEMM_KERNELS = (
    ("gemm_bits_cuda", "exblas_tpu_torch/ops/kernels/csrc/gemm_kernel.cu",
     "exblas_tpu/ops/kernels/gemm_kernel.py:179"),
    ("gemm_bits_mxu_cuda", "exblas_tpu_torch/ops/kernels/csrc/gemm_mxu.cu",
     "exblas_tpu/ops/kernels/gemm_mxu.py:509"),
)
GEMV_KERNELS = (
    ("gemv_rows_acc_cuda", "exblas_tpu_torch/ops/kernels/csrc/gemv_kernel.cu",
     "exblas_tpu/ops/kernels/gemv_kernel.py:115"),
    ("analyze_gemv_rows_cuda", "exblas_tpu_torch/ops/kernels/csrc/gemv_mxu.cu",
     "exblas_tpu/ops/kernels/gemv_mxu.py:172"),
    ("gemv_bits_mxu_cuda", "exblas_tpu_torch/ops/kernels/csrc/gemv_mxu.cu",
     "exblas_tpu/ops/kernels/gemv_mxu.py:648"),
)
TRSV_KERNELS = (
    ("trsv_lower_x_cuda", "exblas_tpu_torch/ops/kernels/csrc/trsv_kernel.cu",
     "exblas_tpu/ops/kernels/trsv_kernel.py:285"),
)
FAST_KERNELS = (
    ("sum_flat_cuda", "exblas_tpu_torch/ops/kernels/csrc/sum_mxu.cu",
     "exblas_tpu/ops/kernels/sum_mxu.py:232"),
    ("dot_flat_cuda", "exblas_tpu_torch/ops/kernels/csrc/dot_mxu.cu",
     "exblas_tpu/ops/kernels/dot_mxu.py:174"),
    ("round_scaled_terms_cuda",
     "exblas_tpu_torch/ops/kernels/csrc/round_terms.cu",
     "exblas_tpu/ops/kernels/round_in_kernel.py:374"),
)


# The benchmark's cells' calls at a smaller size, and the host
# synchronizations a call that the program counts by cause on each.
SYNC_CASES = (
    ("exsum_bits 2^24 range2", "range2", {"spread": 1, "flag": 1}),
    ("exsum_bits 2^24 range300", "range300", {"spread": 1}),
    ("exgemm_bits 1024 range2", "range2", {"scalar": 4, "plan": 1}),
    ("exgemm_bits 1024 range50", "range50", {"scalar": 4, "plan": 1}),
)


def sync_case_call(xt, name: str, traffic: str):
    """The call of one ``SYNC_CASES`` entry on data drawn by the
    benchmark's generator from its traffic mix (``perfbench/``)."""
    from perfbench import gen, harness

    mix = harness.load("traffic", traffic)
    g = gen.generator(SEED, "cuda")
    if name.startswith("exsum_bits"):
        x = gen.draw((1 << 24,), mix, g, "cuda")
        return lambda: xt.exsum_bits(x)
    a, b, c = (gen.draw((1024, 1024), mix, g, "cuda", matrix=True)
               for _ in range(3))
    return lambda: xt.exgemm_bits("N", "N", 1.0, a, b, beta=1.0, c=c)


def phase_syncs(xt) -> None:
    """The program's own sync counter (``profiling.host_sync.counts``)
    against PyTorch's sync debug mode (the benchmark's ``count_syncs``)
    for the same call, after a first call, on each of ``SYNC_CASES``:
    the totals must agree and the causes be the expected ones.  The first
    call counted under the debug mode reads one synchronization more than
    every later one (as in the benchmark), so each case is counted twice
    and the second count is compared.  Then one
    profiled call of each: its ``exblas.sync.*`` spans must be as many as
    the counted syncs, and a call open at most 8 spans (a sum) or 16 (a
    GEMM)."""
    from torch.profiler import ProfilerActivity, profile

    from exblas_tpu_torch.utils import profiling
    from perfbench.syncs import count_syncs as bench_count_syncs

    counts = profiling.host_sync.counts
    for name, traffic, want in SYNC_CASES:
        fn = sync_case_call(xt, name, traffic)
        fn()
        bench_count_syncs(fn)
        before = dict(counts)
        seen, _ = bench_count_syncs(fn)
        got = {k: v - before.get(k, 0) for k, v in counts.items()
               if v != before.get(k, 0)}
        if sum(got.values()) != seen or got != want:
            raise AssertionError(f"syncs of {name}: the program counted "
                                 f"{got}, sync debug mode {seen}, "
                                 f"expected {want}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        spans = [e.name for e in prof.events()
                 if e.name.startswith("exblas.")
                 and e.device_type == torch.autograd.DeviceType.CPU]
        n_sync = sum(n.startswith("exblas.sync.") for n in spans)
        cap = 8 if name.startswith("exsum") else 16
        if n_sync != seen or len(spans) > cap:
            raise AssertionError(f"spans of {name}: {n_sync} sync spans "
                                 f"for {seen} syncs, {len(spans)} spans "
                                 f"(at most {cap}): {spans}")
        log(f"syncs of {name}: program {got}, sync debug mode {seen}; "
            f"{len(spans)} spans: {spans}")


PHASES = ("kernels", "fast_kernels", "public_api", "gemm_kernels",
          "gemm_public", "gemv_kernels", "gemv_public", "rowdot_kernels",
          "trsv_kernels",
          "trsv_public", "timing", "fast_timing", "gemm_timing",
          "gemv_timing", "trsv_timing", "apps", "parallel", "syncs")


def run_only(xt, smi: str, names: list[str]) -> None:
    """The named phases alone, in the full run's order."""
    unknown = sorted(set(names) - set(PHASES))
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; known: {PHASES}")
    data = {}

    def bench(group: str):
        if group not in data:
            data[group] = {"gemm": lambda: gemm_bench_data(xt, N_GEMM),
                           "gemv": lambda: gemv_bench_data(xt, N_GEMV),
                           "trsv": lambda: trsv_bench_data(xt, N_TRSV)}[
                               group]()
        return data[group]

    steps = {
        "kernels": lambda: phase_kernels(xt),
        "fast_kernels": lambda: phase_fast_kernels(xt),
        "public_api": lambda: phase_public_api(xt),
        "gemm_kernels": lambda: phase_gemm_kernels(xt),
        "gemm_public": lambda: phase_gemm_public(xt, bench("gemm")),
        "gemv_kernels": lambda: phase_gemv_kernels(xt),
        "gemv_public": lambda: phase_gemv_public(xt, bench("gemv")),
        "rowdot_kernels": lambda: phase_rowdot_kernels(xt),
        "trsv_kernels": lambda: phase_trsv_kernels(xt),
        "trsv_public": lambda: phase_trsv_public(xt, bench("trsv")),
        "timing": lambda: phase_timing(xt, smi),
        "fast_timing": lambda: phase_fast_timing(xt, smi),
        "gemm_timing": lambda: phase_gemm_timing(xt, smi, bench("gemm")),
        "gemv_timing": lambda: phase_gemv_timing(xt, smi, bench("gemv")),
        "trsv_timing": lambda: phase_trsv_timing(xt, smi, bench("trsv")),
        "apps": lambda: phase_apps(xt, smi),
        "parallel": lambda: phase_parallel(xt, smi),
        "syncs": lambda: phase_syncs(xt),
    }
    for name in PHASES:
        if name in names:
            steps[name]()
    log(f"chip_smoke --only {','.join(names)}: passed")


def main() -> None:
    only = None
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        only = sys.argv[2].split(",")
    elif len(sys.argv) != 1:
        raise SystemExit("usage: chip_smoke.py [--only PHASE,...]")
    smi = phase_device()
    import exblas_tpu_torch as xt

    t0 = time.perf_counter()
    phase_build()
    if only is not None:
        run_only(xt, smi, only)
        log(f"chip_smoke seconds {time.perf_counter() - t0:.1f}")
        return
    errs = phase_kernels(xt)
    errs.update(phase_fast_kernels(xt))
    launches = phase_public_api(xt)
    errs.update(phase_gemm_kernels(xt))
    bench = gemm_bench_data(xt, N_GEMM)
    gemm_launches, gemm_errs = phase_gemm_public(xt, bench)
    launches.update(gemm_launches)
    for name, e in gemm_errs.items():
        errs[name] = max(errs[name], e)
    errs.update(phase_gemv_kernels(xt))
    gemv_bench = gemv_bench_data(xt, N_GEMV)
    gemv_launches, gemv_errs = phase_gemv_public(xt, gemv_bench)
    launches.update(gemv_launches)
    for name, e in gemv_errs.items():
        errs[name] = max(errs[name], e)
    for name, e in phase_rowdot_kernels(xt).items():
        errs[name] = max(errs[name], e)
    errs.update(phase_trsv_kernels(xt))
    trsv_bench = trsv_bench_data(xt, N_TRSV)
    trsv_launches, trsv_errs = phase_trsv_public(xt, trsv_bench)
    launches.update(trsv_launches)
    for name, e in trsv_errs.items():
        errs[name] = max(errs[name], e)
    times = phase_timing(xt, smi)
    fast_times = phase_fast_timing(xt, smi)
    gemm_times = phase_gemm_timing(xt, smi, bench)
    gemv_times = phase_gemv_timing(xt, smi, gemv_bench)
    trsv_times = phase_trsv_timing(xt, smi, trsv_bench)
    apps_launches, _ = phase_apps(xt, smi)
    parallel_launches, _ = phase_parallel(xt, smi)
    phase_syncs(xt)
    summary = []
    for name, src, rep, bpe, lib in KERNELS:
        t_k, t_p, t_n = times[name]
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": t_k, "plain_ms": t_p,
            "bound_ms": bpe * N_BIG / HBM_BYTES * 1e3, "bound_by": "bytes",
            "library_ms": t_n, "shape": [N_BIG], "library": lib})
    for name, src, rep in GEMM_KERNELS:
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": errs[name],
            **gemm_times[name], "library": "torch.addmm"})
    for kernels, kernel_times in ((GEMV_KERNELS, gemv_times),
                                  (TRSV_KERNELS, trsv_times),
                                  (FAST_KERNELS, fast_times)):
        for name, src, rep in kernels:
            summary.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": errs[name], **kernel_times[name]})
    for entry in summary:
        entry["apps_launches"] = apps_launches.get(entry["name"], 0)
        entry["parallel_launches"] = parallel_launches.get(entry["name"], 0)
    log(f"chip_smoke seconds {time.perf_counter() - t0:.1f}")
    log(smi)
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
