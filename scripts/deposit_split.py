#!/usr/bin/env python3
"""Where the time of the exact row and dot kernels B7 and B4 goes, on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 scripts/deposit_split.py [--csrc DIR]

It compiles copies of ``DIR/dot_kernel.cu`` and ``DIR/gemv_kernel.cu``
(default: this checkout's ``csrc``; give an older checkout's to measure
its kernels), some with a line or a header changed, each into a library
of its own under ``build/split/``, and prints ``ptxas -v`` for every
kernel and, from ``cudaFuncGetAttributes`` and the occupancy calculator,
its registers, spilled bytes, shared memory and resident blocks an SM.
Then it times them with CUDA events, on the data of ``chip_smoke.py``: B4b
at n = 2^24 on lognormal and on wide300 data (with ``torch.zeros`` of its
workspace apart), B7 at 8192^2 on the GEMV benchmark data and on a
600-binade A.  Two kernel layouts are known, told apart by their kernels'
names:

* the grid-stride deposit (``dot_deposit_kernel`` with a one-block
  finishing kernel, ``gemv_rows_kernel`` with a block a row): each kernel
  alone, and B7 without its window flush, special counts and output
  atomics;
* the warp-owned accumulators of ``warpacc.cuh`` (``dot_warp_kernel``,
  ``gemv_warp_rows_kernel``): the kept kernels and, in turns with them,
  variants: the miss path (ii) -- the lanes of one base limb summed by
  ``__match_any_sync``/``__reduce_add_sync``, one atomic a limb -- and
  the 64-bit shared atomics of the older kernels (both held to the kept
  kernels' bits), B7 with four 16-byte loads a lane a step and with two
  resident blocks an SM, B4 with three; timed only (wrong bits): a plain
  shared store in place of each miss atomic, B7 without its flush, counts
  and writes, B4 without its last block's finishing step.  It also writes
  the kept kernels' SASS to ``build/split/`` and prints their atomics and
  most frequent instructions.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import exblas_tpu_torch as xt  # noqa: E402
from exblas_tpu_torch.ops.kernels import _build  # noqa: E402

OUT = _build.BUILD_DIR.parent / "split"
_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# Probe entries appended to each copy, by kernel layout: (C source,
# {entry: argument types}).  Every entry returns cudaGetLastError().
ATTRS = r"""
static int put_attrs(const void* fn, int threads, int* out) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = static_cast<int>(at.sharedSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], fn, threads, 0));
}
"""
OLD_DOT = ATTRS + r"""
extern "C" int probe_dot_deposit(const void* a, const void* b, long long n,
                                 void* ws, void* stream) {
  int grid = 0;
  cudaError_t err = exblas::deposit_grid(n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  dot_deposit_kernel<<<grid, exblas::kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(a), static_cast<const long long*>(b), n,
      static_cast<unsigned long long*>(ws));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int probe_dot_finish(const void* ws, void* bits, void* stream) {
  dot_finish_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(ws), nullptr, nullptr,
      static_cast<unsigned long long*>(bits));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int probe_attrs(int which, int* out) {
  return which == 0
             ? put_attrs(reinterpret_cast<const void*>(dot_deposit_kernel),
                         exblas::kBlock, out)
             : put_attrs(reinterpret_cast<const void*>(dot_finish_kernel),
                         128, out);
}
"""
OLD_GEMV = ATTRS + r"""
extern "C" int probe_attrs(int which, int* out) {
  return put_attrs(reinterpret_cast<const void*>(gemv_rows_kernel),
                   exblas::kBlock, out);
}
"""
# the old row kernel without its flush, specials and output atomics; the
# bins and counts stay live through a store no data can trigger
OLD_GEMV_BARE = {
    "  window.flush(s_acc);\n"
    "  exblas::deposit_specials(s_acc, kDotLimbs, nan_c, pinf_c, ninf_c);\n"
    "  __syncthreads();\n":
    "  unsigned long long fold = nan_c ^ pinf_c ^ ninf_c;\n"
    "  for (int b = 0; b < exblas::kBins; ++b)\n"
    "    fold ^= window.bin[b].w[0] ^ window.bin[b].w[1] ^ "
    "window.bin[b].w[2];\n"
    "  if (fold == 0x5A5A5A5A5A5A5A5AULL) limbs[row] = fold;\n"
    "  return;\n",
}
OLD_DOT_SIG = {"probe_dot_deposit": (_P, _P, _N, _P, _P),
               "probe_dot_finish": (_P, _P, _P),
               "exdot_bits_cuda": (_P, _P, _N, _P, _P, _P),
               "probe_attrs": (_I, _P)}
OLD_GEMV_SIG = {"gemv_rows_acc_cuda": (_P, _P, _N, _N, _N, _I, _P, _P, _P),
                "probe_attrs": (_I, _P)}


def build(csrc: Path, src: str, tag: str, probes: str, sigs: dict,
          edits: dict | None = None):
    """(the library, ptxas' lines, the library's path) of a copy of
    ``csrc/src.cu`` with ``probes`` appended, built under ``OUT/tag/``.
    ``edits`` maps a file of ``csrc`` (the source or a header) to the
    texts to replace in it; an edited header's copy sits beside the
    source's, where its ``#include`` finds it first."""
    d = OUT / tag
    shutil.rmtree(d, ignore_errors=True)  # no edited header of another tree
    d.mkdir(parents=True)
    files = {f"{src}.cu": (csrc / f"{src}.cu").read_text()}
    for name, reps in (edits or {}).items():
        text = files.get(name, None) or (csrc / name).read_text()
        for old, new in reps.items():
            if old not in text:
                raise RuntimeError(f"{name} has no text {old!r}")
            text = text.replace(old, new)
        files[name] = text
    files[f"{src}.cu"] += probes
    for name, text in files.items():
        (d / name).write_text(text)
    lib_path = d / f"{src}.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v",
           f"-I{csrc}", "-shared", "-o", str(lib_path), str(d / f"{src}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tag}/{src}.cu: {proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lines = [ln.strip() for ln in proc.stderr.splitlines()
             if "ptxas info" in ln and ("Used" in ln or "Compiling" in ln
                                        or "spill" in ln)]
    return lib, lines, lib_path


def sass_opcodes(lib_path: Path, dump: Path | None = None) -> dict:
    """{kernel: {opcode: count}} of a library's SASS (cuobjdump), the
    listing itself written to ``dump`` if given."""
    nvcc = Path(_build.find_nvcc())
    proc = subprocess.run([str(nvcc.with_name("cuobjdump")), "-sass",
                           str(lib_path)], capture_output=True, text=True,
                          check=True)
    if dump is not None:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text(proc.stdout)
    out, fn = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            out[fn] = {}
            continue
        body = line.split("*/", 1)[-1].strip() if "/*" in line else ""
        if fn is None or not body or body.startswith("/*"):
            continue
        words = body.replace(";", " ").split()
        op = words[1] if words[0].startswith("@") and len(words) > 1 \
            else words[0]
        out[fn][op] = out[fn].get(op, 0) + 1
    return out


def sass_summary(ops: dict) -> str:
    """The instruction count, the atomics and the most frequent opcodes."""
    atomics = {k: v for k, v in ops.items()
               if k.startswith(("ATOM", "RED")) or "CAS" in k}
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
    return (f"{sum(ops.values())} instructions; atomics {atomics}; top "
            + ", ".join(f"{k} {v}" for k, v in top))


def attrs(lib, which: int, label: str) -> None:
    out = torch.zeros(4, dtype=torch.int32)
    _build.check(lib.probe_attrs(which, _build.ptr(out)), "probe_attrs")
    regs, local, shared, blocks = out.tolist()
    print(f"{label}: {regs} registers, {local} local bytes, {shared} static "
          f"shared bytes, {blocks} resident blocks an SM", flush=True)


def old_layout(csrc: Path, smi: str) -> None:
    p, stream = _build.ptr, _build.stream_of(torch.device("cuda"))
    with ThreadPoolExecutor(3) as pool:
        f_dot = pool.submit(build, csrc, "dot_kernel", "probe", OLD_DOT,
                            OLD_DOT_SIG)
        f_gemv = pool.submit(build, csrc, "gemv_kernel", "probe", OLD_GEMV,
                             OLD_GEMV_SIG)
        f_bare = pool.submit(build, csrc, "gemv_kernel", "bare", OLD_GEMV,
                             OLD_GEMV_SIG, {"gemv_kernel.cu": OLD_GEMV_BARE})
        (dot, dot_lines, _), (gemv, gemv_lines, _), (bare, bare_lines, _) = (
            f_dot.result(), f_gemv.result(), f_bare.result())
    for label, lines in (("dot_kernel.cu", dot_lines),
                         ("gemv_kernel.cu", gemv_lines),
                         ("gemv_kernel.cu without flush/specials/atomics",
                          bare_lines)):
        print(f"ptxas {label}:", *lines, sep="\n  ", flush=True)
    attrs(dot, 0, "B4 dot_deposit_kernel")
    attrs(dot, 1, "B4 dot_finish_kernel")
    attrs(gemv, 0, "B7 gemv_rows_kernel")
    attrs(bare, 0, "B7 gemv_rows_kernel without flush/specials/atomics")

    n = cs.N_BIG
    data = {"lognormal": (cs.make_input(xt, "lognormal", n, cs.SEED + 11),
                          cs.make_input(xt, "lognormal", n, cs.SEED + 12)),
            "wide300": (cs.make_input(xt, "wide", n, cs.SEED + 3),
                        cs.make_input(xt, "wide", n, cs.SEED + 4))}
    for name, (a_np, b_np) in data.items():
        a = torch.from_numpy(a_np).cuda()
        b = torch.from_numpy(b_np).cuda()
        ws = torch.zeros(219, dtype=torch.int64, device="cuda")
        bits = torch.empty((), dtype=torch.int64, device="cuda")

        def zero():
            return torch.zeros(219, dtype=torch.int64, device="cuda")

        def deposit():
            _build.check(dot.probe_dot_deposit(p(a), p(b), n, p(ws), stream),
                         "deposit")

        def finish():
            _build.check(dot.probe_dot_finish(p(ws), p(bits), stream),
                         "finish")

        def whole():
            w = zero()
            _build.check(dot.exdot_bits_cuda(p(a), p(b), n, p(w), p(bits),
                                             stream), "exdot_bits_cuda")

        t = {k: cs.time_ms(f, reps=9, inner=10) for k, f in (
            ("zero", zero), ("deposit", deposit), ("finish", finish),
            ("whole", whole), ("dot", lambda: torch.dot(a, b)))}
        print(f"B4b n=2^24 {name} [{smi}]: torch.zeros {t['zero']:.4f} ms, "
              f"deposit kernel {t['deposit']:.4f} ms, finishing kernel "
              f"{t['finish']:.4f} ms, whole entry {t['whole']:.4f} ms; "
              f"torch.dot {t['dot']:.4f} ms", flush=True)

    m = k = cs.N_GEMV
    a_b, z_np = cs.gemv_bench_data(xt, m)
    wide = xt.init_fpuniform_matrix(m, k, 600, -300, seed=cs.SEED + 61)
    z = torch.from_numpy(z_np).cuda()
    for name, a_np in (("bench", a_b), ("600-binade A", wide)):
        a = torch.from_numpy(a_np).cuda()
        limbs = torch.zeros((m, 216), dtype=torch.int64, device="cuda")
        special = torch.zeros((m, 3), dtype=torch.int64, device="cuda")

        def fills():
            torch.zeros((m, 216), dtype=torch.int64, device="cuda")
            torch.zeros((m, 3), dtype=torch.int64, device="cuda")

        def run(lib):
            _build.check(lib.gemv_rows_acc_cuda(
                p(a), p(z), m, k, k, 0, p(limbs), p(special), stream),
                "gemv_rows_acc_cuda")

        t = {key: cs.time_ms(f, reps=7, inner=3) for key, f in (
            ("fills", fills), ("kernel", lambda: run(gemv)),
            ("bare", lambda: run(bare)), ("mv", lambda: torch.mv(a, z)))}
        print(f"B7 {m}^2 {name} [{smi}]: zero-fills {t['fills']:.4f} ms, "
              f"kernel {t['kernel']:.4f} ms, kernel without flush/specials/"
              f"atomics {t['bare']:.4f} ms; torch.mv {t['mv']:.4f} ms",
              flush=True)
        del a


# The warp accumulator's miss path as measured against the kept one
# (native 32-bit shared atomicAdd a digit, option (i)): (ii) lanes of one
# base limb summed by __match_any_sync and __reduce_add_sync, one atomic
# a distinct limb; and the 64-bit shared atomics of the older kernels
# (compare-and-swap loops on sm_90a).
MISS_I = """      red_shared_nz(&s32[q + t], negative ? -d : d);"""
MISS_VARIANTS = {
    "ii_match": {"warpacc.cuh": {
        "    if (!take) return;\n    const int ea": "    const int ea",
        "    if (ea == 0x7FF || eb == 0x7FF) {\n      const bool nan":
        "    const bool spec = ea == 0x7FF || eb == 0x7FF;\n"
        "    if (take && spec) {\n      const bool nan",
        "        ++pinf_c;\n      }\n      return;\n    }":
        "        ++pinf_c;\n      }\n    }",
        "    // a miss: finite, nonzero, outside the window\n":
        "    const bool miss = take && !spec;\n"
        "    const unsigned miss_mask = __ballot_sync(kFullMask, miss);\n"
        "    if (!miss) return;\n",
        "    const unsigned long long w[2] = {lo, hi};":
        "    const unsigned peers = __match_any_sync(miss_mask, q);\n"
        "    const bool leader = (threadIdx.x & 31) == __ffs(peers) - 1;\n"
        "    const unsigned long long w[2] = {lo, hi};",
        MISS_I:
        """      const int v = __reduce_add_sync(peers, negative ? -d : d);
      if (leader && v != 0) atomicAdd(&s32[q + t], v);"""}},
    "cas64": {"warpacc.cuh": {
        MISS_I:
        """      if (d != 0) atomicAdd(
          reinterpret_cast<unsigned long long*>(&s64[q + t]),
          static_cast<unsigned long long>(negative ? -d : d));"""}},
}
# timed only: a plain shared store in place of each miss digit's atomic
# (wrong bits), to show the atomics' share of the miss path
PLAIN_STORE = {"warpacc.cuh": {MISS_I: "      s32[q + t] = d;"}}
# timed only: the row kernel without its flush, counts and writes (the
# bins and counts stay live through a store no data can trigger), and the
# dot kernel without its last block's finishing step
NEW_GEMV_BARE = {"gemv_kernel.cu": {
    "  acc.flush();\n  long long nan_t":
    "  if (!active) return;\n"
    "  {\n"
    "    unsigned long long fold = acc.nan_c ^ acc.pinf_c ^ acc.ninf_c;\n"
    "    for (int i = 0; i < exblas::kWinWords; ++i) fold ^= acc.win[i];\n"
    "    if (fold == 0x5A5A5A5A5A5A5A5AULL) limbs[row] = fold;\n"
    "    return;\n"
    "  }\n"
    "  acc.flush();\n  long long nan_t"}}
NEW_DOT_NO_FINISH = {"dot_kernel.cu": {
    "  if (!s_last) return;": "  if (!s_last || n >= 0) return;"}}
# the row kernel with four 16-byte loads of its row a lane a step, not two
NEW_GEMV_PAIRS4 = {"gemv_kernel.cu": {
    "constexpr int kPairs = 2;": "constexpr int kPairs = 4;"}}
# the resident blocks an SM the launch bounds ask for: the row kernel with
# two (more registers a thread) instead of three, the dot kernel with
# three (fewer) instead of two
GEMV_OCC2 = {"gemv_kernel.cu": {"__launch_bounds__(32 * kMaxWarps, 3)":
                                "__launch_bounds__(32 * kMaxWarps, 2)"}}
DOT_OCC3 = {"dot_kernel.cu": {"__launch_bounds__(kThreads, 2)":
                              "__launch_bounds__(kThreads, 3)"}}
NEW_DOT_SIG = {"exdot_bits_cuda": _build.SIGNATURES["exdot_bits_cuda"],
               "exdot_attrs": (_I, _P)}
NEW_GEMV_SIG = {"gemv_rows_acc_cuda": _build.SIGNATURES["gemv_rows_acc_cuda"],
                "gemv_rows_attrs": (_P,)}


def new_attrs(fn, label: str, *args) -> None:
    out = torch.zeros(4, dtype=torch.int32)
    _build.check(fn(*args, _build.ptr(out)), label)
    regs, local, shared, blocks = out.tolist()
    print(f"{label}: {regs} registers, {local} local bytes, {shared} static "
          f"shared bytes, {blocks} resident blocks an SM", flush=True)


def in_turns(fns: dict, reps: int, inner: int) -> dict:
    """{name: [ms in the list's order, ms in the reversed order]}."""
    out = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        out[name].append(cs.time_ms(fns[name], reps=reps, inner=inner))
    return out


def new_layout(csrc: Path, smi: str) -> None:
    from exblas_tpu_torch.ops.kernels.gemv_kernel import row_geometry

    p, stream = _build.ptr, _build.stream_of(torch.device("cuda"))
    jobs = {("dot", "kept"): ("dot_kernel", NEW_DOT_SIG, None),
            ("dot", "no_finish"): ("dot_kernel", NEW_DOT_SIG,
                                   NEW_DOT_NO_FINISH),
            ("gemv", "kept"): ("gemv_kernel", NEW_GEMV_SIG, None),
            ("gemv", "bare"): ("gemv_kernel", NEW_GEMV_SIG, NEW_GEMV_BARE),
            ("gemv", "pairs4"): ("gemv_kernel", NEW_GEMV_SIG,
                                 NEW_GEMV_PAIRS4),
            ("gemv", "plain_store"): ("gemv_kernel", NEW_GEMV_SIG,
                                      PLAIN_STORE),
            ("dot", "plain_store"): ("dot_kernel", NEW_DOT_SIG, PLAIN_STORE),
            ("gemv", "occ2"): ("gemv_kernel", NEW_GEMV_SIG, GEMV_OCC2),
            ("dot", "occ3"): ("dot_kernel", NEW_DOT_SIG, DOT_OCC3)}
    for name, edits in MISS_VARIANTS.items():
        jobs[("dot", name)] = ("dot_kernel", NEW_DOT_SIG, edits)
        jobs[("gemv", name)] = ("gemv_kernel", NEW_GEMV_SIG, edits)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {key: pool.submit(build, csrc, src, f"{key[0]}_{key[1]}", "",
                                 sigs, edits)
                for key, (src, sigs, edits) in jobs.items()}
        libs = {key: f.result() for key, f in futs.items()}
    for key, (lib, lines, path) in libs.items():
        print(f"ptxas {key[0]} {key[1]}:", *lines, sep="\n  ", flush=True)
        dump = (OUT / f"sass_{key[0]}_{key[1]}.txt" if key[1] == "kept"
                else None)
        for fn, ops in sass_opcodes(path, dump).items():
            if ops and key[1] in ("kept", "cas64"):
                print(f"  SASS {fn[:70]}: {sass_summary(ops)}", flush=True)
    new_attrs(libs[("dot", "kept")][0].exdot_attrs, "B4 16-byte loads", 0)
    new_attrs(libs[("dot", "kept")][0].exdot_attrs, "B4 8-byte loads", 1)
    new_attrs(libs[("gemv", "kept")][0].gemv_rows_attrs, "B7")

    n = cs.N_BIG
    data = {"lognormal": (cs.make_input(xt, "lognormal", n, cs.SEED + 11),
                          cs.make_input(xt, "lognormal", n, cs.SEED + 12)),
            "wide300": (cs.make_input(xt, "wide", n, cs.SEED + 3),
                        cs.make_input(xt, "wide", n, cs.SEED + 4))}
    dots = {name: lib for (kind, name), (lib, _, _) in libs.items()
            if kind == "dot"}
    for name, (a_np, b_np) in data.items():
        a = torch.from_numpy(a_np).cuda()
        b = torch.from_numpy(b_np).cuda()

        def zero():
            return torch.zeros(220, dtype=torch.int64, device="cuda")

        def whole(lib, bits):
            _build.check(lib.exdot_bits_cuda(p(a), p(b), n, p(zero()),
                                             p(bits), stream),
                         "exdot_bits_cuda")
            return bits

        want = int(whole(dots["kept"], torch.empty((), dtype=torch.int64,
                                                   device="cuda")))
        for v, lib in dots.items():
            got = int(whole(lib, torch.empty((), dtype=torch.int64,
                                             device="cuda")))
            if v not in ("no_finish", "plain_store") and got != want:
                raise SystemExit(f"B4 {v} on {name}: {got:#x} != {want:#x}")
        bits = torch.empty((), dtype=torch.int64, device="cuda")
        fns = {f"B4b {v}": (lambda lib=lib: whole(lib, bits))
               for v, lib in dots.items()}
        fns["torch.zeros(220)"] = zero
        fns["torch.dot"] = lambda: torch.dot(a, b)
        for key, ts in in_turns(fns, 9, 10).items():
            print(f"n=2^24 {name} {key}: {ts[0]:.4f} / {ts[1]:.4f} ms "
                  f"[{smi}]", flush=True)
        del a, b

    m = k = cs.N_GEMV
    geo = row_geometry(m, k, torch.cuda.get_device_properties(0)
                       .multi_processor_count)
    a_b, z_np = cs.gemv_bench_data(xt, m)
    wide = xt.init_fpuniform_matrix(m, k, 600, -300, seed=cs.SEED + 61)
    z = torch.from_numpy(z_np).cuda()
    rows = {name: lib for (kind, name), (lib, _, _) in libs.items()
            if kind == "gemv"}
    for name, a_np in (("bench", a_b), ("600-binade A", wide)):
        a = torch.from_numpy(a_np).cuda()
        limbs = torch.zeros((m, 216), dtype=torch.int64, device="cuda")
        special = torch.zeros((m, 3), dtype=torch.int64, device="cuda")

        def run(lib):
            _build.check(lib.gemv_rows_acc_cuda(
                p(a), p(z), m, k, k, 0, geo.warps, geo.splits, geo.span,
                p(limbs), p(special), stream), "gemv_rows_acc_cuda")

        run(rows["kept"])
        want = (limbs.clone(), special.clone())
        for v, lib in rows.items():
            run(lib)
            if v not in ("bare", "plain_store") and cs.rows_err(
                    (limbs, special), want) != 0:
                raise SystemExit(f"B7 {v} on {name} differs")
        fns = {f"B7 {v}": (lambda lib=lib: run(lib))
               for v, lib in rows.items()}
        fns["torch.mv"] = lambda: torch.mv(a, z)
        for key, ts in in_turns(fns, 7, 3).items():
            print(f"{m}^2 {name} {key}: {ts[0]:.4f} / {ts[1]:.4f} ms "
                  f"[{smi}]", flush=True)
        del a


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    args = ap.parse_args()
    smi = cs.phase_device()
    csrc = args.csrc.resolve()
    text = (csrc / "dot_kernel.cu").read_text()
    if "dot_deposit_kernel" in text:
        old_layout(csrc, smi)
    else:
        new_layout(csrc, smi)


if __name__ == "__main__":
    main()
