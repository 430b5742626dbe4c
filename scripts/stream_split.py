#!/usr/bin/env python3
"""Where the time of the exact sum kernel B2 and the anchored dot kernel B12
goes, on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 scripts/stream_split.py [--csrc DIR]

It compiles copies of ``DIR/sum_kernel.cu`` and ``DIR/dot_mxu.cu``
(default: this checkout's ``csrc``; give an older checkout's to measure
its kernels), some with a line or a header changed, each into a library
of its own under ``build/split/``, prints ``ptxas -v`` for each and, from
``cudaFuncGetAttributes`` and the occupancy calculator, every kernel's
registers, spilled bytes, shared memory and resident blocks an SM, and
the grid each launch takes against the blocks one wave holds.  It writes
the kept kernels' SASS to ``build/split/`` and prints their atomics (a
64-bit shared add shows as a compare-and-swap loop, ``ATOMS.CAS``) and
most frequent instructions.  Then it times, with CUDA events and in
turns, B2b at n = 2^24 on lognormal data and on wide300 (the data of
``chip_smoke.py``'s exact-kernel timing) and B12 on the BLAS-1
benchmark's lognormal pair at its exact anchors.  Two layouts are known, told apart by the kernels'
names:

* the grid-stride kernels (``sum_deposit_kernel`` with a one-block
  finishing kernel, ``dot_flat_kernel`` on ``deposit_grid``): B2's
  deposit kernel, finishing kernel and ``torch.zeros`` of its workspace
  apart, the whole entry, and the deposit with a plain shared store in
  place of each miss atomic (wrong bits, timed only); B12 whole, on a
  grid of the occupancy calculator's size (held to the kept kernel's
  terms), and without its products (loads, decoding and the coverage
  flag only: wrong terms, timed only);
* the persistent kernels (``sum_warp_kernel`` on ``warpacc.cuh``'s
  ``SumAcc``, ``dot_frame_kernel``): each whole entry and its
  workspace's zeroing apart; exact variants, held to the kept kernel's
  bits: B2 at four resident blocks an SM and at four doubles a lane a
  step, B12 at four blocks and at eight pairs a step; timed only (wrong
  bits): B2 with a plain shared store in place of each miss atomic and
  without its last block's finish, B12 without its products and without
  its frame's read-modify-writes.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
import deposit_split as ds  # noqa: E402
import exblas_tpu_torch as xt  # noqa: E402
from exblas_tpu_torch.ops.kernels import _build  # noqa: E402

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# The blocks a persistent launch of `fn` may take: every SM full once.
WAVE = r"""
static int wave_blocks(const void* fn, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, 0);
  return sms * per_sm;
}
"""
OLD_SUM = ds.ATTRS + WAVE + r"""
extern "C" int probe_sum_deposit(const void* x, long long n, void* ws,
                                 void* stream) {
  int grid = 0;
  cudaError_t err = exblas::deposit_grid(n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_deposit_kernel<<<grid, exblas::kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(x), n,
      static_cast<unsigned long long*>(ws));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int probe_sum_finish(const void* ws, void* bits, void* stream) {
  sum_finish_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(ws), nullptr, nullptr,
      static_cast<unsigned long long*>(bits));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int probe_attrs(int which, int* out) {
  return which == 0
             ? put_attrs(reinterpret_cast<const void*>(sum_deposit_kernel),
                         exblas::kBlock, out)
             : put_attrs(reinterpret_cast<const void*>(sum_finish_kernel),
                         128, out);
}
extern "C" int probe_grid(long long n, int* out) {
  cudaError_t err = exblas::deposit_grid(n, &out[0]);
  out[1] = wave_blocks(reinterpret_cast<const void*>(sum_deposit_kernel),
                       exblas::kBlock);
  return static_cast<int>(err);
}
"""
OLD_DOT = ds.ATTRS + WAVE + r"""
extern "C" int probe_dot_occ(const void* a, const void* b, long long n,
                             const void* ea, const void* eb, void* ws,
                             void* stream) {
  const long long want = (n + exblas::kBlock * kUnroll - 1) /
                         (exblas::kBlock * kUnroll);
  const long long cap = wave_blocks(
      reinterpret_cast<const void*>(dot_flat_kernel), exblas::kBlock);
  const int grid = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  dot_flat_kernel<<<grid, exblas::kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(a), static_cast<const long long*>(b), n,
      static_cast<const int*>(ea), static_cast<const int*>(eb),
      static_cast<unsigned long long*>(ws));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int probe_attrs(int which, int* out) {
  return put_attrs(reinterpret_cast<const void*>(dot_flat_kernel),
                   exblas::kBlock, out);
}
extern "C" int probe_grid(long long n, int* out) {
  cudaError_t err = exblas::deposit_grid(n, &out[0]);
  out[1] = wave_blocks(reinterpret_cast<const void*>(dot_flat_kernel),
                       exblas::kBlock);
  return static_cast<int>(err);
}
"""
OLD_SUM_SIG = {"probe_sum_deposit": (_P, _N, _P, _P),
               "probe_sum_finish": (_P, _P, _P),
               "exsum_bits_cuda": (_P, _N, _P, _P, _P),
               "probe_attrs": (_I, _P), "probe_grid": (_N, _P)}
OLD_DOT_SIG = {"dot_flat_cuda": (_P, _P, _N, _P, _P, _P, _P),
               "probe_dot_occ": (_P, _P, _N, _P, _P, _P, _P),
               "probe_attrs": (_I, _P), "probe_grid": (_N, _P)}
# the old miss path with a plain shared store in place of each atomic
OLD_PLAIN_STORE = {"deposit.cuh": {
    "      atomicAdd(&s_acc[q + t],\n"
    "                static_cast<unsigned long long>(negative ? -d : d));":
    "      s_acc[q + t] =\n"
    "          static_cast<unsigned long long>(negative ? -d : d);"}}


def cut(path: Path, start: str, end: str, new: str) -> dict:
    """{the text of ``path`` from ``start`` through ``end``: new}, for
    :func:`deposit_split.build`'s edits."""
    text = path.read_text()
    i = text.index(start)
    j = text.index(end, i) + len(end)
    return {text[i:j]: new}


def loop_spans(listing: str) -> dict:
    """{kernel: instructions of its longest backward branch's span} of a
    cuobjdump listing: the main loop's body, rare paths inside it
    included.  Branch targets are labels (``.L_x_N``) or addresses."""
    out, fn, addrs, labels = {}, None, [], {}
    for line in listing.splitlines():
        if "Function :" in line:
            fn, addrs, labels = line.split("Function :")[1].strip(), [], {}
            out[fn] = 0
            continue
        s = line.strip()
        if fn is None:
            continue
        if s.startswith(".L_") and s.endswith(":"):
            labels[s[:-1]] = len(addrs)
            continue
        if not s.startswith("/*") or "*/" not in s:
            continue
        head, body = s[2:].split("*/", 1)
        body = body.split("/*", 1)[0].strip()  # drop the encoding
        try:
            addr = int(head, 16)
        except ValueError:
            continue
        if not body or body.startswith("/*"):
            continue
        addrs.append(addr)
        if "BRA" not in body:
            continue
        start = None
        if "`(" in body:
            start = labels.get(body.split("`(", 1)[1].split(")", 1)[0])
        else:
            words = body.replace(";", " ").split()
            hexes = [w for w in words if w.startswith("0x")]
            if hexes and int(hexes[-1], 16) <= addr:
                target = int(hexes[-1], 16)
                start = next(i for i, a in enumerate(addrs) if a >= target)
        if start is not None:
            out[fn] = max(out[fn], len(addrs) - start)
    return out


def summary_sass(path: Path, tag: str, names: tuple) -> dict:
    """Print the SASS summary and the main loop's span of the kernels whose
    names hold one of ``names``; returns {kernel: opcode counts}."""
    dump = ds.OUT / f"sass_{tag}.txt"
    ops_by_fn = ds.sass_opcodes(path, dump)
    spans = loop_spans(dump.read_text())
    for fn, ops in ops_by_fn.items():
        if ops and any(k in fn for k in names):
            print(f"  SASS {fn[:70]}: {ds.sass_summary(ops)}; longest loop "
                  f"{spans.get(fn, 0)} instructions", flush=True)
    return ops_by_fn


def lognormal_sum():
    return cs.make_input(xt, "lognormal", cs.N_BIG, cs.SEED + 11)


def wide300():
    return cs.make_input(xt, "wide", cs.N_BIG, cs.SEED + 3)


def lognormal_pair():
    return (xt.init_lognormal(cs.N_BIG, 1.0, 2.0, seed=11),
            xt.init_lognormal(cs.N_BIG, 1.0, 2.0, seed=12))


def grid_line(lib, label: str, n: int) -> None:
    out = torch.zeros(2, dtype=torch.int32)
    _build.check(lib.probe_grid(n, _build.ptr(out)), "probe_grid")
    g, wave = out.tolist()
    print(f"{label}: grid at n=2^24 {g} blocks; one wave holds {wave}",
          flush=True)


def old_layout(csrc: Path, smi: str) -> None:
    p, stream = _build.ptr, _build.stream_of(torch.device("cuda"))
    noprod = cut(csrc / "dot_mxu.cu",
                 "      const unsigned long long lo = pa * mb;",
                 "add && ((va[u] ^ vb[u]) < 0));",
                 "sums[0] += pa ^ mb;\n      sums[1] += "
                 "static_cast<unsigned long long>(s);")
    jobs = {"b2_kept": ("sum_kernel", OLD_SUM, OLD_SUM_SIG, None),
            "b2_plain_store": ("sum_kernel", OLD_SUM, OLD_SUM_SIG,
                                OLD_PLAIN_STORE),
            "b12_kept": ("dot_mxu", OLD_DOT, OLD_DOT_SIG, None),
            "b12_noprod": ("dot_mxu", OLD_DOT, OLD_DOT_SIG,
                           {"dot_mxu.cu": noprod})}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {tag: pool.submit(ds.build, csrc, src, tag, probes, sigs,
                                 edits)
                for tag, (src, probes, sigs, edits) in jobs.items()}
        libs = {tag: f.result() for tag, f in futs.items()}
    for tag, (_, lines, path) in libs.items():
        print(f"ptxas {tag}:", *lines, sep="\n  ", flush=True)
        if tag.endswith("kept"):
            summary_sass(path, tag, ("sum", "dot"))
    s_lib, d_lib = libs["b2_kept"][0], libs["b12_kept"][0]
    ds.attrs(s_lib, 0, "B2 sum_deposit_kernel")
    ds.attrs(s_lib, 1, "B2 sum_finish_kernel")
    ds.attrs(d_lib, 0, "B12 dot_flat_kernel")
    grid_line(s_lib, "B2 sum_deposit_kernel", cs.N_BIG)
    grid_line(d_lib, "B12 dot_flat_kernel", cs.N_BIG)

    n = cs.N_BIG
    plain = libs["b2_plain_store"][0]
    for name, x_np in (("lognormal", lognormal_sum()), ("wide300", wide300())):
        x = torch.from_numpy(x_np).cuda()
        ws = torch.zeros(115, dtype=torch.int64, device="cuda")
        bits = torch.empty((), dtype=torch.int64, device="cuda")

        def zero():
            return torch.zeros(115, dtype=torch.int64, device="cuda")

        def whole():
            _build.check(s_lib.exsum_bits_cuda(p(x), n, p(zero()), p(bits),
                                               stream), "exsum_bits_cuda")

        fns = {"torch.zeros(115)": zero,
               "deposit kernel": lambda: _build.check(
                   s_lib.probe_sum_deposit(p(x), n, p(ws), stream), "dep"),
               "finishing kernel": lambda: _build.check(
                   s_lib.probe_sum_finish(p(ws), p(bits), stream), "fin"),
               "deposit, plain stores for the miss atomics": lambda:
                   _build.check(plain.probe_sum_deposit(p(x), n, p(ws),
                                                        stream), "plain"),
               "B2b whole entry": whole,
               "torch.sum": lambda: torch.sum(x)}
        for key, ts in ds.in_turns(fns, 9, 10).items():
            print(f"B2b n=2^24 {name} {key}: {ts[0]:.4f} / {ts[1]:.4f} ms "
                  f"[{smi}]", flush=True)
        del x

    a_np, b_np = lognormal_pair()
    a = torch.from_numpy(a_np).cuda()
    b = torch.from_numpy(b_np).cuda()
    from exblas_tpu_torch.ops.kernels import sum_mxu as sm
    ea, eb = sm.exact_anchor(a), sm.exact_anchor(b)

    def run(lib, entry):
        ws = torch.zeros(12, dtype=torch.int64, device="cuda")
        _build.check(getattr(lib, entry)(p(a), p(b), n, p(ea), p(eb), p(ws),
                                         stream), entry)
        return ws

    want = run(d_lib, "dot_flat_cuda")
    got = run(d_lib, "probe_dot_occ")
    if not torch.equal(want, got):
        raise SystemExit("B12 on the occupancy grid differs")
    fns = {"B12 kept": lambda: run(d_lib, "dot_flat_cuda"),
           "B12 occupancy grid": lambda: run(d_lib, "probe_dot_occ"),
           "B12 without products": lambda: run(libs["b12_noprod"][0],
                                               "dot_flat_cuda"),
           "torch.zeros(12)": lambda: torch.zeros(12, dtype=torch.int64,
                                                  device="cuda"),
           "torch.dot": lambda: torch.dot(a, b)}
    for key, ts in ds.in_turns(fns, 9, 10).items():
        print(f"n=2^24 bench lognormal {key}: {ts[0]:.4f} / {ts[1]:.4f} ms "
              f"[{smi}]", flush=True)


NEW_SUM_SIG = {"exsum_bits_cuda": _build.SIGNATURES["exsum_bits_cuda"],
               "exsum_attrs": (_P,)}
NEW_DOT_SIG = {"dot_flat_cuda": _build.SIGNATURES["dot_flat_cuda"],
               "dot_flat_attrs": (_I, _P)}
# B2, timed only (wrong bits): a plain shared store in place of each miss
# digit's atomic, and no finish in the last block
SUM_PLAIN_STORE = {"warpacc.cuh": {
    "      red_shared_nz(&s32[q + t], negative ? -dig : dig);":
    "      s32[q + t] = negative ? -dig : dig;"}}
SUM_NO_FINISH = {"sum_kernel.cu": {"  if (!s_last) return;":
                                   "  if (!s_last || n >= 0) return;"}}
# B2, exact (held to the kept bits): four resident blocks an SM (fewer
# registers a thread), and four doubles a lane a step (half the bytes in
# flight)
SUM_OCC4 = {"sum_kernel.cu": {"__launch_bounds__(kThreads, 3)":
                              "__launch_bounds__(kThreads, 4)"}}
SUM_STEP4 = {"sum_kernel.cu": {"constexpr int kPerStep = 8;":
                               "constexpr int kPerStep = 4;"}}
DOT_OCC4 = {"dot_mxu.cu": {"__launch_bounds__(kThreads, 3)":
                           "__launch_bounds__(kThreads, 4)"}}
# B12, exact: eight pairs a lane a step (twice the bytes in flight)
DOT_STEP8 = {"dot_mxu.cu": {"constexpr int kPerStep = 4;":
                            "constexpr int kPerStep = 8;"}}


def new_layout(csrc: Path, smi: str) -> None:
    p, stream = _build.ptr, _build.stream_of(torch.device("cuda"))
    # B12, timed only (wrong terms): without products (loads, decoding and
    # the flag; the significands folded into a register), and with the
    # products' words folded into a register instead of the frame
    noprod = cut(csrc / "dot_mxu.cu", "    unsigned long long lo, hi;",
                 "    f[4 * kThreads] += __funnelshift_l(p3, 0u, r);",
                 "    bad += ma ^ mb ^ static_cast<unsigned long long>(s);")
    normw = cut(csrc / "dot_mxu.cu", "    unsigned long long* f =",
                "    f[4 * kThreads] += __funnelshift_l(p3, 0u, r);",
                "    bad += (p0 << r) ^ __funnelshift_l(p0, p1, r) ^\n"
                "           __funnelshift_l(p1, p2, r) ^\n"
                "           __funnelshift_l(p2, p3, r) ^\n"
                "           __funnelshift_l(p3, 0u, r) ^ (a ^ b);")
    jobs = {"b2_kept": ("sum_kernel", NEW_SUM_SIG, None),
            "b2_plain_store": ("sum_kernel", NEW_SUM_SIG, SUM_PLAIN_STORE),
            "b2_no_finish": ("sum_kernel", NEW_SUM_SIG, SUM_NO_FINISH),
            "b2_occ4": ("sum_kernel", NEW_SUM_SIG, SUM_OCC4),
            "b2_step4": ("sum_kernel", NEW_SUM_SIG, SUM_STEP4),
            "b12_kept": ("dot_mxu", NEW_DOT_SIG, None),
            "b12_noprod": ("dot_mxu", NEW_DOT_SIG, {"dot_mxu.cu": noprod}),
            "b12_normw": ("dot_mxu", NEW_DOT_SIG, {"dot_mxu.cu": normw}),
            "b12_occ4": ("dot_mxu", NEW_DOT_SIG, DOT_OCC4),
            "b12_step8": ("dot_mxu", NEW_DOT_SIG, DOT_STEP8)}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {tag: pool.submit(ds.build, csrc, src, tag, "", sigs, edits)
                for tag, (src, sigs, edits) in jobs.items()}
        libs = {tag: f.result() for tag, f in futs.items()}
    for tag, (lib, lines, path) in libs.items():
        print(f"ptxas {tag}:", *lines, sep="\n  ", flush=True)
        if tag.endswith("kept"):
            ops = summary_sass(path, tag, ("sum", "dot"))
            cas = {fn: {k: v for k, v in o.items() if "CAS" in k}
                   for fn, o in ops.items() if "sum" in fn}
            if any(cas.values()):
                raise SystemExit(f"B2's SASS holds compare-and-swap: {cas}")
        if tag.startswith("b2_"):
            ds.new_attrs(lib.exsum_attrs, f"B2 {tag}")
        else:
            ds.new_attrs(lib.dot_flat_attrs, f"B12 {tag}, 16-byte loads", 0)
    ds.new_attrs(libs["b12_kept"][0].dot_flat_attrs,
                 "B12 dot_kept, 8-byte loads", 1)

    n = cs.N_BIG
    sums = {tag: lib for tag, (lib, _, _) in libs.items()
            if tag.startswith("b2_")}
    for name, x_np in (("lognormal", lognormal_sum()), ("wide300", wide300())):
        x = torch.from_numpy(x_np).cuda()

        def zero():
            return torch.zeros(116, dtype=torch.int64, device="cuda")

        def whole(lib, bits):
            _build.check(lib.exsum_bits_cuda(p(x), n, p(zero()), p(bits),
                                             stream), "exsum_bits_cuda")
            return bits

        want = int(whole(sums["b2_kept"], torch.empty(
            (), dtype=torch.int64, device="cuda")))
        for tag in ("b2_occ4", "b2_step4"):
            got = int(whole(sums[tag], torch.empty((), dtype=torch.int64,
                                                   device="cuda")))
            if got != want:
                raise SystemExit(f"{tag} on {name}: {got:#x} != {want:#x}")
        bits = torch.empty((), dtype=torch.int64, device="cuda")
        fns = {f"B2b {tag[3:]}": (lambda lib=lib: whole(lib, bits))
               for tag, lib in sums.items()}
        fns["torch.zeros(116)"] = zero
        fns["torch.sum"] = lambda: torch.sum(x)
        for key, ts in ds.in_turns(fns, 9, 10).items():
            print(f"n=2^24 {name} {key}: {ts[0]:.4f} / {ts[1]:.4f} ms "
                  f"[{smi}]", flush=True)
        del x

    a_np, b_np = lognormal_pair()
    a = torch.from_numpy(a_np).cuda()
    b = torch.from_numpy(b_np).cuda()
    from exblas_tpu_torch.ops.kernels import sum_mxu as sm
    ea, eb = sm.exact_anchor(a), sm.exact_anchor(b)
    dots = {tag: lib for tag, (lib, _, _) in libs.items()
            if tag.startswith("b12_")}

    def run(lib):
        ws = torch.zeros(13, dtype=torch.int64, device="cuda")
        _build.check(lib.dot_flat_cuda(p(a), p(b), n, p(ea), p(eb), p(ws),
                                       stream), "dot_flat_cuda")
        return ws

    # the terms and the flag (ws[12] is the ticket: the grid's size)
    want = run(dots["b12_kept"])[:12]
    for tag in ("b12_occ4", "b12_step8"):
        if not torch.equal(run(dots[tag])[:12], want):
            raise SystemExit(f"B12 {tag} differs")
    fns = {f"B12 {tag[4:]}": (lambda lib=lib: run(lib))
           for tag, lib in dots.items()}
    fns["torch.zeros(13)"] = lambda: torch.zeros(13, dtype=torch.int64,
                                                 device="cuda")
    fns["torch.dot"] = lambda: torch.dot(a, b)
    for key, ts in ds.in_turns(fns, 9, 10).items():
        print(f"n=2^24 bench lognormal {key}: {ts[0]:.4f} / {ts[1]:.4f} ms "
              f"[{smi}]", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    args = ap.parse_args()
    smi = cs.phase_device()
    csrc = args.csrc.resolve()
    if "sum_deposit_kernel" in (csrc / "sum_kernel.cu").read_text():
        old_layout(csrc, smi)
    else:
        new_layout(csrc, smi)


if __name__ == "__main__":
    main()
