#!/usr/bin/env python3
"""Where the time of the exact sum kernel B2, the anchored dot kernel B12,
the anchored sum kernel B11 and the term rounding B3 goes, on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 scripts/stream_split.py [--csrc DIR] [--parts b2b12,b11b3]

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
  without its last block's finish, B12 without its products, without
  its frame's read-modify-writes and without its last block's rounding.

``--parts b11b3`` (``sum_mxu.cu``, ``round_terms.cu``) times B11 at
n = 2^24 on the bench lognormal data at nwa 3, 4 and 5 (its workspace's
zeroing included: the window pass) in turns with ``torch.sum``: in its
grid-stride layout (``sum_flat_kernel`` on ``deposit_grid``) as it is,
without its frame add (the loads alone) and on the occupancy calculator's
grid; in its persistent layout (``sum_window_kernel``) against its other
designs, steps, loads alone and without the last block's rounding (see
``new_b11``), with resources and the main loop's SASS.  Then B3: its
wrapper against an empty launch, its kernel launched from C against as
many empty launches, and one rounding's latency as device code alone.
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
# B11 and B12, timed only (no bits): the last block carries the terms but
# does not round them, to show the fold's cost
NO_ROUND = {"round.cuh": {
    "  out[T + 1] = static_cast<long long>(\n"
    "      round_scaled_terms(terms, FramePos{}, T, limbs, frame_limbs(T), e));":
    "  (void)limbs;\n  (void)e;"}}


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
    if "finish_frame" in (csrc / "dot_mxu.cu").read_text():
        jobs["b12_no_round"] = ("dot_mxu", NEW_DOT_SIG, NO_ROUND)
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
        ws = torch.zeros(14, dtype=torch.int64, device="cuda")
        _build.check(lib.dot_flat_cuda(p(a), p(b), n, p(ea), p(eb), p(ws),
                                       stream), "dot_flat_cuda")
        return ws

    # the terms, the flag and, where the last block rounds, the bits (then
    # ws[13] is the ticket, else ws[12]: the grid's size)
    keep = 13 if "finish_frame" in (csrc / "dot_mxu.cu").read_text() else 12
    want = run(dots["b12_kept"])[:keep]
    for tag in ("b12_occ4", "b12_step8"):
        if not torch.equal(run(dots[tag])[:keep], want):
            raise SystemExit(f"B12 {tag} differs")
    fns = {f"B12 {tag[4:]}": (lambda lib=lib: run(lib))
           for tag, lib in dots.items()}
    fns["torch.zeros(14)"] = lambda: torch.zeros(14, dtype=torch.int64,
                                                 device="cuda")
    fns["torch.dot"] = lambda: torch.dot(a, b)
    for key, ts in ds.in_turns(fns, 9, 10).items():
        print(f"n=2^24 bench lognormal {key}: {ts[0]:.4f} / {ts[1]:.4f} ms "
              f"[{smi}]", flush=True)


# ---------------------------------------------------------------------------
# B11 (the anchored sum) and B3 (the term rounding)
# ---------------------------------------------------------------------------

def bench_lognormal_sum():
    """chip_smoke.py's bench lognormal sum data (bench_sum.py:32-37)."""
    return xt.init_lognormal(cs.N_BIG, 1.0, 2.0, seed=10)


# B3 on its own: its kernel launched `reps` times from one C call (no
# wrapper work between launches) beside as many empty launches, and the
# device rounding run `reps` times in one thread of one launch, each
# rounding's exponent depending on the last one's bits, so that the time
# is the latency of one rounding with its limbs in local memory (B3's
# kernel) or in shared memory (the window kernels' last blocks).
B3_PROBES = r"""
namespace {
__global__ void empty_kernel() {}

template <bool kShared>
__global__ void round_loop_kernel(const long long* __restrict__ vals,
                                  Positions pos, int t, int nl,
                                  const int* __restrict__ eadj, int eadd,
                                  int reps, unsigned long long* out) {
  __shared__ long long s_limbs[kShared ? kMaxTermLimbs : 1];
  long long l_limbs[kShared ? 1 : kMaxTermLimbs];
  long long* limbs = kShared ? s_limbs : l_limbs;
  const int e = *eadj + eadd;
  unsigned long long acc = 0ULL;
  for (int i = 0; i < reps; ++i) {
    acc ^= exblas::round_scaled_terms(vals, pos.p, t, limbs, nl,
                                      e + static_cast<int>(acc & 1ULL));
  }
  *out = acc;
}
}  // namespace

extern "C" int probe_launches(int which, const void* vals, const void* pos,
                              int t, int nl, const void* eadj, int eadd,
                              int reps, void* out, void* stream) {
  Positions p{};
  for (int i = 0; i < t; ++i) p.p[i] = static_cast<const int*>(pos)[i];
  const auto s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < reps; ++i) {
    if (which == 0) {
      round_terms_kernel<<<1, 1, 0, s>>>(
          static_cast<const long long*>(vals), p, t, nl,
          static_cast<const int*>(eadj), eadd,
          static_cast<unsigned long long*>(out));
    } else {
      empty_kernel<<<1, 1, 0, s>>>();
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_loop(int shared, const void* vals, const void* pos,
                          int t, int nl, const void* eadj, int eadd,
                          int reps, void* out, void* stream) {
  Positions p{};
  for (int i = 0; i < t; ++i) p.p[i] = static_cast<const int*>(pos)[i];
  const auto s = static_cast<cudaStream_t>(stream);
  const auto v = static_cast<const long long*>(vals);
  const auto ea = static_cast<const int*>(eadj);
  const auto o = static_cast<unsigned long long*>(out);
  if (shared) {
    round_loop_kernel<true><<<1, 1, 0, s>>>(v, p, t, nl, ea, eadd, reps, o);
  } else {
    round_loop_kernel<false><<<1, 1, 0, s>>>(v, p, t, nl, ea, eadd, reps, o);
  }
  return static_cast<int>(cudaGetLastError());
}
"""
B3_SIG = {"probe_launches": (_I, _P, _P, _I, _I, _P, _I, _I, _P, _P),
          "probe_loop": (_I, _P, _P, _I, _I, _P, _I, _I, _P, _P)}


def b3_split(csrc: Path, smi: str, terms: dict) -> None:
    """B3 against an empty launch, by its wrapper and from C, and the
    device latency of one rounding; ``terms``: {label: (vals, positions,
    e_adjust, e_offset)} on the card."""
    from exblas_tpu_torch.ops.kernels import round_in_kernel as rk

    p, stream = _build.ptr, _build.stream_of(torch.device("cuda"))
    lib, lines, _ = ds.build(csrc, "round_terms", "b3_probe", B3_PROBES,
                             B3_SIG)
    print("ptxas b3_probe:", *lines, sep="\n  ", flush=True)
    out = torch.zeros((), dtype=torch.int64, device="cuda")
    for label, (vals, pos, eadj, eoff) in terms.items():
        t, nl = len(pos), rk.term_limbs_count(pos)
        cpos = (ctypes.c_int * t)(*pos)

        def launches(which, reps=100):
            _build.check(lib.probe_launches(which, p(vals), cpos, t, nl,
                                            p(eadj), eoff, reps, p(out),
                                            stream), "probe_launches")

        def loop(shared, reps=1000):
            _build.check(lib.probe_loop(shared, p(vals), cpos, t, nl,
                                        p(eadj), eoff, reps, p(out), stream),
                         "probe_loop")

        fns = {"B3 wrapper (a call)": lambda: rk.round_scaled_terms_cuda(
                   vals, pos, eadj, eoff),
               "empty launch, torch.cuda._sleep(0) (a call)":
                   lambda: torch.cuda._sleep(0)}
        for key, ts in ds.in_turns(fns, 9, 50).items():
            print(f"B3 {label} {key}: {ts[0]:.4f} / {ts[1]:.4f} ms [{smi}]",
                  flush=True)
        fns = {"B3 kernel, 100 launches from C (a launch)":
                   lambda: launches(0),
               "empty kernel, 100 launches from C (a launch)":
                   lambda: launches(1),
               "one rounding in one thread, limbs in local memory":
                   lambda: loop(0),
               "one rounding in one thread, limbs in shared memory":
                   lambda: loop(1)}
        per = {k: 100 if "100" in k else 1000 for k in fns}
        for key, ts in ds.in_turns(fns, 5, 3).items():
            print(f"B3 {label} {key}: {1e3 * ts[0] / per[key]:.3f} / "
                  f"{1e3 * ts[1] / per[key]:.3f} us [{smi}]", flush=True)


# B11 in its grid-stride layout (sum_flat_kernel<NW> on deposit_grid, four 8-byte
# loads a thread a step, anchored.cuh's two's complement and shifter):
# its resources and grid, and variants: without its frame add (the decode
# kept, folded into one XOR: the loads alone; wrong sums, timed only) and
# on the occupancy calculator's grid (held to the kept sums).
OLD_B11 = ds.ATTRS + WAVE + r"""
static const void* b11_fn(int nwa) {
  return nwa == 3 ? reinterpret_cast<const void*>(sum_flat_kernel<3>)
         : nwa == 4 ? reinterpret_cast<const void*>(sum_flat_kernel<4>)
                    : reinterpret_cast<const void*>(sum_flat_kernel<5>);
}
extern "C" int probe_attrs(int nwa, int* out) {
  return put_attrs(b11_fn(nwa), exblas::kBlock, out);
}
extern "C" int probe_grid(long long n, int* out) {
  cudaError_t err = exblas::deposit_grid(n, &out[0]);
  out[1] = wave_blocks(b11_fn(3), exblas::kBlock);
  return static_cast<int>(err);
}
"""
OLD_B11_SIG = {"sum_flat_cuda": (_P, _N, _P, _I, _P, _P),
               "probe_attrs": (_I, _P), "probe_grid": (_N, _P)}
OLD_B11_OCC = {"sum_mxu.cu": {
    '#include "deposit.cuh"':
    '#include "deposit.cuh"\n#include "stream.cuh"',
    "  cudaError_t err = exblas::deposit_grid(n, &grid);":
    "  cudaError_t err = exblas::persistent_grid(\n"
    "      reinterpret_cast<const void*>(sum_flat_kernel<NW>), exblas::kBlock,\n"
    "      (n + exblas::kBlock * kUnroll - 1) / (exblas::kBlock * kUnroll),\n"
    "      &grid);"}}


def b11_timing(libs: dict, held: tuple, smi: str, ws_len, keep) -> None:
    """B11 at n = 2^24 on the bench lognormal data at nwa 3, 4 and 5 at its
    exact anchor: ``libs`` {label: library with sum_flat_cuda} in turns
    with torch.sum; the libraries in ``held`` must give the first one's
    ws[:keep(nwa)] (of ws_len(nwa) int64: the sums or terms, the flag and
    any bits, not the ticket)."""
    from exblas_tpu_torch.ops.kernels import sum_mxu as sm

    p, stream = _build.ptr, _build.stream_of(torch.device("cuda"))
    n = cs.N_BIG
    x = torch.from_numpy(bench_lognormal_sum()).cuda()
    e = sm.exact_anchor(x)
    first = next(iter(libs))
    for nwa in (3, 4, 5):
        def run(lib, nwa=nwa):
            ws = torch.zeros(ws_len(nwa), dtype=torch.int64, device="cuda")
            _build.check(lib.sum_flat_cuda(p(x), n, p(e), nwa, p(ws), stream),
                         "sum_flat_cuda")
            return ws

        want = run(libs[first])[:keep(nwa)]
        for label in held:
            if not torch.equal(run(libs[label])[:keep(nwa)], want):
                raise SystemExit(f"B11 {label} nwa={nwa} differs")
        fns = {f"B11 {label}": (lambda lib=lib: run(lib))
               for label, lib in libs.items()}
        fns["torch.zeros"] = lambda: torch.zeros(ws_len(nwa),
                                                 dtype=torch.int64,
                                                 device="cuda")
        fns["torch.sum"] = lambda: torch.sum(x)
        for key, ts in ds.in_turns(fns, 9, 10).items():
            print(f"n=2^24 bench lognormal nwa={nwa} {key}: {ts[0]:.4f} / "
                  f"{ts[1]:.4f} ms [{smi}]", flush=True)


def old_b11(csrc: Path, smi: str) -> None:
    loads = cut(csrc / "sum_mxu.cu", "      const bool add = m != 0ULL",
                "add && b[u] < 0);",
                "      sums[0] ^= m ^ static_cast<unsigned long long>(sh);")
    jobs = {"kept": None, "loads_alone": {"sum_mxu.cu": loads},
            "occupancy_grid": OLD_B11_OCC}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {tag: pool.submit(ds.build, csrc, "sum_mxu", f"b11_{tag}",
                                 OLD_B11, OLD_B11_SIG, edits)
                for tag, edits in jobs.items()}
        libs = {tag: f.result() for tag, f in futs.items()}
    for tag, (lib, lines, path) in libs.items():
        print(f"ptxas b11_{tag}:", *lines, sep="\n  ", flush=True)
        for nwa in (3, 4, 5):
            ds.attrs(lib, nwa, f"B11 {tag} nwa={nwa}")
        if tag == "kept":
            summary_sass(path, "b11_kept", ("sum_flat",))
            print("  (the loop adds 4 elements a thread: kUnroll)", flush=True)
    grid_line(libs["kept"][0], "B11 sum_flat_kernel", cs.N_BIG)
    b11_timing({tag: lib for tag, (lib, _, _) in libs.items()},
               ("occupancy_grid",), smi, lambda nwa: nwa + 2,
               lambda nwa: nwa + 2)


# B11 on the persistent shape: the kept design (i) (anchored.cuh
# SumFrame: each thread's word sums in shared memory, indexed by the word
# and the sign, as B12 keeps its frame: three 64-bit read-modify-writes an
# element) against the other two, each held to the kept terms, flag and
# bits:
#   (ii) word sums in registers with the same sign split, each of the
#        element's three words selecting its target word directly;
#   (iii) one two's-complement register window of nwa + 1 words over the
#        whole frame: the signed significand shifted by sh mod 64 (two
#        64-bit shifts), placed at the frame's 64-bit half sh / 64 and
#        added by one carry chain;
# the kept design at eight elements a thread a step (four 16-byte loads,
# as B2); and, timed only (wrong sums): without the frame's adds (the
# decode kept, folded into one XOR: the loads alone), and without the
# last block's rounding (NO_ROUND).
FRAME_DECODE = r"""
  static constexpr int kShared = 16;  // the last block's rounding limbs
  int c;
  unsigned long long bad;
  int exm;
  __device__ __forceinline__ void init(int anchor, unsigned long long*) {
    c = anchor + 1075 + 1 - 32 * NW;
    bad = 0ULL;
    exm = 0;
    clear();
  }
  __device__ __forceinline__ bool flagged() const {
    return bad != 0ULL || exm == 0x7FF;
  }
"""
SPLIT_FRAME = r"""
template <int NW>
struct SplitFrame {
  static constexpr int kWords = NW + 1;
  static constexpr int kMaxSh = 32 * NW - 53;
  unsigned long long pos[kWords], neg[kWords];
""" + FRAME_DECODE + r"""
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < kWords; ++k) pos[k] = neg[k] = 0ULL;
  }
  __device__ __forceinline__ void add(long long v) {
    const int ex = static_cast<int>((v >> 52) & 0x7FF);
    const int sh = (ex > 1 ? ex : 1) - c;
    const bool in = static_cast<unsigned>(sh) <= kMaxSh && ex != 0x7FF;
    if (!in) bad |= static_cast<unsigned long long>(v) << 1;
    exm = max(exm, ex);
    const unsigned long long m =
        in ? (static_cast<unsigned long long>(v) & ((1ULL << 52) - 1ULL)) |
                 (ex != 0 ? 1ULL << 52 : 0ULL)
           : 0ULL;
    const int s = in ? sh : 0;
    const unsigned r = static_cast<unsigned>(s) & 31u;
    const unsigned m0 = static_cast<unsigned>(m);
    const unsigned m1 = static_cast<unsigned>(m >> 32);
    const unsigned y0 = m0 << r, y1 = __funnelshift_l(m0, m1, r),
                   y2 = __funnelshift_l(m1, 0u, r);
    const int q = s >> 5;
    const bool ng = v < 0;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const unsigned t = q == k ? y0 : (q == k - 1 ? y1 : (q == k - 2 ? y2 : 0u));
      pos[k] += ng ? 0u : t;
      neg[k] += ng ? t : 0u;
    }
  }
  __device__ __forceinline__ long long word(int k) const {
    return static_cast<long long>(pos[k] - neg[k]);
  }
};
"""
WINDOW_FRAME = r"""
template <int N>
__device__ __forceinline__ void add_words(unsigned (&w)[N],
                                          const unsigned (&x)[N]) {
  if constexpr (N == 4) {
    asm("add.cc.u32 %0, %0, %4;\n\t"
        "addc.cc.u32 %1, %1, %5;\n\t"
        "addc.cc.u32 %2, %2, %6;\n\t"
        "addc.u32 %3, %3, %7;"
        : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]));
  } else if constexpr (N == 5) {
    exblas::add160(w, x[0], x[1], x[2], x[3], x[4]);
  } else {
    asm("add.cc.u32 %0, %0, %6;\n\t"
        "addc.cc.u32 %1, %1, %7;\n\t"
        "addc.cc.u32 %2, %2, %8;\n\t"
        "addc.cc.u32 %3, %3, %9;\n\t"
        "addc.cc.u32 %4, %4, %10;\n\t"
        "addc.u32 %5, %5, %11;"
        : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]),
          "+r"(w[5])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]));
  }
}

template <int NW>
struct SumWindow {
  static constexpr int kWords = NW + 1;
  static constexpr int kMaxSh = 32 * NW - 53;
  unsigned w[kWords];
""" + FRAME_DECODE + r"""
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < kWords; ++j) w[j] = 0u;
  }
  __device__ __forceinline__ void add(long long v) {
    const int ex = static_cast<int>((v >> 52) & 0x7FF);
    const int sh = (ex > 1 ? ex : 1) - c;
    const bool in = static_cast<unsigned>(sh) <= kMaxSh && ex != 0x7FF;
    if (!in) bad |= static_cast<unsigned long long>(v) << 1;
    exm = max(exm, ex);
    const long long keep = in ? -1LL : 0LL;
    const long long mant =
        ((v & ((1LL << 52) - 1)) | (ex != 0 ? 1LL << 52 : 0LL)) & keep;
    const long long neg = keep & (v >> 63);
    const long long sv = (mant ^ neg) - neg;
    const unsigned s = static_cast<unsigned>(sh) & 63u;
    const unsigned long long lo =
        exblas::shl64(static_cast<unsigned long long>(sv), s);
    const long long hi = exblas::sar64(sv, 64u - s);
    const unsigned y[6] = {
        static_cast<unsigned>(lo), static_cast<unsigned>(lo >> 32),
        static_cast<unsigned>(hi), static_cast<unsigned>(hi >> 32),
        static_cast<unsigned>(neg), static_cast<unsigned>(neg)};
    const bool h = kMaxSh >= 64 && sh >= 64;
    unsigned x[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) x[j] = h ? (j >= 2 ? y[j - 2] : 0u) : y[j];
    add_words<kWords>(w, x);
  }
  __device__ __forceinline__ long long word(int k) const {
    return k < NW ? static_cast<long long>(w[k])
                  : static_cast<long long>(static_cast<int>(w[k]));
  }
};
"""
NEW_B11_SIG = {"sum_flat_cuda": _build.SIGNATURES["sum_flat_cuda"],
               "sum_flat_attrs": (_I, _P)}


def frame_design(name: str, code: str) -> dict:
    return {"sum_mxu.cu": {
        "constexpr int kUnits = kPerStep / 2;  // 16-byte loads a thread a "
        "step\n":
        "constexpr int kUnits = kPerStep / 2;  // 16-byte loads a thread a "
        "step\n" + code,
        "  using Frame = exblas::SumFrame<NW, kThreads>;":
        f"  using Frame = {name}<NW>;"}}


def new_b11(csrc: Path, smi: str) -> None:
    loads = cut(csrc / "anchored.cuh",
                "    const unsigned r = static_cast<unsigned>(s) & 31u;",
                "    p[2 * kThreads] += __funnelshift_l(m1, 0u, r);",
                "    bad ^= m ^ static_cast<unsigned long long>(s);")
    jobs = {"kept": None,
            "ii_split_registers": frame_design("SplitFrame", SPLIT_FRAME),
            "iii_register_window": frame_design("SumWindow", WINDOW_FRAME),
            "step8": {"sum_mxu.cu": {"constexpr int kPerStep = 4;":
                                     "constexpr int kPerStep = 8;"}},
            "loads_alone": {"anchored.cuh": loads},
            "no_round": NO_ROUND}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {tag: pool.submit(ds.build, csrc, "sum_mxu", f"b11_{tag}", "",
                                 NEW_B11_SIG, edits)
                for tag, edits in jobs.items()}
        libs = {tag: f.result() for tag, f in futs.items()}
    for tag, (lib, lines, path) in libs.items():
        print(f"ptxas b11_{tag}:", *lines, sep="\n  ", flush=True)
        for nwa in (3, 4, 5):
            ds.new_attrs(lib.sum_flat_attrs, f"B11 {tag} nwa={nwa}", nwa)
        if tag not in ("loads_alone", "no_round"):
            summary_sass(path, f"b11_{tag}", ("sum_window",))
            print(f"  (the loop adds {8 if tag == 'step8' else 4} elements "
                  "a thread: kPerStep)", flush=True)
    b11_timing({tag: lib for tag, (lib, _, _) in libs.items()},
               ("ii_split_registers", "iii_register_window", "step8"), smi,
               lambda nwa: nwa + 4, lambda nwa: nwa + 3)


def b3_terms() -> dict:
    """B3's inputs on the main path: B11's terms at nwa 3 and 5 and B12's,
    at the bench lognormal data's exact anchors."""
    from exblas_tpu_torch.ops.kernels import dot_mxu as dm
    from exblas_tpu_torch.ops.kernels import sum_mxu as sm

    x = torch.from_numpy(bench_lognormal_sum()).cuda()
    e = sm.exact_anchor(x)
    out = {}
    for nwa in (3, 5):
        rel, _ = sm.sum_flat_cuda(x, e, nwa)
        out[f"sum nwa={nwa} ({nwa + 1} terms)"] = (
            rel.clone(), sm.frame_positions(nwa), e, 1 - 32 * nwa)
    a, b = (torch.from_numpy(v).cuda() for v in lognormal_pair())
    ea, eb = sm.exact_anchor(a), sm.exact_anchor(b)
    rel, _ = dm.dot_flat_cuda(a, b, ea, eb)
    out["dot (11 terms)"] = (rel.clone(), sm.frame_positions(dm.FRAME_WORDS),
                             ea + eb, dm.FRAME_OFFSET)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("--parts", default="b2b12,b11b3",
                    help="comma-separated: b2b12 (B2 and B12), b11b3 (B11 "
                         "and B3)")
    args = ap.parse_args()
    parts = args.parts.split(",")
    smi = cs.phase_device()
    csrc = args.csrc.resolve()
    if "b2b12" in parts:
        if "sum_deposit_kernel" in (csrc / "sum_kernel.cu").read_text():
            old_layout(csrc, smi)
        else:
            new_layout(csrc, smi)
    if "b11b3" in parts:
        if "deposit_grid" in (csrc / "sum_mxu.cu").read_text():
            old_b11(csrc, smi)
        else:
            new_b11(csrc, smi)
        b3_split(csrc, smi, b3_terms())


if __name__ == "__main__":
    main()
