"""The benchmark's harness: one run of one cell.

Everything that belongs to one cell is found by name in
``BENCHMARK.json``:

* a workload names a ``config`` and a ``traffic`` mix:
  ``configs/<config>.json`` and ``traffic/<traffic>.json``;
* a configuration names its ``routine``: the adapter
  ``routines/<routine>.py`` (``load``, ``inputs``, ``call``,
  ``complete``, ``work``, ``describe``, ``fault``, ``FAULTS``, ``ENTRY``,
  ``KEEP``) and
  the plain reference ``reference/<routine>.py`` (``exact_bits``,
  ``control_bits``, ``native_bits``);
* a metric is read by ``metrics/<name>.py`` (see
  :mod:`perfbench.metrics`).

A run runs one process on one card: a cell that asks for more chips is
refused until the harness has a path for a world of several ranks.  It
loads the program (its kernels' library, built on a checkout's first run,
is a phase of its own in the set-up's log), makes ``input_sets`` input
sets from the seed on the device, warms up every one of them with one
call, then calls back to back, cycling through the sets, for ``seconds`` (a closed loop with one caller; a call ends when its
result is ready).  After the window it reads the device's memory peak,
checks that no JAX module was loaded, and compares the answers with the
reference: every answer where the routine keeps them all, else ``KEEP``
of them drawn from the seed.  A traced run also profiles a stretch of
calls inside the window and counts the host synchronizations of a few
more.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import random
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

from . import gen, roofline, syncs, trace
from .reference.bigint import ordered

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "exblas_tpu")
WARM_ROUNDS = 1
TRACE_SECONDS = 2.0  # the traced stretch: about this long,
TRACE_CALLS = (8, 300)  # and between these many calls
TRACE_WARM = 2  # profiled calls dropped before the stretch
SYNC_CALLS = 5  # calls whose host synchronizations are counted


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load(kind: str, name: str) -> dict:
    """``configs/<name>.json`` or ``traffic/<name>.json``."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def routine(config: dict):
    return importlib.import_module(f"perfbench.routines.{config['routine']}")


def reference(config: dict):
    return importlib.import_module(f"perfbench.reference.{config['routine']}")


def reader(metric: str):
    module = metric.replace(".", "_").replace("-", "_")
    return importlib.import_module(f"perfbench.metrics.{module}")


def find_cell(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(the workload's entry, its configuration, its traffic mix)."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w, load("configs", w["config"]), load("traffic",
                                                          w["traffic"])
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, traced: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones, or
    with ``traced`` the per-layer ones."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def devices_of(obj) -> set:
    """The devices of the tensors in ``obj`` (nested dicts, lists and
    tuples)."""
    if isinstance(obj, torch.Tensor):
        return {obj.device}
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return set().union(*(devices_of(o) for o in obj))
    return set()


def ulp_gap(got, ref) -> int:
    """The largest distance in ulps between two sets of binary64 bits
    (int64); bits of opposite signs count as far apart."""
    g = ordered(torch.as_tensor(got, dtype=torch.int64).to(
        torch.as_tensor(ref).device))
    r = ordered(torch.as_tensor(ref, dtype=torch.int64))
    same = (g >= 0) == (r >= 0)
    far = g.abs().clamp(max=1 << 61) + r.abs().clamp(max=1 << 61)
    return int(torch.where(same, (g - r).abs(), far).max())


class Tracer:
    """Profiles a stretch of calls, then counts the host synchronizations
    of a few calls after it (see module doc).  The profiler runs from the
    first call of the window; its first ``TRACE_WARM`` calls, which carry
    its start, are left out of the records."""

    def __init__(self, calls: int, device: torch.device):
        self.calls = calls
        self.device = device
        self.prof = None
        self.records = None
        self.syncs = []
        self.steps = 0
        # The sync debug mode reads a card only.  The first call counted
        # under it reads one synchronization more than every later one, so
        # it is counted and dropped.
        self.sync_calls = SYNC_CALLS + 1 if device.type == "cuda" else 0

    @property
    def done(self) -> bool:
        return self.records is not None and len(self.syncs) >= self.sync_calls

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def before(self) -> None:
        if self.records is None and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def after(self) -> None:
        if self.prof is None:
            return
        self.steps += 1
        if self.steps >= TRACE_WARM + self.calls:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.records = trace.from_chrome(json.load(f),
                                                 skip=TRACE_WARM)
        finally:
            os.unlink(path)

    def counting(self) -> bool:
        return self.records is not None and len(self.syncs) < self.sync_calls

    def counted(self) -> list:
        return self.syncs[1:]


def run_window(rt, call, sets, seconds: float, seed: int,
               tracer: Tracer | None = None) -> dict:
    """The closed loop (see module doc).  Returns the calls, every
    latency, the window's length, the failures and the kept answers as
    (input set, answer)."""
    keep = getattr(rt, "KEEP", None)
    span = tracer.span if tracer else lambda name: contextlib.nullcontext()
    rng = random.Random(seed)
    latencies, kept, failed, errors = [], [], 0, []
    n = 0
    start = time.perf_counter()
    while True:
        j = n % len(sets)
        if tracer is not None:
            tracer.before()
        count = tracer is not None and tracer.counting()
        t0 = time.perf_counter()
        try:
            with span(trace.CALL_SPAN):
                if count:
                    k, out = syncs.count_syncs(lambda: call(sets[j]))
                    tracer.syncs.append(k)
                else:
                    out = call(sets[j])
            with span(trace.COMPLETE_SPAN):
                ans = rt.complete(out)
        except Exception:  # a call that raises is a failed call
            failed += 1
            ans = None
            if len(errors) < 3:
                errors.append(traceback.format_exc())
        t1 = time.perf_counter()
        if tracer is not None:
            tracer.after()
        latencies.append(t1 - t0)
        if ans is not None:
            if keep is None:
                kept.append((j, ans))
            elif len(kept) < keep:
                kept.append((j, ans))
            else:
                r = rng.randrange(n + 1)
                if r < keep:
                    kept[r] = (j, ans)
        n += 1
        if t1 - start >= seconds and (tracer is None or tracer.done):
            break
    if tracer is not None:
        tracer.stop()
    for e in errors:
        print(e, file=sys.stderr)
    return {"calls": n, "latencies_s": latencies, "window_s": t1 - start,
            "failed": failed, "kept": kept}


def check(rt, ref, sets, kept, limits: dict) -> dict:
    """Each kept answer against the reference's for its input set: the
    widest ulp gap, with its limit."""
    gap = 0
    by_set = {}
    for j, ans in kept:
        by_set.setdefault(j, []).append(ans)
    for j, answers in sorted(by_set.items()):
        want = ref.exact_bits(sets[j])
        seen = set()
        for ans in answers:
            key = ans if isinstance(ans, int) else id(ans)
            if key in seen:
                continue
            seen.add(key)
            gap = max(gap, ulp_gap(ans, want))
    return {"ulp_gap": {"value": gap, "limit": limits["ulp_gap"]},
            "answers_checked": len(kept)}


def card_line() -> str:
    """The card's name, power limit, draw and clocks from ``nvidia-smi``
    (an earlier line of the output, beside every number)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"


def run(bench: dict, workload: str, seed: int, seconds: float,
        traced: bool, device, t_start: float, call=None,
        config: dict | None = None, log=print) -> dict:
    """One run of ``workload``; returns the result line's object.

    ``call`` replaces the program's entry (the control, a planted fault);
    ``config`` replaces the configuration (a test's smaller copy).  On a
    CPU ``device`` the run reads no card and no trace of one."""
    device = torch.device(device)
    entry, cfg, traffic = find_cell(bench, workload)
    if int(entry["chips"]) != 1:
        raise SystemExit(f"{workload} asks for {entry['chips']} chips; the "
                         "harness runs one process on one card")
    cfg = config or cfg
    rt, ref = routine(cfg), reference(cfg)
    call = call or rt.call
    phases = [("imports", time.perf_counter())]
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
    phases.append(("CUDA start", time.perf_counter()))
    rt.load(device)
    phases.append(("program and kernels' library", time.perf_counter()))
    g = gen.generator(seed, device)
    sets = [rt.inputs(cfg, traffic, g, device)
            for _ in range(int(cfg["input_sets"]))]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases.append(("inputs", time.perf_counter()))
    warm, used = [], devices_of(sets)
    for _ in range(WARM_ROUNDS):
        for inp in sets:
            t0 = time.perf_counter()
            out = call(inp)
            used |= devices_of(out)
            rt.complete(out)
            warm.append(time.perf_counter() - t0)
    out = None
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    tracer = None
    if traced:
        per_call = max(min(warm[-len(sets):]), 1e-6)
        tracer = Tracer(int(min(max(TRACE_SECONDS / per_call, TRACE_CALLS[0]),
                                TRACE_CALLS[1])), device)
    phases.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    win = run_window(rt, call, sets, seconds, seed, tracer)
    if on_card:
        torch.cuda.synchronize(device)
    peak_bytes = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {found}")

    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    if on_card:
        log(f"card: {card_line()}")
    log(f"{workload}: {rt.ENTRY} {rt.describe(sets[0])}")
    log(f"{workload}: {win['calls']} calls in {win['window_s']} s, "
        f"set-up {setup_s} s, warm-up calls {warm} s")
    by_second, at_s, done = [], 0.0, 0
    for lat in win["latencies_s"]:
        at_s += lat
        done += 1
        if at_s >= 1.0 or done == len(win["latencies_s"]):
            by_second.append(round(at_s * 1e3 / done, 4))
            at_s, done = 0.0, 0
    log(f"{workload}: mean latency a second of calls, ms: {by_second}")
    at = t_start
    split = []
    for name, t in phases:
        split.append(f"{name} {t - at}")
        at = t
    log(f"{workload}: set-up by phase, s: {', '.join(split)}")

    answers = win.pop("kept")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check(rt, ref, sets, answers, cfg["limits"])
    log(f"{workload}: the comparison took {time.perf_counter() - t_check} s")
    correct = (win["failed"] == 0 and bool(answers)
               and checks["ulp_gap"]["value"] <= checks["ulp_gap"]["limit"])

    rec = {"window": dict(win, setup_s=setup_s),
           "trace": tracer.records if tracer else None,
           "syncs": tracer.counted() if tracer else [],
           "work": rt.work(cfg),
           "peak": roofline.peak_of(kind)}
    metrics = {}
    for m in metrics_of(bench, workload, traced):
        value = reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": len(used), "memory_peak_bytes": peak_bytes}
    result = {"correct": correct, "attempted": win["calls"],
              "failed": win["failed"], "metrics": metrics, "device": dev}
    tr = rec["trace"]
    if tr and tr["calls"]:
        t0, t1 = tr["span_us"]
        dev["busy_s"] = trace.busy_us(tr) * 1e-6
        dev["window_s"] = (t1 - t0) * 1e-6
        result["breakdown"] = trace.breakdown(tr)
        log(f"{workload}: traced {tr['calls']} calls, syncs counted "
            f"{tracer.syncs} (the first dropped)")
    result["checks"] = {"ulp_gap": checks["ulp_gap"],
                        "failed_calls": {"value": win["failed"],
                                         "limit": 0}}
    log(f"{workload}: answers checked {checks['answers_checked']}")
    return result
