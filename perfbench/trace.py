"""From a ``torch.profiler`` trace to the records the metric readers take.

The harness marks every call of the traced stretch with two spans of its
own, ``perfbench.call`` around the program's entry and
``perfbench.complete`` around the wait for its result.  The stretch runs
from the first call's start to the last completion's end.  A device
operation is a kernel, a copy or a memset on the card; the device is
busy where at least one runs (the union of their intervals) and idle in
the gaps.
"""

from __future__ import annotations

import bisect
import heapq
from collections import defaultdict

CALL_SPAN = "perfbench.call"
COMPLETE_SPAN = "perfbench.complete"
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
               "gpu_memset": "memset"}
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10  # entries of each list in the breakdown
NAME_CHARS = 120


def from_chrome(trace: dict, skip: int = 0) -> dict:
    """Records of an exported Chrome trace (``traceEvents``): ``calls``,
    ``span_us``, ``device`` [name, kind, start, duration] and ``host``
    [name, category, start, duration], times in microseconds.  The
    stretch leaves out the first ``skip`` calls."""
    device, host, calls, ends = [], [], [], []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        row = [ev.get("name", ""), cat, float(ev["ts"]),
               float(ev.get("dur", 0.0))]
        if cat in DEVICE_CATS:
            row[1] = DEVICE_CATS[cat]
            device.append(row)
        elif cat in HOST_CATS and not row[0].startswith("ProfilerStep#"):
            host.append(row)
            if row[0] == CALL_SPAN:
                calls.append(row[2])
            elif row[0] == COMPLETE_SPAN:
                ends.append(row[2] + row[3])
    calls = sorted(calls)[skip:]
    ends = [e for e in ends if calls and e > calls[0]]
    if not calls or not ends:
        return {"calls": 0, "span_us": None, "device": [], "host": []}
    return {"calls": len(calls), "span_us": [calls[0], max(ends)],
            "device": device, "host": host}


def busy_intervals(rec: dict) -> list:
    """The union of the device operations' intervals, clipped to the
    stretch, as sorted disjoint [start, end]."""
    t0, t1 = rec["span_us"]
    spans = sorted((max(s, t0), min(s + d, t1))
                   for _, _, s, d in rec["device"] if s < t1 and s + d > t0)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(rec: dict) -> float:
    return sum(e - s for s, e in busy_intervals(rec))


def idle_gaps(rec: dict) -> list:
    """The stretch's intervals in which no device operation runs."""
    t0, t1 = rec["span_us"]
    out, at = [], t0
    for s, e in busy_intervals(rec):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if t1 > at:
        out.append((at, t1))
    return out


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def host_activity(rec: dict, times: list) -> list:
    """For each time, what the host was doing: the harness's span around
    it and the innermost host operation running, as ``span/operation``."""
    spans = sorted((s, s + d, n) for n, _, s, d in rec["host"]
                   if n in (CALL_SPAN, COMPLETE_SPAN))
    starts = [s for s, _, _ in spans]
    events = sorted((s, s + d, n) for n, _, s, d in rec["host"]
                    if n not in (CALL_SPAN, COMPLETE_SPAN))
    order = sorted(range(len(times)), key=lambda i: times[i])
    names = [""] * len(times)
    active, k = [], 0
    for i in order:
        t = times[i]
        while k < len(events) and events[k][0] <= t:
            heapq.heappush(active, (events[k][1], -events[k][0], events[k][2]))
            k += 1
        while active and active[0][0] < t:
            heapq.heappop(active)
        inner = active[0][2] if active else "no operation"
        j = bisect.bisect_right(starts, t) - 1
        outer = (spans[j][2] if j >= 0 and spans[j][1] >= t
                 else "between calls")
        names[i] = _short(f"{outer}/{inner}")
    return names


def breakdown(rec: dict) -> dict:
    """The device operations that took most time, by name, and the idle
    time by what the host was doing, each the ``TOP`` largest, in
    seconds."""
    by_op = defaultdict(float)
    t0, t1 = rec["span_us"]
    for name, _, s, d in rec["device"]:
        if s < t1 and s + d > t0:
            by_op[_short(name)] += min(s + d, t1) - max(s, t0)
    gaps = idle_gaps(rec)
    by_host = defaultdict(float)
    for name, (s, e) in zip(host_activity(rec, [(s + e) / 2 for s, e in gaps]),
                            gaps):
        by_host[name] += e - s

    def top(d):
        return [[k, v * 1e-6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}
