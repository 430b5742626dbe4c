"""The program's own spans in the traced stretch, for the readers of the
per-layer metrics that read them.

The program marks its steps with ``record_function`` spans named
``exblas.<...>`` (``user_annotation`` rows of the trace's host records):
``exblas.<entry>`` around a public call, ``exblas.<routine>.<stage>``
around a step of it, ``exblas.launch.<C entry>`` around a kernel wrapper
and ``exblas.sync.<cause>`` around a statement that waits for the device.
A span counts when it starts inside the stretch.  Where the trace holds
no program span at all (a program without them), or no device operation
(a run of the plain path on the CPU, where no span waits for or launches
on a card), every reader here returns None.
"""

from __future__ import annotations

from perfbench import trace

PREFIX = "exblas."


def program_spans(tr: dict | None) -> list | None:
    """Each program span of the trace records ``tr`` that starts inside
    the stretch, as (name, start, end); None without any, or without a
    device operation (see module doc)."""
    if not tr or not tr["calls"] or not tr["device"]:
        return None
    t0, t1 = tr["span_us"]
    out = [(n, s, s + d) for n, cat, s, d in tr["host"]
           if cat == "user_annotation" and n.startswith(PREFIX)
           and t0 <= s < t1]
    return out or None


def union(intervals) -> list:
    """Sorted disjoint [start, end] covering the given intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def ms_per_call(rec: dict, picked) -> float | None:
    """The wall time covered by the program spans whose name ``picked``
    accepts, in ms a call of the stretch (nested or overlapping spans
    counted once); None where the trace holds no program span."""
    tr = rec.get("trace")
    spans = program_spans(tr)
    if spans is None:
        return None
    covered = union((s, e) for n, s, e in spans if picked(n))
    return sum(e - s for s, e in covered) * 1e-3 / tr["calls"]


def idle_inside_us(tr: dict, spans) -> float:
    """The stretch's idle time (no device operation running) that falls
    inside the union of ``spans`` [(name, start, end)], in us."""
    covered = union((s, e) for _, s, e in spans)
    total, j = 0.0, 0
    for gs, ge in trace.idle_gaps(tr):
        while j < len(covered) and covered[j][1] <= gs:
            j += 1
        k = j
        while k < len(covered) and covered[k][0] < ge:
            total += min(ge, covered[k][1]) - max(gs, covered[k][0])
            k += 1
    return total
