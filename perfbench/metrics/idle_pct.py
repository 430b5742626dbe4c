"""The share of the traced stretch's wall time in which no device
operation (kernel, copy, memset) runs, in percent."""

from perfbench import trace


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["calls"]:
        return None
    t0, t1 = tr["span_us"]
    if t1 <= t0:
        return None
    return 100.0 * (1.0 - trace.busy_us(tr) / (t1 - t0))
