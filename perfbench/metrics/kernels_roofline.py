"""The routine's least time on the card over the device-busy time a call,
in percent.  The least time is the larger of the routine's bytes (each
input read once, the output written once) over the card's memory
bandwidth and its float64 operations over the card's float64 peak
(:mod:`perfbench.roofline`), so the share counts the routine's work
whatever kernels implement it.  Nothing is read on a card without an
entry in ``peaks.json``."""

from perfbench import roofline, trace


def read(rec):
    tr, peak = rec.get("trace"), rec.get("peak")
    if not tr or not tr["calls"] or not peak:
        return None
    busy = trace.busy_us(tr) * 1e-6 / tr["calls"]
    if busy <= 0:
        return None
    return 100.0 * roofline.least_seconds(rec["work"], peak) / busy
