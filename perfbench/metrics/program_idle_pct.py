"""The share of the traced stretch's wall time in which no device
operation runs while the host is inside one of the program's ``exblas.``
spans, in percent: the idle that the program's host path causes, as
against the harness's loop and its wait for the result.  At most
``idle_pct``."""

from perfbench import spans


def read(rec):
    tr = rec.get("trace")
    found = spans.program_spans(tr)
    if found is None:
        return None
    t0, t1 = tr["span_us"]
    if t1 <= t0:
        return None
    return 100.0 * spans.idle_inside_us(tr, found) / (t1 - t0)
