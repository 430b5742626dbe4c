"""Milliseconds a call: the window's length over the calls completed in
it, so that every stall inside the window counts."""


def read(rec):
    w = rec["window"]
    return w["window_s"] * 1e3 / w["calls"] if w["calls"] else None
