"""The readers of the program's own spans (``spans.py`` and the metrics
``plan_ms``, ``sync_wait_ms``, ``wrapper_host_ms``, ``program_idle_pct``)
on a small recorded profile with nested ``exblas.`` spans and known idle
gaps, and on one without program spans, where each reads None."""

import pytest

from perfbench import harness, spans, trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _call(t, route, window, launch, flag, spread):
    """One sum call's harness and program spans, from ``t``."""
    ua = "user_annotation"
    return [_x("perfbench.call", ua, t, 100),
            _x("exblas.exsum_bits", ua, t + 2, 96),
            _x("exblas.sum.route", ua, *route),
            _x("exblas.sync.spread", ua, *spread),
            _x("exblas.sum.window.nwa3", ua, *window),
            _x("exblas.launch.sum_flat_cuda", ua, *launch),
            _x("exblas.sync.flag", ua, *flag)]


# Two calls, the stretch 0-300 us; a span after it is not counted.
HARNESS = [
    _x("perfbench.complete", "user_annotation", 100, 50),
    _x("perfbench.complete", "user_annotation", 260, 40),
    _x("kernel_sample", "kernel", 10, 28),
    _x("kernel_window", "kernel", 55, 7),
    _x("Memset", "gpu_memset", 95, 2),
    _x("kernel_sample", "kernel", 170, 5),
    _x("kernel_window", "kernel", 190, 9),
    _x("Memcpy DtoH", "gpu_memcpy", 255, 2),
]
PROFILE = {"traceEvents": HARNESS
           + _call(0, (4, 36), (42, 54), (44, 6), (60, 30), (30, 8))
           + _call(160, (164, 16), (182, 74), (184, 6), (200, 50),
                   (170, 8))
           + [_x("exblas.exsum_bits", "user_annotation", 320, 10)]}


def _rec(profile):
    return {"window": {"calls": 2, "latencies_s": [1e-4, 1e-4],
                       "window_s": 3e-4, "setup_s": 1.0},
            "trace": trace.from_chrome(profile), "syncs": [2, 2],
            "work": {"bytes": 8, "flops": 0}, "peak": None}


def test_program_spans_in_the_stretch():
    found = spans.program_spans(_rec(PROFILE)["trace"])
    assert len(found) == 12
    assert all(0 <= s < 300 for _, s, _ in found)
    assert spans.union([(5, 9), (1, 3), (2, 4), (8, 12)]) == [[1, 4], [5, 12]]


@pytest.mark.parametrize("name, want", [
    ("plan_ms", (36 + 16) / 2 * 1e-3),
    ("sync_wait_ms", (8 + 30 + 8 + 50) / 2 * 1e-3),
    ("wrapper_host_ms", (6 + 6) / 2 * 1e-3),
    # idle 2-10, 38-55, 62-95, 97-98, 162-170, 175-190, 199-255, 257-258
    ("program_idle_pct", 100 * 139 / 300),
])
def test_span_reader(name, want):
    assert harness.reader(name).read(_rec(PROFILE)) == pytest.approx(want)


def test_program_idle_is_part_of_idle():
    rec = _rec(PROFILE)
    idle = harness.reader("idle_pct").read(rec)
    assert idle == pytest.approx(100 * 247 / 300)
    assert harness.reader("program_idle_pct").read(rec) <= idle


def test_breakdown_names_the_innermost_program_span():
    gaps = dict(trace.breakdown(_rec(PROFILE)["trace"])["idle_gaps"])
    assert gaps["perfbench.call/exblas.sync.flag"] == pytest.approx(89e-6)
    assert gaps["perfbench.call/exblas.launch.sum_flat_cuda"] == (
        pytest.approx(17e-6))
    assert gaps["perfbench.call/exblas.sum.window.nwa3"] == pytest.approx(
        15e-6)


@pytest.mark.parametrize("name", ["plan_ms", "sync_wait_ms",
                                  "wrapper_host_ms", "program_idle_pct"])
def test_span_reader_finds_nothing(name):
    """Without program spans (a program that has none), without device
    operations (a run on the CPU) and without a trace, each reader returns
    None, never 0."""
    harness_only = [e for e in PROFILE["traceEvents"]
                    if not e["name"].startswith("exblas.")] + [
        _x("perfbench.call", "user_annotation", 0, 100),
        _x("perfbench.call", "user_annotation", 160, 100)]
    host_only = [e for e in PROFILE["traceEvents"]
                 if e["cat"] == "user_annotation"]
    read = harness.reader(name).read
    assert read(_rec({"traceEvents": harness_only})) is None
    assert read(_rec({"traceEvents": host_only})) is None
    assert read(dict(_rec(PROFILE), trace=None)) is None


def test_span_metrics_declared(bench):
    """The four readers' entries: program spans, moving call_ms, in the
    layers BENCHMARK.json already names, reported in every cell."""
    by_name = {m["name"]: m for m in bench["per_layer"]}
    layers = {"plan_ms": "routing and plan",
              "sync_wait_ms": "routing and plan",
              "wrapper_host_ms": "kernel wrappers and PyTorch ops",
              "program_idle_pct": "device"}
    for name, layer in layers.items():
        m = by_name[name]
        assert m["layer"] == layer and m["moves"] == "call_ms"
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert "workloads" not in m
    assert [m["name"] for m in bench["per_layer"]][-4:] == list(layers)
