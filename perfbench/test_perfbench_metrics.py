"""Each metric reader, the trace reduction and the roofline arithmetic on
a small recorded profile."""

import pytest

from perfbench import harness, roofline, trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


# Two calls: the first 0-150 us, the second 160-300 us.
PROFILE = {"traceEvents": [
    _x("ProfilerStep#3", "user_annotation", 0, 155),
    _x("perfbench.call", "user_annotation", 0, 100),
    _x("aten::sum", "cpu_op", 5, 25),
    _x("cudaLaunchKernel", "cuda_runtime", 8, 2),
    _x("perfbench.complete", "user_annotation", 100, 50),
    _x("cudaStreamSynchronize", "cuda_runtime", 100, 45),
    _x("perfbench.call", "user_annotation", 160, 100),
    _x("perfbench.complete", "user_annotation", 260, 40),
    _x("kernel_a", "kernel", 10, 50),
    _x("kernel_b", "kernel", 50, 40),
    _x("Memcpy DtoH", "gpu_memcpy", 120, 20),
    _x("kernel_a", "kernel", 170, 80),
    _x("Memset", "gpu_memset", 255, 3),
    _x("perfbench.call", "gpu_user_annotation", 10, 240),
    {"ph": "s", "name": "flow", "cat": "ac2g", "ts": 8},
]}


@pytest.fixture
def rec():
    tr = trace.from_chrome(PROFILE)
    peak = {"bytes_per_s": 3.35e12, "f64_flops_per_s": 6.7e13}
    return {"window": {"calls": 4, "latencies_s": [0.1, 0.2, 0.3, 0.4],
                       "window_s": 1.0, "setup_s": 7.5},
            "trace": tr, "syncs": [3, 3, 2],
            "work": {"bytes": int(3.35e12 * 45e-6), "flops": 0},
            "peak": peak}


def test_from_chrome(rec):
    tr = rec["trace"]
    assert tr["calls"] == 2 and tr["span_us"] == [0.0, 300.0]
    assert sorted(k for _, k, _, _ in tr["device"]) == [
        "kernel", "kernel", "kernel", "memcpy", "memset"]
    assert all(not n.startswith("ProfilerStep") for n, *_ in tr["host"])


def test_from_chrome_skips_the_first_calls():
    tr = trace.from_chrome(PROFILE, skip=1)
    assert tr["calls"] == 1 and tr["span_us"] == [160.0, 300.0]
    assert trace.busy_us(tr) == pytest.approx(83.0)
    assert trace.from_chrome(PROFILE, skip=2)["calls"] == 0


def test_busy_and_gaps(rec):
    tr = rec["trace"]
    assert trace.busy_us(tr) == pytest.approx(183.0)
    assert trace.idle_gaps(tr) == [(0.0, 10.0), (90.0, 120.0),
                                   (140.0, 170.0), (250.0, 255.0),
                                   (258.0, 300.0)]


def test_breakdown(rec):
    b = trace.breakdown(rec["trace"])
    assert b["device_ops"][0] == ["kernel_a", pytest.approx(130e-6)]
    assert len(b["device_ops"]) == 4
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps == {
        "perfbench.complete/no operation": pytest.approx(42e-6),
        "perfbench.complete/cudaStreamSynchronize": pytest.approx(30e-6),
        "between calls/no operation": pytest.approx(30e-6),
        "perfbench.call/aten::sum": pytest.approx(10e-6),
        "perfbench.call/no operation": pytest.approx(5e-6)}
    assert [v for _, v in b["idle_gaps"]] == sorted(
        (v for _, v in b["idle_gaps"]), reverse=True)


@pytest.mark.parametrize("name, want", [
    ("call_ms", 250.0),
    ("call_p95_ms", 385.0),
    ("setup_s", 7.5),
    ("syncs_per_call", 8 / 3),
    ("launches_per_call", 1.5),
    ("idle_pct", 100 * 117 / 300),
    ("kernels_roofline", 100 * 45 / 91.5),
])
def test_reader(rec, name, want):
    assert harness.reader(name).read(rec) == pytest.approx(want)


@pytest.mark.parametrize("name", ["syncs_per_call", "launches_per_call",
                                  "idle_pct", "kernels_roofline"])
def test_reader_finds_nothing(rec, name):
    """A reader with nothing to read returns None, never 0."""
    empty = dict(rec, trace=trace.from_chrome({"traceEvents": []}),
                 syncs=[], peak=None)
    assert harness.reader(name).read(empty) is None


def test_roofline_arithmetic():
    peak = roofline.peak_of("NVIDIA H100 80GB HBM3")
    assert peak == {"bytes_per_s": 3.35e12, "f64_flops_per_s": 6.7e13}
    assert roofline.peak_of("a card not in the table") is None
    from perfbench.routines import exgemm, exsum
    gemm = exgemm.work({"m": 4096, "n": 4096, "k": 4096})
    assert gemm == {"bytes": 8 * 4 * 4096 ** 2, "flops": 2 * 4096 ** 3}
    # the GEMM is bound by its float64 operations: 2.05 ms
    assert roofline.least_seconds(gemm, peak) == pytest.approx(
        2 * 4096 ** 3 / 6.7e13)
    s = exsum.work({"n": 1 << 28})
    assert s == {"bytes": 8 * (1 << 28) + 8, "flops": 0}
    # the sum by its bytes: 0.641 ms
    assert roofline.least_seconds(s, peak) == pytest.approx(
        (8 * (1 << 28) + 8) / 3.35e12)


def test_ulp_gap():
    import torch

    one = torch.tensor(1.0, dtype=torch.float64).view(torch.int64)
    assert harness.ulp_gap(one, one) == 0
    assert harness.ulp_gap(int(one) + 3, one) == 3
    neg = torch.tensor(-1.0, dtype=torch.float64).view(torch.int64)
    assert harness.ulp_gap(neg, one) > 1 << 61
    pz, nz = 0, int(torch.tensor(-0.0, dtype=torch.float64)
                    .view(torch.int64))
    assert harness.ulp_gap(pz, nz) == 0
