"""The port's timing and profiling utilities (``exblas_tpu_torch.utils``)
on the CPU: ``bench_min``'s result and a positive time, ``gb_per_s`` and
``gflops``, ``amortized_seconds``' contract, and a trace file written by
``profiling.trace`` with an ``annotate`` span in it.  Also that no module
of the port imports JAX or the JAX package."""

import glob
import json
import os
import pathlib
import re

import pytest
import torch

from exblas_tpu_torch.utils import bench_utils, profiling, timing


def test_bench_min_returns_time_and_output():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    best, out = timing.bench_min(fn, torch.arange(5.0), iters=4, warmup=2)
    assert best > 0
    assert torch.equal(out, torch.arange(5.0) * 2)
    assert len(calls) == 6


def test_bench_min_waits_only_on_cuda_results():
    nested = (torch.zeros(2), [torch.ones(1), {"a": torch.ones(3)}], 7)
    assert timing._cuda_devices(nested) == set()
    timing._wait(nested)  # nothing to synchronize on the CPU


def test_rates():
    assert timing.gb_per_s(2_000_000_000, 0.5) == pytest.approx(4.0)
    assert timing.gflops(3_000_000_000, 1.5) == pytest.approx(2.0)


def test_amortized_seconds_contract():
    """make_repeat_fn(R) gives a function of R dependent iterations; the
    estimate is positive and per iteration."""
    seen = []

    def make(R):
        seen.append(R)

        def run(x):
            for _ in range(R):
                x = x + 1
            return x
        return run

    t = bench_utils.amortized_seconds(make, (torch.zeros(1000),), R=4,
                                      reps=2)
    assert seen == [1, 4]
    assert t > 0
    assert bench_utils._device((3, torch.zeros(1))).type == "cpu"


def test_trace_writes_chrome_trace_with_annotation(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        with profiling.annotate("exblas_span"):
            torch.arange(1000.0).sum()
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "exblas_span" for e in events)


def test_port_imports_no_jax():
    """No module of the port imports JAX or the JAX package."""
    root = pathlib.Path(__file__).resolve().parent.parent / "exblas_tpu_torch"
    pat = re.compile(r"^\s*(import|from) (jax|exblas_tpu)(\s|\.|$)")
    found = [f"{p}:{i}" for p in sorted(root.rglob("*.py"))
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if pat.match(line)]
    assert found == []
