"""Whole runs of the harness at a size a test can hold: on the CPU with
the program's plain path, the look for a card skipped; the program as it
is comes out correct, and the control and every planted fault come out
not correct."""

import json
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from perfbench import harness

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"sum2p28-range2": {"n": 3001},
         "sum2p28-range300": {"n": 2999},
         "gemm4096-range2": {"m": 24, "n": 16, "k": 40},
         "gemm4096-range50": {"m": 16, "n": 12, "k": 24}}


def small_run(bench, workload, call=None, traced=False, seed=2**33 + 17,
              device="cpu"):
    _, cfg, _ = harness.find_cell(bench, workload)
    return harness.run(bench, workload, seed, 0.3, traced, device,
                       time.perf_counter(), call=call,
                       config=dict(cfg, **SMALL[workload]),
                       log=lambda s: None)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(bench, workload):
    r = small_run(bench, workload)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 1
    want = {m["name"] for m in harness.metrics_of(bench, workload, False)}
    assert set(r["metrics"]) == want
    assert {"call_ms", "setup_s"} <= want
    assert r["checks"] == {"ulp_gap": {"value": 0, "limit": 0},
                           "failed_calls": {"value": 0, "limit": 0}}
    json.dumps(r)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_traced_run(bench, workload, monkeypatch):
    """A traced run reports the per-layer metrics it can read (on the CPU
    no card's peak and no sync count) and the trace's breakdown."""
    monkeypatch.setattr(harness, "TRACE_CALLS", (5, 10))
    r = small_run(bench, workload, traced=True)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"launches_per_call", "idle_pct"}
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_is_not_correct(bench, workload):
    """The reference computed in float32, put in the program's place."""
    _, cfg, _ = harness.find_cell(bench, workload)
    ref = harness.reference(cfg)
    r = small_run(bench, workload, call=ref.control_bits)
    assert r["correct"] is False
    assert r["checks"]["ulp_gap"]["value"] > 1000


FAULTS = [(w, f) for w in sorted(SMALL)
          for f in harness.routine(
              harness.load("configs", "exgemm-n4096" if w.startswith("gemm")
                           else "exsum-n2p28")).FAULTS]


@pytest.mark.parametrize("workload, fault", FAULTS)
def test_planted_fault_is_not_correct(bench, workload, fault):
    _, cfg, _ = harness.find_cell(bench, workload)
    rt = harness.routine(cfg)
    r = small_run(bench, workload, call=lambda inp: rt.fault(fault, inp))
    assert r["correct"] is False
    assert r["checks"]["ulp_gap"]["value"] >= 1


def test_limits_readings(bench):
    """The limits tool's readings: the program reads 0, the control and
    each fault more."""
    from perfbench import limits

    _, cfg, _ = harness.find_cell(bench, "sum2p28-range2")
    rows = list(limits.readings(bench, "sum2p28-range2", [3], [4], 0.1,
                                True, device="cpu",
                                config=dict(cfg, **SMALL["sum2p28-range2"])))
    sides = {r["side"]: r for r in rows}
    assert set(sides) == {"program", "control_f32", "native_f64",
                          "fault_altered", "fault_half"}
    assert sides["program"]["ulp_gap"] == 0 and sides["program"]["correct"]
    for side in ("control_f32", "fault_altered", "fault_half"):
        assert sides[side]["ulp_gap"] >= 1 and not sides[side]["correct"]


def test_failed_call_is_not_correct(bench):
    """A call of the window that raises is a failed call."""
    from perfbench.routines import exsum

    calls = []

    def broken(inp):
        calls.append(1)
        if len(calls) > 2 * harness.WARM_ROUNDS:
            raise RuntimeError("planted")
        return exsum.call(inp)

    r = small_run(bench, "sum2p28-range2", call=broken)
    assert r["correct"] is False and r["failed"] == r["attempted"]


def test_device_count_is_measured(bench):
    r = small_run(bench, "gemm4096-range2")
    assert r["device"]["count"] == 1


def test_cell_of_several_chips_is_refused(bench):
    """One process on one card: a cell of 4 chips stops the run."""
    wide = dict(bench, workloads=[dict(w, chips=4)
                                  for w in bench["workloads"]])
    with pytest.raises(SystemExit):
        small_run(wide, "sum2p28-range2")


def test_jax_module_stops_the_run(bench, monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    with pytest.raises(SystemExit):
        small_run(bench, "sum2p28-range2")


def test_same_seed_same_answers(bench):
    a = small_run(bench, "sum2p28-range300", seed=5)
    b = small_run(bench, "sum2p28-range300", seed=5)
    assert a["correct"] and b["correct"]


def _run_py(cwd: Path):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "sum2p28-range2",
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_without_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_needs_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    a run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and "correct" not in out.stdout


@pytest.mark.card
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_small_run_on_the_card(bench, workload, cuda_device):
    r = small_run(bench, workload, device=cuda_device, traced=True)
    assert r["correct"] is True
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
