"""BENCHMARK.json, the files each cell is found by, and what the
benchmark may import."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "exblas_tpu"}
SOURCES = sorted(HERE.rglob("*.py"))


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_metrics_and_their_keys(bench):
    assert [m["name"] for m in bench["end_to_end"]] == [
        "call_ms", "call_p95_ms", "setup_s"]
    assert {m["name"] for m in bench["per_layer"]} == {
        "syncs_per_call", "launches_per_call", "kernels_roofline",
        "idle_pct"}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] == "call_ms"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert [m["unit"] for m in bench["per_layer"]
            if m["name"].endswith("_roofline")] == ["%"]


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_entries_well_formed(bench, kind):
    names = [e["name"] for e in bench[kind]]
    assert len(names) == len(set(names))
    for e in bench[kind]:
        assert NAME.match(e["name"])
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    if kind == "workloads":
        pairs = [(w["config"], w["traffic"]) for w in bench[kind]]
        assert len(pairs) == len(set(pairs))
        assert all(w["chips"] == 1 for w in bench[kind])
        used = {w["config"] for w in bench[kind]}
        assert used == {c["name"] for c in bench["configs"]}


@pytest.mark.parametrize("workload", [
    "gemm4096-range2", "sum2p28-range2", "sum2p28-range300",
    "gemm4096-range50"])
def test_cell_found_by_name(bench, workload):
    entry, cfg, traffic = harness.find_cell(bench, workload)
    assert cfg["name"] == entry["config"]
    assert traffic["name"] == entry["traffic"]
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    assert conf["file"] == f"perfbench/configs/{cfg['name']}.json"
    assert conf["reduced"] == cfg["reduced"]
    assert all(k in cfg for k in conf["reduced"])
    rt, ref = harness.routine(cfg), harness.reference(cfg)
    for name in ("inputs", "call", "complete", "work", "describe", "fault"):
        assert callable(getattr(rt, name))
    for name in ("exact_bits", "control_bits", "native_bits"):
        assert callable(getattr(ref, name))
    for traced in (False, True):
        for m in harness.metrics_of(bench, workload, traced):
            assert callable(harness.reader(m["name"]).read)
    assert cfg["limits"] == {"ulp_gap": 0}


def test_run_seconds_fit_the_check(bench):
    """A full check of 24 cells at this length fits its 43200 seconds."""
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "math", "torch"}


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if not p.name.startswith("test_")],
    ids=lambda p: str(p.relative_to(HERE)))
def test_reads_no_jax_benchmark_files(path):
    """No string outside a docstring names the JAX package's benchmark
    files or the smoke test (this file's list of them aside)."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            for name in ("benchmarks", "bench.py", "chip_smoke", "BENCH_r",
                         "MULTICHIP_r", "BASELINE.json", "RESULTS.md"):
                assert name not in node.value


def test_no_jax_module_after_import():
    """Importing every module of the benchmark and the program loads no
    module of JAX or the JAX package (top-level names compared whole)."""
    mods = ["perfbench." + ".".join(p.relative_to(HERE).with_suffix("").parts)
            for p in SOURCES if not p.name.startswith(("test_", "conftest"))]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import importlib, sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import exblas_tpu_torch\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted({n for n in sys.modules if n.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}}})\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env={"USE_FLAX": "0",
                                                      "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
