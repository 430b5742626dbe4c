"""The suite's own schedule in the root ``conftest.py``: the units of a
``--dist load`` run, the longest-first order and the tests marked ``slow``.

The collection runs once, in a subprocess over the whole suite without
``-m``, so the checks hold however this file is selected."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_spec = importlib.util.spec_from_file_location(
    "suite_schedule", os.path.join(ROOT, "conftest.py"))
schedule = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(schedule)

_COLLECT = r"""
import json
import pytest


def own_module_fixture(item):
    module = item.nodeid.split("::", 1)[0]
    return any(d.scope == "module" and d.baseid == module
               for defs in item._fixtureinfo.name2fixturedefs.values()
               for d in defs)


class Record:
    def pytest_collection_finish(self, session):
        self.items = [
            [item.nodeid, item.get_closest_marker("slow") is not None,
             own_module_fixture(item)]
            for item in session.items]


record = Record()
code = pytest.main(["--collect-only", "-q", "-p", "no:cacheprovider",
                    "tests/"], plugins=[record])
print("COLLECTED " + json.dumps(record.items))
raise SystemExit(code)
"""


@pytest.fixture(scope="module")
def collected():
    """``[node id, marked slow, uses a module-scoped fixture of its own
    module]`` for every test of the suite."""
    r = subprocess.run([sys.executable, "-c", _COLLECT], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    line = next(line for line in r.stdout.splitlines()
                if line.startswith("COLLECTED "))
    return json.loads(line[len("COLLECTED "):])


def test_units_group_the_port_modules_that_share_work(collected):
    sharing = {}
    for nodeid, _, own in collected:
        module = nodeid.split("::", 1)[0]
        sharing[module] = sharing.get(module, False) or own
    for module, shares in sharing.items():
        port = os.path.basename(module).startswith("test_torch_")
        assert schedule.shares_work(module) == (port and shares), module
        unit = schedule.schedule_unit(f"{module}::test_a[1]")
        assert unit == (module if port and shares else f"{module}::test_a[1]")
    assert schedule.shares_work("tests/test_torch_parallel.py")
    other = "tests/test_exgemm.py::test_exgemm_vs_oracle[5-7-9]"
    assert schedule.matches("tests/test_exgemm.py::test_exgemm_vs_oracle",
                            other)
    assert not schedule.matches("tests/test_exgemm.py::test_exgemm_vs",
                                other)


def test_schedule_names_collected_tests_and_marks_only_jax_tests(collected):
    ids = [nodeid for nodeid, _, _ in collected]
    for entry in schedule.LONGEST_FIRST:
        assert any(schedule.matches(entry, nodeid) for nodeid in ids), entry
    slow = {nodeid for nodeid, marked, _ in collected if marked}
    assert slow == set(schedule.SLOW)
    for entry in schedule.LONGEST_FIRST:  # each still runs in tier-1
        assert not any(schedule.matches(entry, nodeid) for nodeid in slow)
    for nodeid in slow:
        assert not nodeid.startswith("tests/test_torch_"), nodeid


_RECORDER = """
import os


def record(name):
    with open(os.path.join(os.path.dirname(__file__), "..", "ran.txt"),
              "a") as f:
        f.write(f"{os.environ['PYTEST_XDIST_WORKER']} {name}\\n")
"""


def test_load_runs_a_shared_module_on_one_worker_and_longest_first(
        tmp_path):
    """A small suite under ``-p xdist -n 2 --dist load`` with the root
    ``conftest.py``: the port module with a module fixture runs whole on one
    worker, and the ``LONGEST_FIRST`` test, collected last, runs first."""
    shutil.copy(os.path.join(ROOT, "conftest.py"), tmp_path / "conftest.py")
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "recorder.py").write_text(_RECORDER)
    (tests / "test_a.py").write_text(
        "from recorder import record\n" + "".join(
            f"def test_{i}():\n    record('a{i}')\n" for i in range(6)))
    (tests / "test_torch_shared.py").write_text(
        "import pytest\nfrom recorder import record\n\n"
        "@pytest.fixture(scope=\"module\")\ndef built():\n"
        "    record('built')\n" + "".join(
            f"def test_{i}(built):\n    record('shared{i}')\n"
            for i in range(4)))
    first = schedule.LONGEST_FIRST[0].split("::")
    (tmp_path / first[0]).write_text(
        f"from recorder import record\n\ndef {first[1]}():\n"
        "    record('longest')\n")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-q", "-p",
         "no:cacheprovider", "-p", "xdist", "-n", "2", "--dist", "load"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    ran = [line.split() for line in
           (tmp_path / "ran.txt").read_text().splitlines()]
    assert len(ran) == 6 + 1 + 4 + 1
    shared = {worker for worker, name in ran
              if name.startswith(("shared", "built"))}
    assert len(shared) == 1
    assert [name for _, name in ran].count("built") == 1
    worker = next(worker for worker, name in ran if name == "longest")
    assert [name for w, name in ran if w == worker][0] == "longest"
