"""The order and the units of a run of ``tests/``, and the tests it leaves
out as ``slow``.  (``tests/conftest.py`` sets up the backends.)

Under pytest-xdist's ``--dist load`` a port module that builds a
module-scoped fixture runs as one unit on one worker, so the fixture is
built once; every other test is a unit of its own.  The units go out
longest first as ``LONGEST_FIRST`` names them, the rest in collection order.
Without xdist, or under another ``--dist``, only the ``slow`` marks apply.
"""

import functools
import os
import re

import pytest

ROOT = os.path.dirname(os.path.abspath(__file__))

# The units a ``--durations=0`` run of the tier-1 command measured at over
# 80 s, handed out first, longest first; each entry is a node id, a test
# function (all its cases) or a module.  Seconds: setup, call and teardown
# on 6 workers of an 8-core CPU box with a cold JAX cache, in a run with the
# marks below.  Tests of one file share compiles through the JAX cache, so
# whichever runs first pays them.
LONGEST_FIRST = (
    "tests/test_fuzz_mesh.py::test_fuzz_mesh_deterministic_slice",  # 626
    "tests/test_gemv_mxu.py::test_mxu_gemv_cancellation",  # 347
    "tests/test_exgemm.py::test_exgemm_mxu_auto_specials_interpret",  # 279
    "tests/test_exgemm.py::test_exgemm_mxu_wide_rung_interpret",  # 262
    "tests/test_fuzz.py::test_fuzz_regression_renorm_top_limb_sign",  # 252
    "tests/test_exgemm.py::test_exgemm_mxu_asymmetric_rungs_interpret",  # 251
    "tests/test_torch_exgemv.py",  # 200
    "tests/test_distributed_blas2.py::"
    "test_extrsv_sharded_mesh_invariance[L-N-N]",  # 191
    "tests/test_sum_mxu.py::test_padding_edge_sizes",  # 163
    "tests/test_torch_parallel.py",  # 154
    "tests/test_distributed_blas2.py::"
    "test_extrsv_sharded_mesh_invariance[U-N-U]",  # 134
    "tests/test_dot_mxu.py::test_padding_edge_sizes",  # 124
    "tests/test_torch_fuzz.py",  # 104
    "tests/test_round_scaled_terms.py::test_random_vs_fraction",  # 92, 89
    "tests/test_apps.py::test_rng_sum_strong_reproducibility",  # 90
    "tests/test_extrsv.py::test_extrsv_pallas_kernel_interpret",  # 82
    "tests/test_distributed_blas2.py::"
    "test_extrsv_sharded_mesh_invariance[U-T-N]",  # 82
)

# Single tests of the JAX package that take minutes alone, marked ``slow``:
# the tier-1 run (``-m 'not slow'``) leaves them out, ``-m slow`` runs them.
# Taken longest alone first, the fewest with which two tier-1 runs ended
# within 1100 s on the box above (with 16, one took 1244 s), passing over
# the mesh fuzzer, the one test of its file.  Seconds: the test alone in a
# pytest process of its own with a cold JAX cache, six such at a time.
SLOW = (
    "tests/test_gemv_mxu.py::test_wide_range_rung44",  # 1385
    "tests/test_gemv_mxu.py::test_mxu_gemv_alpha_beta",  # 1251
    "tests/test_gemv_mxu.py::test_wide_range_rungs_extended",  # 848
    "tests/test_gemv_mxu.py::test_wide_range_rungs_round4",  # 841
    "tests/test_gemv_mxu.py::test_mxu_gemv_deep_subnormal_beta",  # 823
    "tests/test_gemv_mxu.py::test_mxu_gemv_specials",  # 803
    "tests/test_exgemm.py::test_exgemm_mxu_auto_interpret",  # 683
    "tests/test_distributed_blas2.py::"
    "test_exgemv_sharded_rows_auto_path[2]",  # 463
    "tests/test_distributed_blas2.py::"
    "test_exgemv_sharded_rows_auto_path[4]",  # 449
    "tests/test_distributed_blas2.py::"
    "test_exgemv_sharded_rows_auto_path[1]",  # 401
    "tests/test_gemv_mxu.py::test_mxu_gemv_uniform[130-300]",  # 369
    "tests/test_gemv_mxu.py::test_mxu_gemv_row_anchors",  # 356
    "tests/test_gemv_mxu.py::test_mxu_gemv_rung2_and_fallback",  # 354
    "tests/test_gemv_mxu.py::test_mxu_gemv_multi_tile_auto",  # 351
    "tests/test_gemv_mxu.py::test_mxu_gemv_uniform[64-100]",  # 349
    "tests/test_gemv_mxu.py::test_mxu_gemv_uniform[128-256]",  # 348
    "tests/test_gemv_mxu.py::test_mxu_gemv_tiny_and_subnormal",  # 345
)

_MODULE_FIXTURE = re.compile(r"@pytest\.fixture\([^)]*scope=\"module\"")


@functools.cache
def shares_work(module: str) -> bool:
    """Whether ``module`` (a path from the root) is a port test module with
    a module-scoped fixture of its own: a unit of its own under
    ``--dist load``."""
    if not os.path.basename(module).startswith("test_torch_"):
        return False
    with open(os.path.join(ROOT, module)) as f:
        return _MODULE_FIXTURE.search(f.read()) is not None


def schedule_unit(nodeid: str) -> str:
    """The unit of work ``nodeid`` is scheduled in: its module if that
    :func:`shares_work`, else the test itself."""
    module = nodeid.split("::", 1)[0]
    return module if shares_work(module) else nodeid


def matches(entry: str, nodeid: str) -> bool:
    """Whether ``entry`` (a node id, a test function or a module) names the
    test or unit ``nodeid``."""
    return nodeid == entry or nodeid.startswith((entry + "::", entry + "["))


@functools.cache
def start_rank(unit: str) -> int:
    """Where ``unit`` stands in ``LONGEST_FIRST``; the rest after it."""
    return next((i for i, entry in enumerate(LONGEST_FIRST)
                 if matches(entry, unit)), len(LONGEST_FIRST))


@pytest.hookimpl(tryfirst=True)  # marks ``slow`` before ``-m`` deselects
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """``--dist load`` on the units of :func:`schedule_unit`, handed out
    longest first, a unit at a time as a worker runs short."""
    if config.getvalue("dist") != "load":
        return None
    from xdist.scheduler import LoadScopeScheduling

    class UnitScheduling(LoadScopeScheduling):
        def _split_scope(self, nodeid):
            return schedule_unit(nodeid)

        def _assign_work_unit(self, node):
            # stable: units of equal rank keep collection order
            units = sorted(self.workqueue.items(),
                           key=lambda unit: start_rank(unit[0]))
            self.workqueue.clear()
            self.workqueue.update(units)
            super()._assign_work_unit(node)

    # LoadScopeScheduling would order the units by their number of tests.
    config.option.loadscopereorder = False
    return UnitScheduling(config, log)
