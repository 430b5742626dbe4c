"""The port's spans and sync counter (``exblas_tpu_torch.utils.profiling``)
on the CPU, with the plain path at the smallest sizes that take each
route: with no profile running a span is the shared no-op and a call
opens none, but every host synchronization is counted by its cause; under
``profiling.trace`` a call's Chrome trace holds its program spans nested
inside its entry span."""

import glob
import json
import os

import pytest
import torch

import exblas_tpu_torch as xt
from exblas_tpu_torch.utils import profiling

N_LADDER = 1 << 20  # the smallest sum that takes the anchored ladder


def _narrow():
    """Values in [1, 2): the sampled spread fits the narrowest window."""
    g = torch.Generator().manual_seed(5)
    return torch.rand(N_LADDER, dtype=torch.float64, generator=g) + 1


def _wide300():
    """Values over 300 binades: no window fits, the exact route runs."""
    g = torch.Generator().manual_seed(6)
    e = torch.randint(-150, 150, (N_LADDER,), generator=g)
    return (torch.rand(N_LADDER, dtype=torch.float64, generator=g) + 1
            ) * torch.exp2(e.to(torch.float64))


def _gemm_beta1():
    g = torch.Generator().manual_seed(7)
    a, b, c = (torch.rand(s, dtype=torch.float64, generator=g)
               for s in ((4, 3), (3, 5), (4, 5)))
    return xt.exgemm_bits("N", "N", 1.0, a, b, beta=1.0, c=c, impl="torch")


def test_annotate_is_the_shared_no_op_when_off():
    assert profiling.annotate("exblas.test") is profiling.NO_SPAN
    with profiling.NO_SPAN, profiling.NO_SPAN:  # reusable and re-entrant
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.annotate("exblas.test") is not profiling.NO_SPAN


@pytest.mark.parametrize("case, want", [
    ("sum_narrow", {"spread": 1, "flag": 1}),
    ("sum_wide300", {"spread": 1}),
    ("gemm_beta1", {"scalar": 4, "plan": 1}),
])
def test_a_call_counts_its_syncs_and_opens_no_span(monkeypatch, case, want):
    calls = {"sum_narrow": lambda: xt.exsum_bits(_narrow(), impl="torch"),
             "sum_wide300": lambda: xt.exsum_bits(_wide300(), impl="torch"),
             "gemm_beta1": _gemm_beta1}[case]
    opened = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: opened.append(name))
    before = dict(profiling.host_sync.counts)
    calls()
    after = profiling.host_sync.counts
    got = {k: after[k] - before.get(k, 0) for k in after
           if after[k] != before.get(k, 0)}
    assert got == want
    assert opened == []


def test_trace_nests_the_ladder_spans_in_the_entry(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        xt.exsum_bits(_narrow(), impl="torch")
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and e["name"].startswith("exblas.")]
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)

    def inside(e, outer):
        return (e["tid"] == outer["tid"] and e["ts"] >= outer["ts"]
                and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])

    assert sorted(by_name) == ["exblas.exsum_bits", "exblas.sum.route",
                               "exblas.sum.window.nwa3", "exblas.sync.flag",
                               "exblas.sync.spread"]
    assert all(len(v) == 1 for v in by_name.values())
    (entry,), (route,), (window,) = (by_name[n] for n in (
        "exblas.exsum_bits", "exblas.sum.route", "exblas.sum.window.nwa3"))
    assert all(inside(e, entry) for e in spans)
    assert inside(by_name["exblas.sync.spread"][0], route)
    assert inside(by_name["exblas.sync.flag"][0], window)
