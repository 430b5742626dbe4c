"""The routing and plan's wall time a call, in ms: the program's spans
``exblas.sum.route``, ``exblas.dot.route`` and ``exblas.gemm.plan`` of the
traced stretch (the sample or analysis passes, their reads and the tier
or rung chosen), over its calls."""

from perfbench import spans

PLAN_SPANS = ("exblas.sum.route", "exblas.dot.route", "exblas.gemm.plan")


def read(rec):
    return spans.ms_per_call(rec, lambda name: name in PLAN_SPANS)
