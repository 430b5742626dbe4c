"""The kernel wrappers' host time a call, in ms: the program's
``exblas.launch.<C entry>`` spans of the traced stretch (argument checks,
workspace allocation, the launch and its error check), over its calls."""

from perfbench import spans


def read(rec):
    return spans.ms_per_call(rec, lambda name: name.startswith(
        "exblas.launch."))
