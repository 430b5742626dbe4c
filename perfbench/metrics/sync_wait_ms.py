"""The host's time blocked in synchronizations a call, in ms: the
program's ``exblas.sync.<cause>`` spans of the traced stretch, each around
one statement that waits for the device, over its calls."""

from perfbench import spans


def read(rec):
    return spans.ms_per_call(rec, lambda name: name.startswith(
        "exblas.sync."))
