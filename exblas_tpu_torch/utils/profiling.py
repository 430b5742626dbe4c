"""Tracing / profiling helpers.

Port of ``exblas_tpu/utils/profiling.py``, the analog of the reference's
compile-time EXBLAS_TIMING instrumentation (SURVEY §5): wall-clock
harnesses live in utils.timing / utils.bench_utils; this module adds
host and device traces via ``torch.profiler``, written as Chrome trace
files (``*.pt.trace.json``) that TensorBoard and Perfetto read.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the CPU and, where there is one, the CUDA device
    around a block of work; the trace file goes under ``log_dir``.

    Example::

        with profiling.trace("exblas_trace"):
            xt.exsum(x)
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Named sub-span inside a trace (context manager)."""
    return record_function(name)
