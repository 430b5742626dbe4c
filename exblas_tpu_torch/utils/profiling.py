"""Tracing / profiling helpers: the port's spans and its sync counter.

Port of ``exblas_tpu/utils/profiling.py``, the analog of the reference's
compile-time EXBLAS_TIMING instrumentation (SURVEY §5): wall-clock
harnesses live in utils.timing / utils.bench_utils; this module adds
host and device traces via ``torch.profiler``, written as Chrome trace
files (``*.pt.trace.json``) that TensorBoard and Perfetto read.

Spans.  The program marks its own steps with :func:`annotate` (a context
manager) and :func:`spanned` (a decorator).  Each is one shared no-op
unless a ``torch.profiler`` profile is running, and then a
``record_function`` event: it lands in the same trace as the kernels,
copies and memsets, on the profiler's clock.  Names follow one scheme:

* ``exblas.<entry>`` (one dot): a public entry of ``ops/``, the call;
* ``exblas.<routine>.<stage>``: a step of a call, such as
  ``exblas.sum.route``, ``exblas.sum.window.nwa3`` or ``exblas.gemm.plan``;
* ``exblas.launch.<C entry>``: a kernel wrapper of ``ops/kernels/``, from
  its argument checks through the launch's error check;
* ``exblas.sync.<cause>``: a statement that makes the host wait for the
  device (:func:`host_sync`).

The trace records no span ids.  A span's parent is the span that contains
it on the same thread, and a call's spans are those inside its entry span;
a caller that calls from one thread at a time can so tell its calls apart.

Counter.  :func:`host_sync` counts the host synchronizations of the sum
and dot ladders and of the GEMM's operands and plan, by cause, in
``host_sync.counts``, whether or not a profile runs.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

# What annotate returns while no profile runs: one shared, reusable context.
NO_SPAN = contextlib.nullcontext()


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
    """Named span inside a trace (context manager): ``record_function``
    while a profile runs, else :data:`NO_SPAN`, which costs nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return NO_SPAN


def spanned(name: str):
    """Decorator: each call of the function is the span ``name`` (see
    :func:`annotate`; the flag is checked inline, which costs a third of
    entering :data:`NO_SPAN`).  Attributes set on the decorated function,
    such as a wrapper's ``launches``, live on what the module's name
    refers to."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with record_function(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def host_sync(cause: str):
    """Context manager around one statement that makes the host wait for
    the device: counts it in ``host_sync.counts[cause]`` and, while a
    profile runs, is the span ``exblas.sync.<cause>``.  Causes:
    ``spread`` (the sampled anchor's read), ``guard`` (the exact anchor's
    read in the guard band), ``flag`` (a window pass's flag), ``plan``
    (the GEMM plan's packed read) and ``scalar`` (a host scalar copied to
    the device)."""
    counts = host_sync.counts
    counts[cause] = counts.get(cause, 0) + 1
    return annotate("exblas.sync." + cause)


host_sync.counts = {}
