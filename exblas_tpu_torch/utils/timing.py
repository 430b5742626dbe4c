"""Benchmark harness: min-of-k timing with GB/s / GFLOPS reporting.

Port of ``exblas_tpu/utils/timing.py``, the analog of the reference's
EXBLAS_TIMING instrumentation (rdtsc min-of-50 on CPU, clEnqueueMarker
min-of-NUM_ITER on GPU; reference src/gpu/blas/blas1/ExSUM.cpp:149-185,
src/cpu/blas/blas1/ExSUM.cpp:124-165).
"""

from __future__ import annotations

import time

import torch


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in ``out`` (a tensor, or a tuple,
    list or dict of them, nested)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.device.type == "cuda" else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return set().union(*(_cuda_devices(o) for o in out))
    return set()


def _wait(out) -> None:
    """Wait until the work that produced ``out`` has finished: synchronize
    each CUDA device that holds one of its tensors (CPU results are ready
    when the call returns)."""
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


def bench_min(fn, *args, iters: int = 20, warmup: int = 2):
    """Return (the minimum wall-clock seconds over ``iters`` runs of
    fn(*args), the last result).

    Each run waits for the device that holds its result, so device work is
    included, mirroring the reference's event-based GPU timing.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _wait(out)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _wait(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def gb_per_s(nbytes: int, seconds: float) -> float:
    return 1e-9 * nbytes / seconds


def gflops(nflops: int, seconds: float) -> float:
    return 1e-9 * nflops / seconds
