"""Non-reproducible float64 controls.

Counterpart of ``exblas_tpu/baselines.py``: native ``torch.sum``,
``torch.dot`` and ``c + a @ b`` in float64 on the tensors' device (numpy
input runs on the CPU).  On a GPU they reduce in
floating point in an order of the library's choosing, so they are neither
reproducible nor correctly rounded -- they are the speed controls the exact
routines are timed against.
"""

from __future__ import annotations

import numpy as np
import torch


def _f64(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def sum_baseline(x) -> float:
    return float(torch.sum(_f64(x)).item())


def dot_baseline(a, b) -> float:
    return float(torch.dot(_f64(a).reshape(-1), _f64(b).reshape(-1)).item())


def gemm_baseline(a, b, c=None) -> torch.Tensor:
    """float64 ``c + a @ b`` (or ``a @ b``) on the operands' device."""
    r = _f64(a) @ _f64(b)
    return r if c is None else _f64(c) + r
