"""Non-reproducible float64 controls.

Counterpart of ``exblas_tpu/baselines.py``: native ``torch.sum``,
``torch.dot``, ``alpha * (op(A) @ x) + beta * y``, ``c + a @ b`` and
``torch.linalg.solve_triangular`` in float64 on the tensors' device (numpy
input runs on the CPU).  On a GPU
they reduce in floating point in an order of the library's choosing, so
they are neither reproducible nor correctly rounded -- they are the speed
controls the exact routines are timed against.
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


def gemv_baseline(trans: str, alpha: float, a, x, beta: float = 0.0,
                  y=None) -> torch.Tensor:
    """float64 ``alpha * (op(A) @ x) + beta * y`` on the operands' device
    (no y term when beta == 0 or y is None)."""
    a = _f64(a)
    op = a.t() if trans.upper() == "T" else a
    r = alpha * (op @ _f64(x))
    return r if (y is None or beta == 0.0) else r + beta * _f64(y)


def gemm_baseline(a, b, c=None) -> torch.Tensor:
    """float64 ``c + a @ b`` (or ``a @ b``) on the operands' device."""
    r = _f64(a) @ _f64(b)
    return r if c is None else _f64(c) + r


def trsv_baseline(uplo: str, trans: str, diag: str, a, b) -> torch.Tensor:
    """float64 solve of op(T) x = b, T the ``uplo`` triangle of ``a``, on
    the operands' device (the reference's DTRSV control, ExTRSV.cpp:80-81)."""
    a = _f64(a)
    upper = uplo.upper() == "U"
    if trans.upper() == "T":
        a = a.t()
        upper = not upper
    x = torch.linalg.solve_triangular(a, _f64(b).reshape(-1, 1), upper=upper,
                                      unitriangular=diag.upper() == "U")
    return x.reshape(-1)
