"""Non-reproducible float64 controls.

Counterpart of ``exblas_tpu/baselines.py``: native ``torch.sum``,
``torch.dot``, ``alpha * (op(A) @ x) + beta * y``, ``c + a @ b`` and
``torch.linalg.solve_triangular`` in float64.  They follow the port's
device rule (``ops/exsum.py``): tensors stay where they are; numpy input
and sequences go to the current CUDA device, or to ``device`` when the
caller names one (``device="cpu"`` asks for the CPU); with no CUDA device
and no ``device``, they raise.  On a GPU they reduce in floating point in
an order of the library's choosing, so they are neither reproducible nor
correctly rounded -- they are the speed controls the exact routines are
timed against.
"""

from __future__ import annotations

import torch

from .ops.exsum import as_f64, target_device


def _f64s(*xs, device=None):
    """The operands as float64 tensors on the call's device (``None``
    stays ``None``)."""
    dev = target_device(*(x for x in xs if x is not None), device=device)
    return [None if x is None else as_f64(x, dev) for x in xs]


def sum_baseline(x, device=None) -> float:
    (x,) = _f64s(x, device=device)
    return float(torch.sum(x).item())


def dot_baseline(a, b, device=None) -> float:
    a, b = _f64s(a, b, device=device)
    return float(torch.dot(a.reshape(-1), b.reshape(-1)).item())


def gemv_baseline(trans: str, alpha: float, a, x, beta: float = 0.0,
                  y=None, device=None) -> torch.Tensor:
    """float64 ``alpha * (op(A) @ x) + beta * y`` on the operands' device
    (no y term when beta == 0 or y is None)."""
    a, x, y = _f64s(a, x, y, device=device)
    op = a.t() if trans.upper() == "T" else a
    r = alpha * (op @ x)
    return r if (y is None or beta == 0.0) else r + beta * y


def gemm_baseline(a, b, c=None, device=None) -> torch.Tensor:
    """float64 ``c + a @ b`` (or ``a @ b``) on the operands' device."""
    a, b, c = _f64s(a, b, c, device=device)
    r = a @ b
    return r if c is None else c + r


def trsv_baseline(uplo: str, trans: str, diag: str, a, b,
                  device=None) -> torch.Tensor:
    """float64 solve of op(T) x = b, T the ``uplo`` triangle of ``a``, on
    the operands' device (the reference's DTRSV control, ExTRSV.cpp:80-81)."""
    a, b = _f64s(a, b, device=device)
    upper = uplo.upper() == "U"
    if trans.upper() == "T":
        a = a.t()
        upper = not upper
    x = torch.linalg.solve_triangular(a, b.reshape(-1, 1), upper=upper,
                                      unitriangular=diag.upper() == "U")
    return x.reshape(-1)
