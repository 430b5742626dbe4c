"""ExDOT: exact (bit-reproducible, correctly rounded) dot product (PyTorch).

Counterpart of ``exblas_tpu/ops/exdot.py``; the API mirrors the reference's
``exdot(Ng, ag, inca, offseta, bg, incb, offsetb, fpe, early_exit)``.  The
accumulator covers the full product range down to ``2^-2148``, so products
that underflow double precision are still absorbed exactly.

``impl``, ``device``, the device rules and ``fpe``/``early_exit`` are those
of :mod:`.exsum`.  Both operands must lie on one device.
"""

from __future__ import annotations

import torch

from ..core.rounding import bits_to_float
from ..core.types import Superacc
from .exsum import _validate_fpe, as_f64_vector, resolve_impl, target_device
from .kernels import dot_kernel

__all__ = ["exdot", "exdot_acc", "exdot_bits"]


def _operands(a, b, inca, offseta, incb, offsetb, fpe, device):
    _validate_fpe(fpe, "exdot")
    dev = target_device(a, b, device=device)
    a = as_f64_vector(a, inca, offseta, dev)
    b = as_f64_vector(b, incb, offsetb, dev)
    if a.shape != b.shape:
        raise ValueError(f"exdot: shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    return a, b


def exdot_acc(a, b, inca: int = 1, offseta: int = 0, incb: int = 1,
              offsetb: int = 0, fpe: int = 3, early_exit: bool = False,
              impl: str | None = None, device=None) -> Superacc:
    """Exact dot product into a DOT_FORMAT Superacc."""
    a, b = _operands(a, b, inca, offseta, incb, offsetb, fpe, device)
    if resolve_impl(impl, a.device) == "cuda":
        return dot_kernel.exdot_acc_cuda(a, b)
    return dot_kernel.exdot_acc_torch(a, b)


def exdot_bits(a, b, inca: int = 1, offseta: int = 0, incb: int = 1,
               offsetb: int = 0, fpe: int = 3, early_exit: bool = False,
               impl: str | None = None, device=None) -> torch.Tensor:
    """Exact dot product as binary64 bits: a 0-dim int64 tensor."""
    a, b = _operands(a, b, inca, offseta, incb, offsetb, fpe, device)
    if resolve_impl(impl, a.device) == "cuda":
        return dot_kernel.exdot_bits_cuda(a, b)
    return dot_kernel.exdot_bits_torch(a, b)


def exdot(a, b, inca: int = 1, offseta: int = 0, incb: int = 1,
          offsetb: int = 0, fpe: int = 3, early_exit: bool = False,
          impl: str | None = None, device=None) -> float:
    """Correctly rounded, reproducible dot product -> Python float."""
    return bits_to_float(exdot_bits(a, b, inca=inca, offseta=offseta,
                                    incb=incb, offsetb=offsetb, fpe=fpe,
                                    early_exit=early_exit, impl=impl,
                                    device=device))
