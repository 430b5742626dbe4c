"""ExSUM: exact (bit-reproducible, correctly rounded) summation (PyTorch).

Counterpart of ``exblas_tpu/ops/exsum.py``.  The API mirrors the reference's
``exsum(Ng, a, inca, offset, fpe, early_exit, parallel)``.  ``fpe`` is
validated and ``early_exit`` accepted for fidelity; neither changes the
launch or the bits: the CUDA kernels run one geometry for every call.

Devices: tensors stay where they are.  Numpy arrays and Python sequences
go to the current CUDA device, or to ``device`` when the caller names one
(``device="cpu"`` asks for the CPU); with no CUDA device and no
``device``, they raise.

Implementations ("impl"):
  * ``"torch"`` -- the plain PyTorch integer path (any device);
  * ``"cuda"``  -- the CUDA kernels (``ops/kernels/sum_kernel.py``);
  * ``None``    -- follows the device: CUDA tensors take the kernels, CPU
                   tensors the plain path.
``"cuda"`` on a CPU tensor raises; ``"torch"`` on a CUDA tensor runs the
plain path on the card, as asked.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.rounding import bits_to_float
from ..core.types import Superacc
from .kernels import sum_kernel

__all__ = ["exsum", "exsum_acc", "exsum_bits"]


def _validate_fpe(fpe: int, name: str = "exsum"):
    # Reference dispatch accepts 0..8 (src/cpu/blas/blas1/ExSUM.cpp:24-117).
    if not (0 <= int(fpe) <= 8):
        raise ValueError(
            f"{name}: fpe must be in [0, 8], got {fpe} "
            "(0/1: superacc-only; 2-8: FPE size in the reference)"
        )


def resolve_impl(impl: str | None, device: torch.device) -> str:
    """The implementation a call on ``device`` takes (see module doc)."""
    if impl is None:
        if device.type == "cuda":
            return "cuda"
        if device.type == "cpu":
            return "torch"
        raise ValueError(f"no exact path for device {device}")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got {device}")
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl


def target_device(*xs, device=None) -> torch.device:
    """The device a call on operands ``xs`` runs on (see module doc):
    ``device`` if given, else that of the tensor operands (which must
    agree), else the current CUDA device."""
    if device is not None:
        return torch.device(device)
    devs = {x.device for x in xs if isinstance(x, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(
            f"operands on several devices: {sorted(map(str, devs))}")
    if devs:
        return devs.pop()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for numpy or sequence input: pass CPU tensors "
            "or device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def as_f64(x, device: torch.device) -> torch.Tensor:
    """``x`` as a float64 tensor on ``device``, keeping its shape."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    return x.to(device=device, dtype=torch.float64)


def as_f64_vector(x, inc: int, offset: int,
                  device: torch.device) -> torch.Tensor:
    """``x[offset::inc]`` as a contiguous 1-D float64 tensor on
    ``device``."""
    x = as_f64(x, device).reshape(-1)
    if offset or inc != 1:
        x = x[offset::inc]
    return x.contiguous()


def exsum_acc(x, inca: int = 1, offset: int = 0, fpe: int = 2,
              early_exit: bool = False, impl: str | None = None,
              device=None) -> Superacc:
    """Exact sum into a Superacc (mergeable, serializable)."""
    _validate_fpe(fpe)
    x = as_f64_vector(x, inca, offset, target_device(x, device=device))
    if resolve_impl(impl, x.device) == "cuda":
        return sum_kernel.exsum_acc_cuda(x)
    return sum_kernel.exsum_acc_torch(x)


def exsum_bits(x, inca: int = 1, offset: int = 0, fpe: int = 2,
               early_exit: bool = False, impl: str | None = None,
               device=None) -> torch.Tensor:
    """Exact sum as binary64 bits: a 0-dim int64 tensor on the call's
    device."""
    _validate_fpe(fpe)
    x = as_f64_vector(x, inca, offset, target_device(x, device=device))
    if resolve_impl(impl, x.device) == "cuda":
        return sum_kernel.exsum_bits_cuda(x)
    return sum_kernel.exsum_bits_torch(x)


def exsum(x, inca: int = 1, offset: int = 0, fpe: int = 2,
          early_exit: bool = False, impl: str | None = None,
          parallel: bool = True, device=None) -> float:
    """Correctly rounded, reproducible sum(x[offset::inca]) -> Python float.

    ``parallel=False`` mirrors the reference's TBB knob: the sum runs
    single-threaded on the host through the native C++ backend, so the data
    is copied to host memory.  Results are bit-identical either way.
    """
    if not parallel:
        from ..cpu_backend import exsum_cpu

        _validate_fpe(fpe)
        x = as_f64_vector(x, inca, offset, torch.device("cpu"))
        return exsum_cpu(x.numpy(), num_threads=1)
    return bits_to_float(exsum_bits(x, inca=inca, offset=offset, fpe=fpe,
                                    early_exit=early_exit, impl=impl,
                                    device=device))
