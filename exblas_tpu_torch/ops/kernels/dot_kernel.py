"""ExDOT kernel wrappers (CUDA, ``csrc/dot_kernel.cu``) and their plain
PyTorch versions.

Counterparts of ``exblas_tpu/ops/kernels/dot_kernel.py``:

* :func:`exdot_acc_cuda` <- ``exdot_pallas``: exact dot product into a
  DOT_FORMAT Superacc (canonical int32 limbs and special counts);
* :func:`exdot_bits_cuda` <- ``exdot_bits_pallas``: the same deposit, then
  the correctly rounded double computed on the device.

CUDA float64 tensors only, no fallback; ``exdot_acc_torch`` and
``exdot_bits_torch`` are the plain versions.  Each wrapper counts its
launches in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from ...core.accumulator import accumulate_dot_terms, check_n_terms
from ...core.rounding import round_superacc_to_f64_bits
from ...core.types import DOT_FORMAT, L_DOT, N_SPECIAL, Superacc
from ...utils import profiling
from . import _build
from ._build import check_cuda_f64, ptr, stream_of

# The kernel's workspace: the limbs and counts its blocks add up, then the
# ticket that finds the last block (csrc/dot_kernel.cu), zeroed a call.
WS_WORDS = L_DOT + N_SPECIAL + 1


def _check_pair(a: torch.Tensor, b: torch.Tensor, name: str) -> int:
    check_cuda_f64(a, name)
    check_cuda_f64(b, name)
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"{name}: operands differ: {tuple(a.shape)} on "
                         f"{a.device} vs {tuple(b.shape)} on {b.device}")
    check_n_terms(a.numel())
    return a.numel()


@profiling.spanned("exblas.launch.exdot_acc_cuda")
def exdot_acc_cuda(a: torch.Tensor, b: torch.Tensor) -> Superacc:
    """Exact dot product of two CUDA float64 tensors -> Superacc."""
    n = _check_pair(a, b, "exdot_acc_cuda")
    lib = _build.library()
    dev = a.device
    ws = torch.zeros(WS_WORDS, dtype=torch.int64, device=dev)
    limbs = torch.empty(L_DOT, dtype=torch.int32, device=dev)
    special = torch.empty(N_SPECIAL, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.exdot_acc_cuda(ptr(a), ptr(b), n, ptr(ws), ptr(limbs),
                                 ptr(special), stream_of(dev))
    _build.check(err, "exdot_acc_cuda")
    exdot_acc_cuda.launches += 1
    return Superacc(limbs=limbs, special=special, fmt=DOT_FORMAT)


@profiling.spanned("exblas.launch.exdot_bits_cuda")
def exdot_bits_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact, correctly rounded dot product of two CUDA float64 tensors ->
    binary64 bits as a 0-dim int64 tensor on the device."""
    n = _check_pair(a, b, "exdot_bits_cuda")
    lib = _build.library()
    dev = a.device
    ws = torch.zeros(WS_WORDS, dtype=torch.int64, device=dev)
    bits = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.exdot_bits_cuda(ptr(a), ptr(b), n, ptr(ws), ptr(bits),
                                  stream_of(dev))
    _build.check(err, "exdot_bits_cuda")
    exdot_bits_cuda.launches += 1
    return bits


exdot_acc_cuda.launches = 0
exdot_bits_cuda.launches = 0


def exdot_acc_torch(a: torch.Tensor, b: torch.Tensor) -> Superacc:
    """Plain version of :func:`exdot_acc_cuda` on any device."""
    return accumulate_dot_terms(a.reshape(-1), b.reshape(-1), DOT_FORMAT)


def exdot_bits_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`exdot_bits_cuda` on any device."""
    return round_superacc_to_f64_bits(exdot_acc_torch(a, b))
