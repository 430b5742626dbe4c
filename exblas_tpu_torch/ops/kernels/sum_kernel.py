"""ExSUM kernel wrappers (CUDA, ``csrc/sum_kernel.cu``) and their plain
PyTorch versions.

Counterparts of ``exblas_tpu/ops/kernels/sum_kernel.py``:

* :func:`exsum_acc_cuda` <- ``exsum_pallas``: exact sum into a Superacc
  (canonical int32 limbs and the three special counts);
* :func:`exsum_bits_cuda` <- ``exsum_bits_pallas``: the same deposit, then
  the correctly rounded double computed on the device (``csrc/round.cuh``).

Both are one launch on the current stream after the workspace's zeroing
(the last block to finish exports or rounds the sum).  They take CUDA
float64 tensors only and never fall back: any other input raises.
``exsum_acc_torch`` and ``exsum_bits_torch`` are the plain versions the
CPU path and the comparisons on the card use.  Each wrapper counts its
launches in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from ...core.accumulator import accumulate_sum_terms, check_n_terms
from ...core.rounding import round_superacc_to_f64_bits
from ...core.types import L_SUM, N_SPECIAL, SUM_FORMAT, Superacc
from ...utils import profiling
from . import _build
from ._build import check_cuda_f64, ptr, stream_of

# The kernel's workspace: the limbs, the special counts and the ticket that
# tells the last block to finish (csrc/sum_kernel.cu).
_WS = L_SUM + N_SPECIAL + 1


@profiling.spanned("exblas.launch.exsum_acc_cuda")
def exsum_acc_cuda(x: torch.Tensor) -> Superacc:
    """Exact sum of a CUDA float64 tensor -> Superacc (canonical limbs)."""
    check_cuda_f64(x, "exsum_acc_cuda")
    x = x.view(-1)
    n = x.numel()
    check_n_terms(n)
    lib = _build.library()
    ws = torch.zeros(_WS, dtype=torch.int64, device=x.device)
    limbs = torch.empty(L_SUM, dtype=torch.int32, device=x.device)
    special = torch.empty(N_SPECIAL, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.exsum_acc_cuda(ptr(x), n, ptr(ws), ptr(limbs), ptr(special),
                                 stream_of(x.device))
    _build.check(err, "exsum_acc_cuda")
    exsum_acc_cuda.launches += 1
    return Superacc(limbs=limbs, special=special, fmt=SUM_FORMAT)


@profiling.spanned("exblas.launch.exsum_bits_cuda")
def exsum_bits_cuda(x: torch.Tensor) -> torch.Tensor:
    """Exact, correctly rounded sum of a CUDA float64 tensor -> binary64
    bits as a 0-dim int64 tensor on the device."""
    check_cuda_f64(x, "exsum_bits_cuda")
    x = x.view(-1)
    n = x.numel()
    check_n_terms(n)
    lib = _build.library()
    ws = torch.zeros(_WS, dtype=torch.int64, device=x.device)
    bits = torch.empty((), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.exsum_bits_cuda(ptr(x), n, ptr(ws), ptr(bits),
                                  stream_of(x.device))
    _build.check(err, "exsum_bits_cuda")
    exsum_bits_cuda.launches += 1
    return bits


exsum_acc_cuda.launches = 0
exsum_bits_cuda.launches = 0


def exsum_acc_torch(x: torch.Tensor) -> Superacc:
    """Plain version of :func:`exsum_acc_cuda` on any device."""
    return accumulate_sum_terms(x.reshape(-1), SUM_FORMAT)


def exsum_bits_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`exsum_bits_cuda` on any device."""
    return round_superacc_to_f64_bits(exsum_acc_torch(x))
