"""ExTRSV kernel B10 (CUDA, ``csrc/trsv_kernel.cu``) and its plain PyTorch
version.

Counterpart of ``exblas_tpu/ops/kernels/trsv_kernel.py``
(``trsv_lower_x_pallas``): the exact left-looking solve of a lower
triangular T x = b, bit for bit the JAX package's spec solve (see
``ops/extrsv.py``).  Any data and any n: the last row block is masked, not
padded, so T is read in place.

:func:`trsv_lower_x_cuda` takes contiguous CUDA int64 bit tensors only --
T (n, n) row-major and b (n,) -- never falls back, and counts its launches
in ``launches``.  ``block``, the height of the diagonal blocks (1..256),
is internal: the bits never depend on it.  :func:`trsv_lower_x_torch` is
the plain version, ``solve_panel`` after ``_deposit_b``.
"""

from __future__ import annotations

import torch

from ...core.accumulator import MAX_TERMS, check_n_terms
from ...core.types import L_DOT, N_SPECIAL
from ..extrsv import _deposit_b, solve_panel
from . import _build
from ._build import ptr, stream_of
from .gemm_kernel import check_cuda_bits

__all__ = ["trsv_lower_x_cuda", "trsv_lower_x_torch", "B", "MAX_BLOCK"]

B = 128          # default diagonal-block height
MAX_BLOCK = 256  # 216 int32 limbs a row in shared memory
PARTS = {"panel": 1, "diag": 2, "all": 3}  # the C entry's ``parts``


def trsv_lower_x_cuda(t_bits, b_bits, unit: bool, block: int = B):
    """Exact solve of the lower triangle of CUDA bit tensors T (n, n) and
    b (n,) -> x's int64 bits (n,) on the device."""
    n = b_bits.shape[0]
    check_cuda_bits(t_bits, "trsv_lower_x_cuda", (n, n))
    check_cuda_bits(b_bits, "trsv_lower_x_cuda", (n,))
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"trsv_lower_x_cuda: block must be in [1, "
                         f"{MAX_BLOCK}], got {block}")
    check_n_terms(n + 1, MAX_TERMS)
    dev = t_bits.device
    x = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return x
    rows = min(block, n)
    acc = torch.zeros((rows, L_DOT), dtype=torch.int64, device=dev)
    special = torch.zeros((rows, N_SPECIAL), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().trsv_lower_x_cuda(
            ptr(t_bits), ptr(b_bits), n, int(unit), block, PARTS["all"],
            ptr(acc), ptr(special), ptr(x), stream_of(dev))
    _build.check(err, "trsv_lower_x_cuda")
    trsv_lower_x_cuda.launches += 1
    return x


trsv_lower_x_cuda.launches = 0


def trsv_lower_x_torch(t_bits, b_bits, unit: bool, block: int = B):
    """Plain version of :func:`trsv_lower_x_cuda` on any device."""
    acc, special = _deposit_b(b_bits)
    return solve_panel(t_bits, acc, special, unit, block)
