"""ExGEMM exact kernel wrapper (CUDA, ``csrc/gemm_kernel.cu``) and its
plain PyTorch version.

Counterparts of ``exblas_tpu/ops/kernels/gemm_kernel.py``
(``gemm_bits_pallas``) and of the plain accumulators of
``exblas_tpu/ops/exgemm.py`` (``gemm_acc_xla``, ``apply_beta_gemm``, whose
job the row helper ``_apply_beta_rows`` of ``ops/exgemv.py`` does here):

* :func:`gemm_bits_cuda` -- for each (i, j) the exact sum of the 106-bit
  products ``z[i,k] * b[k,j]`` plus the exact ``beta * c[i,j]``, every
  element rounded once on the device, NaN/Inf counted as in
  ``core/deposit.py``.  Any data, k = 0 included (no products: the
  epilogue rounds beta * c alone).  It is the fallback of the slice kernel
  (``gemm_mxu.py``) and the only route beyond its coverage.
* :func:`gemm_bits_torch` -- the plain version: the O(m k n) deposit of
  ``gemm_acc``, the beta term of ``_apply_beta_rows``, then
  ``round_rows`` (the row helpers of ``ops/exgemv.py``).

Operands are int64 binary64 bit patterns (``z = fl(alpha * A)`` already
applied).  ``beta_mode`` is ``"zero"`` (no C term; ``c`` unused), ``"one"``
(C deposited exactly) or ``"general"`` (the exact product ``beta * c``).
The CUDA wrapper takes contiguous CUDA int64 tensors only and never falls
back; it counts its launches in ``gemm_bits_cuda.launches``.
"""

from __future__ import annotations

import torch

from ...core.accumulator import MAX_TERMS, check_n_terms
from ...utils import profiling
from ..exgemv import _apply_beta_rows, gemm_acc, round_rows
from . import _build
from ._build import ptr, stream_of

__all__ = ["gemm_bits_cuda", "gemm_bits_torch", "BETA_MODES"]

# beta_mode -> the kernels' integer code
BETA_MODES = {"zero": 0, "one": 1, "general": 2}
ONE_BITS = 0x3FF0000000000000  # 1.0


def check_cuda_bits(x: torch.Tensor, name: str, shape) -> None:
    """Raise unless ``x`` is a contiguous int64 CUDA tensor of ``shape``."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{getattr(x, 'device', type(x))}")
    if x.dtype != torch.int64 or not x.is_contiguous():
        raise TypeError(f"{name}: expected contiguous int64 bits, got "
                        f"{x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")


def _beta_code(beta_bits: int, beta_mode: str) -> tuple[int, int]:
    """(mode code, beta bits for the kernels): beta = 1 deposits c as the
    exact product 1.0 * c."""
    mode = BETA_MODES[beta_mode]
    return mode, ONE_BITS if beta_mode == "one" else beta_bits


@profiling.spanned("exblas.launch.gemm_bits_cuda")
def gemm_bits_cuda(z_bits, b_bits, c_bits, beta_bits: int,
                   beta_mode: str) -> torch.Tensor:
    """Exact ExGEMM of CUDA bit tensors z (m, k), b (k, n), c (m, n) ->
    (m, n) int64 bits of the correctly rounded results."""
    m, k = z_bits.shape
    n = b_bits.shape[1]
    check_cuda_bits(z_bits, "gemm_bits_cuda", (m, k))
    check_cuda_bits(b_bits, "gemm_bits_cuda", (k, n))
    mode, beta = _beta_code(beta_bits, beta_mode)
    if mode:
        check_cuda_bits(c_bits, "gemm_bits_cuda", (m, n))
    check_n_terms(k, MAX_TERMS)
    dev = z_bits.device
    out = torch.empty((m, n), dtype=torch.int64, device=dev)
    if m * n == 0:
        return out
    bt = b_bits.t().contiguous()  # lanes read b's columns coalesced
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.gemm_bits_cuda(ptr(z_bits), ptr(bt),
                                 ptr(c_bits) if mode else None, beta, mode,
                                 m, n, k, ptr(out), stream_of(dev))
    _build.check(err, "gemm_bits_cuda")
    gemm_bits_cuda.launches += 1
    return out


gemm_bits_cuda.launches = 0


def gemm_bits_torch(z_bits, b_bits, c_bits, beta_bits: int,
                    beta_mode: str) -> torch.Tensor:
    """Plain version of :func:`gemm_bits_cuda` on any device."""
    limbs, special = gemm_acc(z_bits, b_bits)
    limbs, special = _apply_beta_rows(limbs, special, beta_bits, c_bits,
                                      beta_mode)
    return round_rows(limbs, special).reshape(z_bits.shape[0],
                                              b_bits.shape[1])
