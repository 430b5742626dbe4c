"""ExGEMV exact row kernel B7 (CUDA, ``csrc/gemv_kernel.cu``) and its plain
PyTorch version.

Counterpart of ``exblas_tpu/ops/kernels/gemv_kernel.py``
(``gemv_rows_acc_pallas``): for each row i of A the exact sum of the
106-bit products ``a[i,k] * z[k]`` in a DOT_FORMAT superaccumulator, with
NaN/+Inf/-Inf counted as in ``core/deposit.py``.  Any data.  The output is
the JAX layout -- int64 limbs (m, 216) and int64 counts (m, 3) -- so the
beta term and the rounding of ``ops/exgemv.py`` (``_apply_beta_rows``,
``round_rows``) take it as it is; limbs are redundant, so compare them as
canonical digits.

:func:`gemv_rows_acc_cuda` takes CUDA int64 bit tensors only -- z
contiguous, A with contiguous rows (a row-major matrix, or a block of rows
and columns of one, read in place with its row stride as ``lda``) -- never
falls back, and counts its launches in ``launches``.  ``negate_z`` deposits
the products with -z (z's sign bits flipped).  :func:`row_geometry` cuts
(m, k) for it: a warp a row, and k split over several blocks only for
small m, whose split rows alone are added into zeroed outputs.
:func:`gemv_rows_acc_torch` is the plain version (``dot_rows_acc``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...core.accumulator import MAX_TERMS, check_n_terms
from ...core.rounding import SIGN_BIT
from ...core.types import L_DOT, N_SPECIAL
from ...utils import profiling
from ..exgemv import dot_rows_acc
from . import _build
from ._build import ptr, stream_of
from .gemm_kernel import check_cuda_bits

__all__ = ["gemv_rows_acc_cuda", "gemv_rows_acc_torch", "row_geometry"]


def row_stride(a_bits: torch.Tensor, name: str) -> int:
    """The row stride (BLAS ``lda``) of a CUDA int64 matrix whose rows are
    contiguous; raises for any other layout."""
    if a_bits.is_contiguous():
        check_cuda_bits(a_bits, name, a_bits.shape)
        return a_bits.shape[1]
    if a_bits.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{a_bits.device}")
    if (a_bits.dtype != torch.int64 or a_bits.stride(1) != 1
            or a_bits.stride(0) < a_bits.shape[1]):
        raise ValueError(f"{name}: expected int64 bits with contiguous "
                         f"rows, got {a_bits.dtype} with strides "
                         f"{a_bits.stride()}")
    return a_bits.stride(0)


# csrc/gemv_kernel.cu: warps (rows) of a block at most, and the k of z
# staged at once (every span is a multiple of it).
MAX_WARPS = 8
K_CHUNK = 1024
# Rows an SM takes before k is not split: one block of MAX_WARPS warps.
FILL_ROWS = MAX_WARPS


@dataclass(frozen=True)
class RowGeometry:
    """How :func:`gemv_rows_acc_cuda` cuts (m, k): blocks of ``warps``
    warps, a row each, over ``groups`` groups of consecutive rows and
    ``splits`` spans of ``span`` k.  Block b takes group b // splits and
    span b % splits; warp w of it row (b // splits) * warps + w (none past
    m); span s covers k in [s * span, min((s + 1) * span, k))."""

    warps: int
    groups: int
    splits: int
    span: int

    @property
    def blocks(self) -> int:
        return self.groups * self.splits

    @property
    def zeroed(self) -> bool:
        """Split rows are added into zeroed outputs by integer atomics;
        whole rows are written."""
        return self.splits > 1


def row_geometry(m: int, k: int, sms: int) -> RowGeometry:
    """The row kernel's geometry for A (m, k) on a card of ``sms`` SMs:
    k is split only where m rows leave an SM fewer than FILL_ROWS, into
    as many spans of whole chunks as fill it (each span non-empty)."""
    if m < 1 or k < 1 or sms < 1:
        raise ValueError(f"row_geometry: m={m}, k={k}, sms={sms}")
    warps = min(MAX_WARPS, m)
    chunks = -(-k // K_CHUNK)
    splits = 1
    if m < sms * FILL_ROWS:
        splits = min(-(-sms * FILL_ROWS // m), chunks)
    span = -(-chunks // splits) * K_CHUNK
    return RowGeometry(warps, -(-m // warps), -(-k // span), span)


@profiling.spanned("exblas.launch.gemv_rows_acc_cuda")
def gemv_rows_acc_cuda(a_bits, z_bits, negate_z: bool = False):
    """Exact per-row accumulators of CUDA bit tensors a (m, k) and z (k,)
    -> (limbs int64 (m, 216), special int64 (m, 3)) on the device."""
    m, k = a_bits.shape
    lda = row_stride(a_bits, "gemv_rows_acc_cuda")
    check_cuda_bits(z_bits, "gemv_rows_acc_cuda", (k,))
    check_n_terms(k, MAX_TERMS)
    dev = a_bits.device
    if m * k == 0:
        return (torch.zeros((m, L_DOT), dtype=torch.int64, device=dev),
                torch.zeros((m, N_SPECIAL), dtype=torch.int64, device=dev))
    geo = row_geometry(
        m, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    alloc = torch.zeros if geo.zeroed else torch.empty
    limbs = alloc((m, L_DOT), dtype=torch.int64, device=dev)
    special = alloc((m, N_SPECIAL), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().gemv_rows_acc_cuda(
            ptr(a_bits), ptr(z_bits), m, k, lda, int(negate_z), geo.warps,
            geo.splits, geo.span, ptr(limbs), ptr(special), stream_of(dev))
    _build.check(err, "gemv_rows_acc_cuda")
    gemv_rows_acc_cuda.launches += 1
    return limbs, special


gemv_rows_acc_cuda.launches = 0


def gemv_rows_acc_torch(a_bits, z_bits, negate_z: bool = False):
    """Plain version of :func:`gemv_rows_acc_cuda` on any device."""
    return dot_rows_acc(a_bits, z_bits ^ SIGN_BIT if negate_z else z_bits)
