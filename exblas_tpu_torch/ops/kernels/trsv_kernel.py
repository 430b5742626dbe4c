"""ExTRSV kernel B10 (CUDA, ``csrc/trsv_kernel.cu``) and its plain PyTorch
version.

Counterpart of ``exblas_tpu/ops/kernels/trsv_kernel.py``
(``trsv_lower_x_pallas``): the exact left-looking solve of a lower
triangular T x = b, bit for bit the JAX package's spec solve (see
``ops/extrsv.py``).  Any data and any n: the last row block is masked, not
padded, so T is read in place.

:func:`trsv_lower_x_cuda` takes contiguous CUDA int64 bit tensors only --
T (n, n) row-major and b (n,) -- never falls back, and counts its launches
in ``launches``: one persistent launch a solve.  ``block``, the height of
the row blocks (a multiple of 32 in 32..128), is internal: the bits never
depend on it.
:func:`trsv_step_split` runs the same launch with the solver warp's
``clock64()`` stamps on and returns its cycles a step by phase.
:func:`trsv_lower_x_torch` is the plain version, ``solve_panel`` after
``_deposit_b``.
"""

from __future__ import annotations

import torch

from ...core.accumulator import MAX_TERMS, check_n_terms
from ...core.types import L_DOT, N_SPECIAL
from ...utils import profiling
from ..extrsv import _deposit_b, solve_panel
from . import _build
from ._build import ptr, stream_of
from .gemm_kernel import check_cuda_bits

__all__ = ["trsv_lower_x_cuda", "trsv_lower_x_torch", "trsv_step_split",
           "B", "MAX_BLOCK", "PHASES"]

B = 128          # default row-block height
MAX_BLOCK = 128  # a window of 2 * 128 rows of 68 words in shared memory
WORDS = 68       # the kernel's 64-bit words a row
PARTS = {"all": 1, "stamps": 3}  # the C entry's ``parts``
# the solver warp's phases of a step, as the C entry sums their cycles
PHASES = ("wait", "deposit", "rounding", "divide", "publish")
_FLAGS = 1 + 8  # the next panel tile, then 8 stamp slots (5 used)


@profiling.spanned("exblas.launch.trsv_lower_x_cuda")
def _launch(t_bits, b_bits, unit: bool, block: int, parts: str):
    """x's bits and the stamp slots of one launch (see module doc)."""
    n = b_bits.shape[0]
    check_cuda_bits(t_bits, "trsv_lower_x_cuda", (n, n))
    check_cuda_bits(b_bits, "trsv_lower_x_cuda", (n,))
    if not (32 <= block <= MAX_BLOCK and block % 32 == 0):
        raise ValueError(f"trsv_lower_x_cuda: block must be a multiple of "
                         f"32 in [32, {MAX_BLOCK}], got {block}")
    check_n_terms(n + 1, MAX_TERMS)
    dev = t_bits.device
    x = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return x, x
    # the rows' accumulators, the launch's flags and stamp slots, then each
    # row block's rows as words
    nb = -(-n // block)
    flags = nb * (1 + 2 * (block // 32))
    acc = torch.zeros(n * L_DOT + flags + _FLAGS + nb * WORDS * block,
                      dtype=torch.int64, device=dev)
    special = torch.zeros((n, N_SPECIAL), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().trsv_lower_x_cuda(
            ptr(t_bits), ptr(b_bits), n, int(unit), block, PARTS[parts],
            ptr(acc), ptr(special), ptr(x), stream_of(dev))
    _build.check(err, "trsv_lower_x_cuda")
    trsv_lower_x_cuda.launches += 1
    start = n * L_DOT + flags + 1
    return x, acc[start:start + len(PHASES)]


def trsv_lower_x_cuda(t_bits, b_bits, unit: bool, block: int = B):
    """Exact solve of the lower triangle of CUDA bit tensors T (n, n) and
    b (n,) -> x's int64 bits (n,) on the device."""
    return _launch(t_bits, b_bits, unit, block, "all")[0]


trsv_lower_x_cuda.launches = 0


def trsv_step_split(t_bits, b_bits, unit: bool, block: int = B) -> dict:
    """The solver warp's cycles a step, by phase (``PHASES``), from one
    launch with its stamps on: a timing entry, not the solve's path."""
    n = b_bits.shape[0]
    _, stamps = _launch(t_bits, b_bits, unit, block, "stamps")
    return {k: v / max(n, 1) for k, v in zip(PHASES, stamps.tolist())}


def trsv_lower_x_torch(t_bits, b_bits, unit: bool, block: int = B):
    """Plain version of :func:`trsv_lower_x_cuda` on any device."""
    acc, special = _deposit_b(b_bits)
    return solve_panel(t_bits, acc, special, unit, block)
