"""exblas_tpu_torch: bit-reproducible, correctly rounded BLAS in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``exblas_tpu`` (JAX on a TPU), held bit for bit against it.
``exsum``, ``exdot``, ``exgemv`` and ``exgemm`` return the correctly
rounded float64 of the exact result (per element for ``exgemv`` and
``exgemm``), and ``extrsv`` rounds each exactly accumulated row once
before its correctly rounded divide, so their bits cannot depend on
element order, launch geometry or partitioning.  CPU tensors
take the plain PyTorch integer path; CUDA tensors take the kernels in
``ops/kernels``, built with ``nvcc`` at first use.  Numpy input goes to
the current CUDA device unless the call names ``device``.

Importing the package configures nothing global and imports no JAX.
"""

from . import core
from .ops import (exdot, exdot_acc, exdot_bits, exgemm, exgemm_bits, exgemv,
                  exgemv_bits, exsum, exsum_acc, exsum_bits,
                  exsum_segmented, exsum_segmented_bits, extrsv,
                  extrsv_bits)
from .utils.generators import (
    init_fpuniform,
    init_fpuniform_matrix,
    init_fpuniform_tr_matrix,
    init_ill_cond,
    init_lognormal,
    init_lognormal_matrix,
    init_lognormal_tr_matrix,
    init_naive,
)

__version__ = "0.1.0"

__all__ = [
    "core",
    "exsum",
    "exsum_acc",
    "exsum_bits",
    "exsum_segmented",
    "exsum_segmented_bits",
    "exdot",
    "exdot_acc",
    "exdot_bits",
    "exgemv",
    "exgemv_bits",
    "extrsv",
    "extrsv_bits",
    "exgemm",
    "exgemm_bits",
    "init_fpuniform",
    "init_fpuniform_matrix",
    "init_fpuniform_tr_matrix",
    "init_ill_cond",
    "init_lognormal",
    "init_lognormal_matrix",
    "init_lognormal_tr_matrix",
    "init_naive",
]
