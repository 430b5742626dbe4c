"""Reproducible BLAS over a world of processes (``torch.distributed``).

Port of ``exblas_tpu/parallel``: the same eleven entry points, on a
``DeviceMesh`` over the initialized default process group (NCCL between
cards, Gloo on the CPU) in place of a JAX device mesh.  Every rank passes
the same global operands and gets the same bits back, for every world size
and mesh shape.
"""

from .distributed import (
    exdot_sharded,
    exsum_sharded,
    make_mesh,
    psum_superacc,
)
from .blas2 import (exgemm_sharded, exgemm_sharded_2d, exgemm_sharded_k,
                    exgemv_sharded, exgemv_sharded_2d, make_mesh_2d)
from .trsv import extrsv_sharded

__all__ = [
    "exdot_sharded",
    "extrsv_sharded",
    "exgemm_sharded",
    "exgemm_sharded_2d",
    "exgemm_sharded_k",
    "exgemv_sharded",
    "exgemv_sharded_2d",
    "exsum_sharded",
    "make_mesh",
    "make_mesh_2d",
    "psum_superacc",
]
