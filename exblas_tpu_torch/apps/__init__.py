"""Strong-reproducibility application studies (PyTorch).

Port of ``exblas_tpu/apps`` (the reference's
src/{cpu,gpu}/examples/*/StrongReproducibility): each app has a
*non-reproducible* floating-point path and a *reproducible* path whose
accumulations go through the exact superaccumulator routines, and an
experiment harness that re-runs the app with shuffled data / randomized
partitions and checks bitwise equality across repeats (the control path is
expected to fail this, demonstrating the experiment's sensitivity --
reference RNGExample.cpp:269-334).  Every entry point takes ``device=``:
with none it runs on the current CUDA device, and raises without one.
"""

from .rng_sum import rng_sum_experiment
from .kmeans import kmeans_experiment
from .spmv import spmv_experiment
from .gridding import gridding_experiment

__all__ = [
    "rng_sum_experiment",
    "kmeans_experiment",
    "spmv_experiment",
    "gridding_experiment",
]
