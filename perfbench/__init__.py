"""The benchmark of ``exblas_tpu_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (see
:mod:`perfbench.harness`).  Nothing here imports JAX or the JAX package,
and the reference (``perfbench/reference/``) imports nothing of the
program.
"""
