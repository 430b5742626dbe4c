"""One adapter a routine, found by the ``routine`` of a configuration.

An adapter makes one input set on the device from the generator, calls
the program's public entry, completes the call as its caller would, and
counts the routine's own work.  See :mod:`perfbench.harness` for the
names it defines.
"""

import torch


def load_program(device) -> None:
    """Import the program and, on a card, load its kernels' library: built
    with ``nvcc`` into the checkout's ``build/kernels/`` on the checkout's
    first run, loaded from there on every later one."""
    import exblas_tpu_torch  # noqa: F401

    if torch.device(device).type == "cuda":
        from exblas_tpu_torch.ops.kernels import _build

        _build.library()
