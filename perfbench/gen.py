"""The traffic generator: a cell's inputs, made on the device from the seed.

One general generator reads a traffic mix's parameters
(``traffic/<name>.json``: ``range`` and ``emax``).  The distribution is
upstream ExBLAS's ``fpuniform`` (``rand_double``, ``init_fpuniform``,
``init_fpuniform_matrix``, ``src/common/common.cpp:18-46``), whose
formulas the program's ``exblas_tpu_torch/utils/generators.py`` copies as
numpy draws on the host; here they are torch draws on the device, in a
few large calls: positive values, a mantissa uniform on the binary64 grid
of [1, 2) and an exponent uniform in [emax - range, emax) for a vector, or
in [0, range) for a matrix, as upstream's matrix generator draws it.

The same seed gives the same draws on the same device.
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    """A torch generator on ``device`` seeded from any whole ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def draw(shape, traffic: dict, g: torch.Generator, device,
         matrix: bool = False) -> torch.Tensor:
    """A float64 tensor of ``shape`` from the mix ``traffic`` (see module
    doc); ``matrix`` selects upstream's matrix form."""
    shape = tuple(shape)
    rng = int(traffic["range"])
    emin, emax = (0, rng) if matrix else (int(traffic["emax"]) - rng,
                                          int(traffic["emax"]))
    bits = torch.randint(emin, max(emax, emin + 1), shape, generator=g,
                         device=device, dtype=torch.int64)
    bits.add_(1023).bitwise_left_shift_(52)
    bits.bitwise_or_(torch.randint(0, 1 << 52, shape, generator=g,
                                   device=device, dtype=torch.int64))
    return bits.view(torch.float64)
