"""RNGExample analog: summation of random numbers under adversarial
partitioning (reference RNGExample.cpp:373-451, 532-600: pthread partial
sums with random splits, partials combined by one more exsum).

Port of ``exblas_tpu/apps/rng_sum.py``: the same ``RandomState`` draws in
the same order, so the partitions and the returned dict are the JAX
package's.  The data lives on the call's device; each part goes through
``exsum_acc`` (the exact kernel B2 below 2^20 elements, the anchored
ladder's window kernel B11 at and above it), and the partials merge by
integer limb adds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.rounding import bits_to_float, round_superacc_to_f64_bits
from ..ops.exsum import exsum, exsum_acc, target_device


def _partitioned_float_sum(x, rng):
    """Non-reproducible control: random partitions, float partial sums,
    combined in random order (numpy, on the host)."""
    n = len(x)
    cuts = np.sort(rng.choice(n, size=rng.randint(2, 16), replace=False))
    parts = np.split(x, cuts)
    order = rng.permutation(len(parts))
    total = 0.0
    for i in order:
        total += float(np.sum(parts[i]))
    return total


def _exsum_parts(parts, impl=None) -> float:
    """Each part (a float64 tensor) reduced exactly, the partials merged
    exactly (integer limb adds) in the order given, the total rounded
    once."""
    total = None
    for part in parts:
        acc = exsum_acc(part, impl=impl)
        total = acc if total is None else total + acc
    return bits_to_float(round_superacc_to_f64_bits(total))


def _partitioned_exsum(x, rng, impl=None) -> float:
    """Reproducible path: random partitions of the float64 tensor ``x``,
    each reduced exactly, partials merged exactly in random order."""
    n = len(x)
    cuts = np.sort(rng.choice(n, size=rng.randint(2, 16), replace=False))
    parts = x.tensor_split(cuts.tolist())
    order = rng.permutation(len(parts))
    return _exsum_parts([parts[i] for i in order], impl)


def rng_sum_experiment(n: int = 100_000, repeats: int = 10, seed: int = 0,
                       impl: str | None = None, device=None) -> dict:
    """Shuffle-and-rerun protocol.  Returns bitwise-uniqueness counts.
    ``impl`` and ``device`` follow ``exsum``'s rules; with no ``device``
    the sums run on the current CUDA device."""
    dev = target_device(device=device)
    rng = np.random.RandomState(seed)
    x = (rng.uniform(-1, 1, n) * np.exp2(rng.randint(-30, 30, n)))
    xd = torch.from_numpy(x).to(dev)

    repro_bits, control_bits = set(), set()
    for _ in range(repeats):
        perm = rng.permutation(n)
        xs = x[perm]
        repro_bits.add(np.float64(_partitioned_exsum(
            xd[torch.from_numpy(perm).to(dev)], rng, impl)).tobytes())
        control_bits.add(np.float64(_partitioned_float_sum(xs, rng)).tobytes())

    single = exsum(xd, impl=impl)
    return {
        "repro_unique": len(repro_bits),          # must be 1
        "control_unique": len(control_bits),      # > 1 expected
        "repro_equals_single_pass": (
            np.float64(single).tobytes() in repro_bits
        ),
        "value": single,
    }
