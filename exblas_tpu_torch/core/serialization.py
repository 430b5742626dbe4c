"""Checkpoint / resume of exact accumulator state (PyTorch).

Counterpart of ``exblas_tpu/core/serialization.py``, with the same npz
schema (``limbs``, ``special``, ``n_limbs``, ``offset_bits``): an
accumulator saved by either package loads in the other, and a resumed
reduction is bit-identical to an uninterrupted one.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import AccFormat, Superacc


def superacc_to_arrays(acc: Superacc) -> dict:
    """Host-side snapshot (exact)."""
    return {
        "limbs": acc.limbs.detach().cpu().numpy(),
        "special": acc.special.detach().cpu().numpy(),
        "n_limbs": np.int64(acc.fmt.n_limbs),
        "offset_bits": np.int64(acc.fmt.offset_bits),
    }


def superacc_from_arrays(d, device=None) -> Superacc:
    """Superacc from a snapshot of either package, on ``device``."""
    fmt = AccFormat(n_limbs=int(d["n_limbs"]),
                    offset_bits=int(d["offset_bits"]))
    limbs = torch.as_tensor(np.array(d["limbs"], np.int32), device=device)
    special = torch.as_tensor(np.array(d["special"], np.int32),
                              device=device)
    return Superacc(limbs=limbs, special=special, fmt=fmt)


def save_superacc(path: str, acc: Superacc) -> None:
    np.savez(path, **superacc_to_arrays(acc))


def load_superacc(path: str, device=None) -> Superacc:
    with np.load(path) as d:
        return superacc_from_arrays(d, device=device)
