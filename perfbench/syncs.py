"""Host synchronizations of one call, as PyTorch's sync debug mode reports
them.  A copy of ``count_syncs`` in the repository's ``chip_smoke.py``,
kept here so that the yardstick cannot move with the program."""

from __future__ import annotations

import warnings

import torch


def count_syncs(fn):
    """(the number of synchronizing operations ``fn()`` ran, its result)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught), out
