"""The least time of a routine's work on a card: the larger of its bytes
over the memory bandwidth and its float64 operations over the float64
peak, both from ``peaks.json``."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peak_of(kind: str) -> dict | None:
    """The peaks of the card named ``kind``, or None if the table has
    none."""
    return json.loads(PEAKS.read_text())["cards"].get(kind)


def least_seconds(work: dict, peak: dict) -> float:
    return max(work["bytes"] / peak["bytes_per_s"],
               work["flops"] / peak["f64_flops_per_s"])
