"""ExSUM: ``exblas_tpu_torch.exsum_bits(x)`` on one contiguous float64
vector of ``n`` elements.  The call is complete when its bits are on the
host (``.item()``), as ``exsum`` returns a Python float."""

from __future__ import annotations

import torch

from .. import gen
from . import load_program as load  # noqa: F401

ENTRY = "exsum_bits"
KEEP = None  # every answer is an int: keep them all


def inputs(config: dict, traffic: dict, g, device) -> dict:
    return {"x": gen.draw((int(config["n"]),), traffic, g, device)}


def call(inp: dict):
    import exblas_tpu_torch

    return exblas_tpu_torch.exsum_bits(inp["x"])


def complete(out) -> int:
    return int(out.item())


def work(config: dict) -> dict:
    """Each element read once and the result written once; no float64
    operations count toward the roofline."""
    return {"bytes": 8 * int(config["n"]) + 8, "flops": 0}


def describe(inp: dict | None = None) -> str:
    """The ladder's tiers on the last call, and the kernels' launch
    counters."""
    import importlib

    from exblas_tpu_torch.ops.kernels import sum_kernel, sum_mxu

    exsum = importlib.import_module("exblas_tpu_torch.ops.exsum")

    route = getattr(exsum._exsum_bits_mxu_auto, "route", ())
    counts = {f.__name__: getattr(f, "launches", None)
              for f in (sum_mxu.sum_flat_cuda, sum_kernel.exsum_bits_cuda)}
    return f"route {'+'.join(route) or 'exact kernel'} launches {counts}"


def fault(kind: str, inp: dict):
    """The program's call with a planted fault, for the tests and checks
    that show a wrong answer is caught: ``altered`` flips the last bit of
    the answer, ``half`` sums the first half and doubles it."""
    if kind == "altered":
        return call(inp) ^ 1
    if kind == "half":
        x = inp["x"]
        half = call({"x": x[: x.numel() // 2]})
        return torch.where(half == 0, half, half + (1 << 52))
    raise ValueError(f"exsum has no fault {kind!r}")


FAULTS = ("altered", "half")
