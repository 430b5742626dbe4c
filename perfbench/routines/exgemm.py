"""ExGEMM: ``exblas_tpu_torch.exgemm_bits(transa, transb, alpha, A, B,
beta=beta, c=C)`` on float64 operands of (m, k), (k, n) and (m, n).  The
call is complete after ``torch.cuda.synchronize()``."""

from __future__ import annotations

import torch

from .. import gen
from . import load_program as load  # noqa: F401

ENTRY = "exgemm_bits"
KEEP = 4  # outputs kept for the check, drawn from the seed


def inputs(config: dict, traffic: dict, g, device) -> dict:
    m, n, k = (int(config[d]) for d in ("m", "n", "k"))
    if config.get("transa", "N") != "N" or config.get("transb", "N") != "N":
        raise ValueError("exgemm adapter: transa = transb = 'N' only")
    a = gen.draw((m, k), traffic, g, device, matrix=True)
    b = gen.draw((k, n), traffic, g, device, matrix=True)
    c = gen.draw((m, n), traffic, g, device, matrix=True)
    return {"a": a, "b": b, "c": c, "alpha": float(config["alpha"]),
            "beta": float(config["beta"])}


def call(inp: dict):
    import exblas_tpu_torch

    return exblas_tpu_torch.exgemm_bits("N", "N", inp["alpha"], inp["a"],
                                        inp["b"], beta=inp["beta"],
                                        c=inp["c"])


def complete(out):
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out


def work(config: dict) -> dict:
    """A, B and C read once and C written once; 2mnk float64 operations
    (upstream's own count: a multiply and an add a product)."""
    m, n, k = (int(config[d]) for d in ("m", "n", "k"))
    return {"bytes": 8 * (m * k + k * n + 2 * m * n), "flops": 2 * m * n * k}


def describe(inp: dict | None = None) -> str:
    """The plan's rung on ``inp`` (None: the exact kernel B5), and the
    kernels' launch counters."""
    import importlib

    from exblas_tpu_torch.core.ieee import f64_bits
    from exblas_tpu_torch.ops.kernels import gemm_kernel, gemm_mxu

    exgemm = importlib.import_module("exblas_tpu_torch.ops.exgemm")

    text = ""
    if inp is not None:
        beta_bits = int(torch.tensor(inp["beta"], dtype=torch.float64)
                        .view(torch.int64))
        plan = exgemm.plan_gemm(f64_bits(inp["a"]), f64_bits(inp["b"]),
                                f64_bits(inp["c"]), beta_bits, "one")
        text = f"rung {plan.rung} "
    counts = {"gemm_bits_mxu_cuda": gemm_mxu.gemm_bits_mxu_cuda.launches,
              "round_launches": gemm_mxu.gemm_bits_mxu_cuda.round_launches,
              "gemm_bits_cuda": gemm_kernel.gemm_bits_cuda.launches}
    return f"{text}launches {counts}"


def fault(kind: str, inp: dict):
    """The program's call with a planted fault: ``altered`` flips the
    last bit of one element, ``unchanged`` returns C as it came in,
    ``half`` leaves out the second half of k."""
    if kind == "altered":
        out = call(inp)
        out.view(-1)[0] ^= 1
        return out
    if kind == "unchanged":
        return inp["c"].view(torch.int64).clone()
    if kind == "half":
        k = inp["a"].shape[1]
        return call(dict(inp, a=inp["a"][:, : k // 2].contiguous(),
                         b=inp["b"][: k // 2].contiguous()))
    raise ValueError(f"exgemm has no fault {kind!r}")


FAULTS = ("altered", "unchanged", "half")
