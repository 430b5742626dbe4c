#!/usr/bin/env python3
"""Read what nvcc made of the exact GEMM kernel B5 and the TRSV kernel B10.

Run from the root of a checkout, on a machine with the CUDA toolkit (no
card needed):

    python3 scripts/b5_sass.py

It builds the kernel objects (``exblas_tpu_torch/ops/kernels/_build.py``),
disassembles ``gemm_kernel.o`` with ``cuobjdump -sass`` and takes the
smallest backward-branch loop of ``gemm_words_kernel`` that holds a 64-bit
multiply and a shared-memory store: the deposit loop, one product a pass
(``#pragma unroll 1``).  Its span also holds the carry and borrow loops
that run past the third word, which a product rarely takes, so the counts
are an upper bound on what a product executes.  It prints the loop's
SASS instructions, its shared-memory loads and stores, and its 64-bit
shared atomics (``ATOMS``, which sm_90a compiles to compare-and-swap
loops) -- there must be none -- and writes the listing beside the object.
Then it compiles ``gemm_kernel.cu`` and ``trsv_kernel.cu`` once more with
``-Xptxas -v`` and prints each kernel's registers, shared memory and
spills.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from exblas_tpu_torch.ops.kernels import _build  # noqa: E402

KERNEL = "gemm_words_kernel"
PER_PASS = 1  # products a pass of the deposit loop


def deposit_loop(sass: str) -> list[str]:
    body = sass[sass.index(KERNEL):]
    end = body.find(".text.", 1)
    body = body if end < 0 else body[:end]
    insts = [(int(addr, 16), text.strip()) for addr, text in
             re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    best = None
    for addr, text in insts:
        hit = re.search(r"BRA\s+(?:\S+\s+)?0x([0-9a-f]+)", text)
        if not hit:
            continue
        target = int(hit.group(1), 16)
        if target > addr:
            continue
        loop = [t for a, t in insts if target <= a <= addr]
        if (any("IMAD.WIDE.U32" in t for t in loop)
                and any(t.startswith("STS") or " STS" in t for t in loop)
                and (best is None or len(loop) < len(best))):
            best = loop
    if best is None:
        raise SystemExit(f"no deposit loop found in {KERNEL}")
    return best


def ptxas_report(src: Path) -> str:
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             "-o", str(Path(tmp) / "x.o"), str(src)],
            capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(proc.stderr)
    keep = [ln for ln in proc.stderr.splitlines()
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    return "\n".join(keep)


def main() -> None:
    _build.build()
    obj = _build.object_path(_build.CSRC / "gemm_kernel.cu")
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(obj)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    loop = deposit_loop(sass)
    listing = obj.with_name("gemm_words_deposit_loop.sass")
    listing.write_text("\n".join(loop) + "\n")
    lds = sum(bool(re.match(r"(@\S+\s+)?LDS", t)) for t in loop)
    sts = sum(bool(re.match(r"(@\S+\s+)?STS", t)) for t in loop)
    atoms = sum("ATOMS" in t for t in loop)
    spin = sum("ATOMS.CAST.SPIN" in t for t in loop)
    print(f"{KERNEL} deposit loop ({PER_PASS} product a pass): "
          f"{len(loop) / PER_PASS:.2f} SASS instructions a product (all "
          f"paths included); {lds / PER_PASS:.1f} shared loads and "
          f"{sts / PER_PASS:.1f} shared stores a product; {atoms} shared "
          f"atomics ({spin} ATOMS.CAST.SPIN) (listing: {listing})")
    for name in ("gemm_kernel.cu", "trsv_kernel.cu"):
        print(f"ptxas -v {name}:")
        print(ptxas_report(_build.CSRC / name))
    if atoms:
        raise SystemExit("the deposit loop holds shared atomics")


if __name__ == "__main__":
    main()
