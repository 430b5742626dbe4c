#!/usr/bin/env python3
"""Count the SASS instructions in the inner loop of the exact GEMM kernel.

Run from the root of a checkout, on a machine with the CUDA toolkit (no
card needed):

    python3 scripts/b5_sass.py

It builds the kernel objects (``exblas_tpu_torch/ops/kernels/_build.py``),
disassembles ``gemm_kernel.o`` with ``cuobjdump -sass`` and takes the
smallest backward-branch loop of ``gemm_exact_kernel`` that holds at least
four 64-bit multiplies: one pass of it takes four products.  The loop holds
the in-window path, the out-of-window atomics and the window's placement
together, so the count is more than one product executes.  It prints the
instructions per product and the 64-bit shared atomics in the loop, and
writes the loop's listing beside the object.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from exblas_tpu_torch.ops.kernels import _build  # noqa: E402


def main() -> None:
    _build.build()
    obj = _build.object_path(_build.CSRC / "gemm_kernel.cu")
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(obj)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    body = sass[sass.index("gemm_exact_kernel"):]
    insts = [(int(addr, 16), text.strip()) for addr, text in
             re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    best = None
    for addr, text in insts:
        hit = re.search(r"BRA\s+(?:\S+\s+)?0x([0-9a-f]+)", text)
        if not hit or int(hit.group(1), 16) > addr:
            continue
        loop = [t for a, t in insts if int(hit.group(1), 16) <= a <= addr]
        muls = sum("IMAD.WIDE.U32" in t for t in loop)
        if muls >= 4 and (best is None or len(loop) < len(best)):
            best = loop
    if best is None:
        raise SystemExit("no inner loop found in gemm_exact_kernel")
    listing = obj.with_name("gemm_exact_inner_loop.sass")
    listing.write_text("\n".join(best) + "\n")
    print(f"gemm_exact_kernel inner loop: {len(best)} instructions, "
          f"{len(best) / 4:.2f} per product, "
          f"{sum('ATOMS' in t for t in best)} 64-bit shared atomics "
          f"(listing: {listing})")


if __name__ == "__main__":
    main()
