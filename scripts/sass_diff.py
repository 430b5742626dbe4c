#!/usr/bin/env python3
"""Which kernels' machine code differs between this checkout and another.

Run from the root of a checkout, on a machine with the CUDA toolkit (no
card is needed):

    python3 scripts/sass_diff.py DIR

It compiles every ``exblas_tpu_torch/ops/kernels/csrc/*.cu`` of this
checkout and of the checkout at ``DIR`` (for example an older commit
unpacked with ``git archive``) into cubins under ``build/sass_diff/``,
one ``nvcc`` a source, all at once, and compares their SASS
(``cuobjdump -sass``) kernel by kernel, with the kernels' names stripped
of the per-file hash that anonymous namespaces add.  It prints, for each
source, ``same`` or the kernels whose instructions differ (with their
instruction counts on both sides), and the sources that only one side
has.
"""

from __future__ import annotations

import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from exblas_tpu_torch.ops.kernels import _build  # noqa: E402

REL = Path("exblas_tpu_torch/ops/kernels/csrc")
OUT = ROOT / "build" / "sass_diff"
_HASH = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+")
_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")


def sass(tree: Path, src: Path, tag: str) -> dict:
    """{kernel: [instructions]} of one source of one tree."""
    cubin = OUT / tag / f"{src.stem}.cubin"
    cubin.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-cubin", f"-I{tree / REL}",
                    "-o", str(cubin), str(src)], check=True,
                   capture_output=True, text=True)
    listing = subprocess.run(
        [str(Path(nvcc).with_name("cuobjdump")), "-sass", str(cubin)],
        check=True, capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            fn = _HASH.sub(r"\1", line.split("Function :")[1].strip())
            out[fn] = []
        elif fn is not None and _ADDR.search(line):
            body = _ADDR.sub("", line).split("/*")[0].strip()
            if body:
                out[fn].append(body)
    return out


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit("usage: sass_diff.py DIR")
    other = Path(sys.argv[1]).resolve()
    mine = {p.name: p for p in (ROOT / REL).glob("*.cu")}
    theirs = {p.name: p for p in (other / REL).glob("*.cu")}
    both = sorted(set(mine) & set(theirs))
    with ThreadPoolExecutor(2 * len(both)) as pool:
        a = {n: pool.submit(sass, other, theirs[n], "other") for n in both}
        b = {n: pool.submit(sass, ROOT, mine[n], "this") for n in both}
        a = {n: f.result() for n, f in a.items()}
        b = {n: f.result() for n, f in b.items()}
    for n in both:
        diff = [f"{k[:60]} ({len(a[n].get(k, []))} -> {len(b[n].get(k, []))})"
                for k in sorted(set(a[n]) | set(b[n]))
                if a[n].get(k) != b[n].get(k)]
        print(f"{n}: " + ("same" if not diff else "differs: " +
                          "; ".join(diff)), flush=True)
    for n in sorted(set(mine) ^ set(theirs)):
        print(f"{n}: only in {'this checkout' if n in mine else other}")


if __name__ == "__main__":
    main()
