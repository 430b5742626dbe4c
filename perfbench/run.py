"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Run from the root of a checkout that holds the program
(``exblas_tpu_torch``).  The last line of standard output is the result,
one JSON object; the numbers compared, each beside its limit, are the
last lines of standard error.  Without a CUDA card, or with fewer cards
than the cell asks for, it prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness

    bench = harness.load_benchmark(ROOT)
    entry, _, _ = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", T_START,
                         log=lambda s: print(s, flush=True))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
