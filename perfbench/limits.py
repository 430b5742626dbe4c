"""The readings that the limit of ``correct`` is set from.

    python3 perfbench/limits.py --workload <name> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 2 [--faults 1]

In one process, for each seed of ``--seeds``, one run of the cell with
the program (a short window, then the usual comparison): the largest of
their ulp gaps is the lower reading.  For each seed of
``--control-seeds``, the same run with the control in the program's
place (the reference computed in float32), with native float64 PyTorch,
and with ``--faults 1`` each of the routine's planted faults: the
smallest control gap is the upper reading.  Needs a CUDA card; the
benchmark's own runs do not run this.  One JSON line a run, then a
summary line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(bench, workload, seeds, control_seeds, seconds, faults,
             device="cuda", config=None):
    """Yields one dict a run: seed, side, ulp gap, calls, correct."""
    import torch

    from perfbench import harness

    _, cfg, _ = harness.find_cell(bench, workload)
    cfg = config or cfg
    rt, ref = harness.routine(cfg), harness.reference(cfg)
    sides = [("program", None, s) for s in seeds]
    for s in control_seeds:
        sides.append(("control_f32", ref.control_bits, s))
        sides.append(("native_f64", ref.native_bits, s))
        if faults:
            for f in rt.FAULTS:
                sides.append((f"fault_{f}",
                              lambda inp, f=f: rt.fault(f, inp), s))
    for side, call, seed in sides:
        t0 = time.perf_counter()
        r = harness.run(bench, workload, seed, seconds, False, device,
                        t0, call=call, config=cfg, log=lambda s: None)
        yield {"workload": workload, "seed": seed, "side": side,
               "ulp_gap": r["checks"]["ulp_gap"]["value"],
               "calls": r["attempted"], "failed": r["failed"],
               "correct": r["correct"],
               "seconds": time.perf_counter() - t0}
        del r
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--faults", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_benchmark(ROOT)

    def ints(text):
        return [int(s) for s in text.split(",") if s]

    rows = []
    for row in readings(bench, args.workload, ints(args.seeds),
                        ints(args.control_seeds), args.seconds, args.faults):
        rows.append(row)
        print(json.dumps(row), flush=True)
    prog = [r["ulp_gap"] for r in rows if r["side"] == "program"]
    ctrl = [r["ulp_gap"] for r in rows if r["side"] == "control_f32"]
    print(json.dumps({
        "workload": args.workload, "card": harness.card_line(),
        "lower": max(prog) if prog else None,
        "upper": min(ctrl) if ctrl else None,
        "program_correct": all(r["correct"] for r in rows
                               if r["side"] == "program"),
        "others_incorrect": all(not r["correct"] for r in rows
                                if r["side"] != "program")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
