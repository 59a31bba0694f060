"""Readings for the limits of a cell's check, on this machine's card.

    python3 perfbench/calibrate.py --workload logreg_paper.w64 \
        --seeds 11,12,13 --control-seeds 21,22,23

For each of ``--seeds`` the program runs one whole solve of the cell at
its own size through the harness (``run_cell``, one solve in place of the
timed window) and the check's numbers are printed: the lower readings.
For each of ``--control-seeds`` the control runs in the program's place
(the kind's ``control_window``: the reference one precision below the
configuration's) and is judged the same way: the upper readings.  One
JSON line each, on standard output and appended to ``--out``.  Exits 2
without a CUDA card: the readings are the card's.  The benchmark's own
runs never run this.
"""
import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build",
                                                   "torch_kernels")

from perfbench.harness import bench  # noqa: E402
from perfbench.harness import spec as spec_mod  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    spec = spec_mod.cell_spec(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    jobs = [(s, False) for s in args.seeds] + \
        [(s, True) for s in args.control_seeds]
    for seed, control in jobs:
        t0 = time.perf_counter()
        out = bench.run_cell(spec, seed, float("inf"), False, "cuda",
                             t0, max_solves=1, control=control,
                             log=lambda m: print(f"  {m}", file=sys.stderr))
        win = out["window"]
        line = {"workload": args.workload, "seed": seed,
                "side": "control" if control else "program",
                "correct": out["result"]["correct"],
                "rounds": len(win.rounds),
                "solve_s": win.seconds,
                "numbers": {c.name: c.value for c in out["checks"]},
                "limits": {c.name: c.limit for c in out["checks"]},
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del out, win
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
