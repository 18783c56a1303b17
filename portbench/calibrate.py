"""Readings for a cell's limits, in one process: the program's compared
numbers on many seeds, and its control's on a few.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 1 2 3 ... [--control-seeds 101 102 103] \
        [--trace-seeds ...] [--out readings.jsonl]

The control is the program with the precision path that the cell's file
names under ``control`` switched on (for these cells, TF32 tensor cores
in the body kernels' two products: the step below the configuration's
float32 that would tempt a later change); it has to come out not
correct.  Every run is a whole harness run at the cell's own sizes with
a short window; one line of JSON each, to standard output and ``--out``.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    runs = ([(s, False, None) for s in args.seeds]
            + [(s, True, None) for s in args.trace_seeds]
            + [(s, False, cell.check["control"]) for s in args.control_seeds])
    out = open(args.out, "a") if args.out else None
    for seed, traced, fields in runs:
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        r = harness.run(ROOT, args.workload, seed, args.seconds, traced,
                        "cuda:0", t, fields=fields)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "traced": traced, "control": fields,
                           "run_s": time.perf_counter() - t, **r})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
