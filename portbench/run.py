"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` also ``breakdown``; last ``checks``, each
compared number beside its limit, which the last lines of standard error
repeat).  Without enough CUDA devices, or with JAX or the JAX package
loaded, it prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches of the program stay inside the checkout, at
# fixed paths (the CUDA library goes to build/efa_xray_tpu_torch/).
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


def _finite(x):
    """The result with every non-finite number as a string, so that the
    line is strict JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv=None) -> int:
    from portbench import harness

    t_start = harness.clock_at_process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import guard, spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda:0", t_start)
    bad = guard.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}: JAX and the JAX "
              "package may not run here", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    # The checkout's root, not this directory: the harness's module names
    # (trace, spec, ...) must not shadow the standard library's.
    sys.path[0] = str(ROOT)
    sys.exit(main())
