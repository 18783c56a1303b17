#!/usr/bin/env python
"""Production-style cycling DA on Lorenz-96 with adaptive inflation.

Port of ``examples/cycling_adaptive.py``, in float64: forecast ->
(adaptively) inflate -> assimilate -> learn inflation from innovations ->
verify -> repeat.  Adaptive inflation is a first-class CyclingHarness
option (``adaptive_inflation=True``, Anderson 2009); the same machinery
is available on gridded states through
``EnSRF(inflation=AdaptiveInflation(...))``.

Run: ``python -m efa_xray_tpu_torch.examples.cycling_adaptive [--cycles 40]
[--device cpu]``
"""

import argparse

import numpy as np
import torch

from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.models import lorenz96 as l96
from efa_xray_tpu_torch.models.cycling import CyclingHarness
from efa_xray_tpu_torch.utils.demo import add_device_arg, apply_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=40)
    ap.add_argument("--nvars", type=int, default=40)
    ap.add_argument("--nmems", type=int, default=20)
    ap.add_argument("--ob-error", type=float, default=1.0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    args.device = apply_device(args)
    return args


def inputs(args) -> dict:
    """The spun-up truth and ensemble (float64, on ``args.device``)."""
    truth, ens = l96.spinup_ensemble(nvars=args.nvars, nmems=args.nmems,
                                     seed=7, device=args.device,
                                     dtype=torch.float64)
    return dict(truth=truth, ens=ens)


def run(args, inp) -> dict:
    lats, lons = l96.fake_latlon(args.nvars)
    harness = CyclingHarness(
        forecast=lambda x: l96.integrate(x, nsteps=4),
        state_lats=lats,
        state_lons=lons,
        ob_error=args.ob_error,
        localize_radius=4000.0,
        config=FilterConfig(localization="GC", dtype="float64", block_size=8),
        obs_operator_rows=np.arange(0, args.nvars, 2),
        adaptive_inflation=True,  # Anderson-2009 variance inflation, learned
        # Evolve the inflation std too (Anderson §4): the shrinking sd is
        # the principled self-damping, so no adaptive_max cap is needed
        # (docs/recipes.md; benchmarks/l96_evolve_scan.py).
        adaptive_sd_evolve=True,
        adaptive_sd_min=0.15,
        device=args.device,
    )
    stats = harness.run(inp["ens"], inp["truth"], ncycles=args.cycles,
                        seed=107)
    lam = harness.inflation_field()
    tail = float(np.mean([s.analysis_rmse for s in stats[-8:]]))
    assert tail < np.sqrt(args.ob_error), "cycling did not converge"
    return dict(harness=harness, stats=stats,
                table=[(s.cycle, s.background_rmse, s.analysis_rmse,
                        s.mean_spread) for s in stats
                       if s.cycle % 5 == 0 or s.cycle == args.cycles - 1],
                lam_mean=float(lam.mean()), lam_max=float(lam.max()),
                tail_rmse=tail)


def report(args, res) -> list:
    return ([f"{'cyc':>4} {'bg_rmse':>8} {'an_rmse':>8} {'spread':>7}"]
            + [f"{c:>4} {bg:8.3f} {an:8.3f} {sp:7.3f}"
               for c, bg, an, sp in res["table"]]
            + [f"learned inflation field: mean={res['lam_mean']:.3f} "
               f"max={res['lam_max']:.3f}",
               "converged: analysis RMSE below observation error"])


def main(argv=None):
    args = parse_args(argv)
    res = run(args, inputs(args))
    for line in report(args, res):
        print(line)


if __name__ == "__main__":
    main()
