#!/usr/bin/env python
"""Fixed-lag smoothing and incremental analysis update on Lorenz-96.

Port of ``examples/cycling_smoother.py``, in float64.  Two production
mechanisms beyond the reference, both riding on the cycling harness (see
``docs/design.md`` §2.7):

* ``smoother_lag=L`` — each cycle's observations re-analyze the previous
  L analyses through cross-time ensemble covariances (fixed-lag EnKS,
  Evensen & van Leeuwen 2000).  Reanalysis beats the real-time filter.
* ``iau_steps=N`` — analysis increments are applied as a constant
  forcing over the next window's substeps (Bloom et al. 1996) instead
  of direct insertion, suppressing insertion shock.

Run: ``python -m efa_xray_tpu_torch.examples.cycling_smoother [--cycles 40]
[--lag 3] [--iau 4] [--device cpu]``
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
    ap.add_argument("--lag", type=int, default=3)
    ap.add_argument("--iau", type=int, default=0,
                    help="IAU substeps per window (0 = direct insertion)")
    ap.add_argument("--nvars", type=int, default=40)
    ap.add_argument("--nmems", type=int, default=20)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    args.device = apply_device(args)
    return args


def inputs(args) -> dict:
    """The spun-up truth and ensemble (float64, on ``args.device``)."""
    truth, ens = l96.spinup_ensemble(nvars=args.nvars, nmems=args.nmems,
                                     seed=13, device=args.device,
                                     dtype=torch.float64)
    return dict(truth=truth, ens=ens)


def run(args, inp) -> dict:
    lats, lons = l96.fake_latlon(args.nvars)
    # With IAU the forecast callable is ONE substep; the harness applies
    # `iau_steps` of them per cycle.  Keep the window length (4 model
    # steps) identical either way.
    substeps = args.iau if args.iau > 0 else 1
    harness = CyclingHarness(
        forecast=lambda x: l96.integrate(x, nsteps=4 // substeps or 1),
        state_lats=lats,
        state_lons=lons,
        ob_error=1.0,
        localize_radius=4000.0,
        config=FilterConfig(localization="GC", dtype="float64", block_size=8),
        obs_operator_rows=np.arange(0, args.nvars, 2),
        inflation=1.05,
        smoother_lag=args.lag,
        iau_steps=args.iau,
        device=args.device,
    )
    stats = harness.run(inp["ens"], inp["truth"], ncycles=args.cycles,
                        seed=113)

    filt = {s.cycle: s.analysis_rmse for s in stats}
    smoothed = harness.smoothed_rmse()
    pairs = [(c, r) for c, r in smoothed if c >= 10]
    f_mean = float(np.mean([filt[c] for c, _ in pairs]))
    s_mean = float(np.mean([r for _, r in pairs]))
    assert s_mean < f_mean, "smoother should beat the filter"
    return dict(harness=harness, stats=stats,
                table=[(c, filt[c], r) for c, r in smoothed if c % 5 == 0],
                filter_mean=f_mean, smoothed_mean=s_mean)


def report(args, res) -> list:
    f_mean, s_mean = res["filter_mean"], res["smoothed_mean"]
    return ([f"{'cyc':>4} {'filter_rmse':>12} {'smoothed_rmse':>14}"]
            + [f"{c:>4} {f:12.3f} {r:14.3f}" for c, f, r in res["table"]]
            + [f"\nmean over cycles 10+: filter {f_mean:.3f} -> "
               f"lag-{args.lag} smoothed {s_mean:.3f} "
               f"({100 * (1 - s_mean / f_mean):.0f}% better)"])


def main(argv=None):
    args = parse_args(argv)
    res = run(args, inputs(args))
    for line in report(args, res):
        print(line)


if __name__ == "__main__":
    main()
