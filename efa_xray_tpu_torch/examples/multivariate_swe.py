#!/usr/bin/env python
"""Multivariate EFA on a rotating shallow-water channel: height
observations correct the WIND field — and the future forecast — through
flow-dependent ensemble covariances.

Port of ``examples/multivariate_swe.py``, in float32 on ``--device`` (the
JAX script pins itself to the CPU; here the spin-up, the forecasts and
the harness's analysis run where the tensors live, the analysis on the
card through B1 and B4).  This is the mechanism the reference's EFA use
case is built on (Madaus & Hakim 2015; the reference demo adjusts a
forecast trajectory through time covariances, ``efa_demo.ipynb`` cell
11) demonstrated on a dynamical model with a real balance relation: the
ensemble's eta<->wind covariances encode near-geostrophy, so assimilating
ONLY height observations produces wind increments that survive
integration instead of radiating away as gravity waves.

Run: ``python -m efa_xray_tpu_torch.examples.multivariate_swe [--cycles 5]
[--device cpu]`` (the spin-up integration dominates.)
"""

import argparse

import numpy as np
import torch

from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.interop import to_host
from efa_xray_tpu_torch.models import swe
from efa_xray_tpu_torch.models.cycling import CyclingHarness
from efa_xray_tpu_torch.utils.demo import add_device_arg, apply_device

# Spin-up lengths of the truth and of the members, and the forecast-impact
# horizon, in model steps.
SPINUP_STEPS = 2500
MEMBER_STEPS = 400
FORECAST_STEPS = 200


def per_var_rmse(flat_ens, flat_truth, n):
    """Ensemble-mean RMSE of each variable, reduced on the tensors'
    device."""
    out = {}
    for i, v in enumerate(swe.VAR_ORDER):
        sl = slice(i * n, (i + 1) * n)
        out[v] = float(torch.sqrt(torch.mean(
            (flat_ens[:, sl].mean(dim=0) - flat_truth[sl]) ** 2)))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=5)
    ap.add_argument("--ny", type=int, default=16)
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--nmems", type=int, default=12)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    args.device = apply_device(args)
    return args


def inputs(args) -> dict:
    """The spun-up truth and ensemble dicts on ``args.device``."""
    truth, ens = swe.spinup_ensemble(
        ny=args.ny, nx=args.nx, nmems=args.nmems, seed=0,
        spinup_steps=SPINUP_STEPS, member_steps=MEMBER_STEPS,
        device=args.device)
    return dict(truth=truth, ens=ens)


def run(args, inp) -> dict:
    ny, nx = args.ny, args.nx
    n = ny * nx
    truth = inp["truth"]
    flat_ens = swe.pack(inp["ens"], ny, nx)
    flat_truth = swe.pack(truth, ny, nx)

    # --- one analysis: observe eta at every 2nd point, NO wind obs ---
    lat, lon = swe.grid_latlon(ny, nx)
    rows = swe.var_rows("eta", ny, nx, stride=2)
    rng = np.random.default_rng(7)
    ob_error = 1e-4
    yvals = to_host(flat_truth)[rows] + np.sqrt(ob_error) * rng.standard_normal(
        len(rows)
    )
    h = CyclingHarness(
        forecast=swe.make_flat_forecast(ny, nx, nsteps=10),
        state_lats=lat,
        state_lons=lon,
        ob_error=ob_error,
        localize_radius=4000.0,
        obs_operator_rows=rows,
        config=FilterConfig(rtps_alpha=0.5),
        device=args.device,
    )
    post, _ = h.analysis_step(flat_ens, yvals, lat[rows], lon[rows])
    bg, an = (per_var_rmse(e, flat_truth, n) for e in (flat_ens, post))

    # --- forecast impact: integrate background vs analysis forward ---
    nfc = FORECAST_STEPS
    tr_fc = swe.integrate(truth, ny, nsteps=nfc)
    pri_fc = swe.pack(swe.integrate(swe.unpack(flat_ens, ny, nx), ny, nfc),
                      ny, nx)
    pos_fc = swe.pack(swe.integrate(swe.unpack(post, ny, nx), ny, nfc),
                      ny, nx)
    t_flat = swe.pack(tr_fc, ny, nx)
    fb = per_var_rmse(pri_fc, t_flat, n)
    fa = per_var_rmse(pos_fc, t_flat, n)

    # --- a few full cycles ---
    stats = h.run(flat_ens, flat_truth, args.cycles, seed=3)
    return dict(post=post, background_rmse=bg, analysis_rmse=an,
                forecast_background_rmse=fb,
                forecast_analysis_rmse=fa, stats=stats)


def report(args, res) -> list:
    bg, an = res["background_rmse"], res["analysis_rmse"]
    fb, fa = res["forecast_background_rmse"], res["forecast_analysis_rmse"]
    lines = ["\nsingle analysis, height obs only (ensemble-mean RMSE):"]
    for v in swe.VAR_ORDER:
        tag = "observed" if v == "eta" else "NEVER observed"
        lines.append(f"  {v:3s} background {bg[v]:.5f} -> analysis "
                     f"{an[v]:.5f}  ({an[v] / bg[v]:.2f}x, {tag})")
    lines.append(f"\nforecast impact after {FORECAST_STEPS} steps:")
    for v in swe.VAR_ORDER:
        lines.append(f"  {v:3s} from background {fb[v]:.5f} -> from analysis"
                     f" {fa[v]:.5f}  ({fa[v] / fb[v]:.2f}x)")
    lines.append(f"\ncycling ({args.cycles} cycles, height obs only):")
    for s in res["stats"]:
        lines.append(f"  cycle {s.cycle}: bg={s.background_rmse:.4f}"
                     f" an={s.analysis_rmse:.4f} spread={s.mean_spread:.4f}")
    return lines


def main(argv=None):
    args = parse_args(argv)
    print(f"spinning up a {args.ny}x{args.nx} eddying channel, "
          f"{args.nmems} members ...")
    res = run(args, inputs(args))
    for line in report(args, res):
        print(line)


if __name__ == "__main__":
    main()
