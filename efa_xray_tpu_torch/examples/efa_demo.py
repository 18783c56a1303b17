#!/usr/bin/env python
"""Ensemble Forecast Adjustment demo — offline twin of ``efa_demo.ipynb``.

Port of ``examples/efa_demo.py``: a GEFS-like point-forecast ensemble
(the notebook fetched one from Unidata THREDDS, cell 6), observations of
the early lead times, a serial square-root assimilation of the whole
forecast TRAJECTORY as one-location ``EnsembleState`` (so later lead
times adjust through time covariances — the EFA idea), and the
spaghetti/variance panels the notebook's ipywidgets viewer drew (cells
14-16), saved as a PNG by :func:`plot` (matplotlib).

Run: ``python -m efa_xray_tpu_torch.examples.efa_demo [--out efa_demo.png]
[--device cpu]``
"""

import argparse

import numpy as np

from efa_xray_tpu_torch import EnSRF, EnsembleState, Observation
from efa_xray_tpu_torch.interop import to_host
from efa_xray_tpu_torch.utils.demo import add_device_arg, apply_device
from efa_xray_tpu_torch.utils.demo_data import get_ensemble_point

VAR = "Temperature_height_above_ground_ens"


def build_point_state(point_data, varname, device=None):
    """Wrap an (ntimes, nens) point forecast as a 1-location EnsembleState
    on ``device`` (the EFA trick: the whole trajectory is the state
    vector)."""
    arr = point_data[varname]  # [nt, nens]
    nt, nens = arr.shape
    return EnsembleState.from_vardict(
        {varname: arr[:, None, :]},  # (nt, nloc=1, nens)
        {
            "validtime": point_data["times"],
            "lat": np.asarray([point_data["lat"]]),
            "lon": np.asarray([point_data["lon"]]),
            "mem": np.arange(nens),
        },
        device=device,
    )


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="efa_demo.png")
    ap.add_argument("--n-obs", type=int, default=5)
    ap.add_argument("--ob-error", type=float, default=1.0)
    ap.add_argument("--inflation", type=float, default=1.0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    args.device = apply_device(args)
    return args


def inputs(args) -> dict:
    """The point forecast, its state on ``args.device`` and the obs of the
    first lead times."""
    data = get_ensemble_point(variables=[VAR], seed=3)
    state = build_point_state(data, VAR, args.device)
    times = data["times"]

    # Observations at the first few lead times (the notebook used
    # obs = [275, 275, 275, 275, 276] at 3-hourly times, cell 8).
    rng = np.random.default_rng(0)
    truth_like = data[VAR].mean(axis=1)  # pseudo-truth for the demo
    obs = []
    for i in range(args.n_obs):
        obs.append(
            Observation(
                value=float(truth_like[i] - 1.5 + rng.normal(0, 0.3)),
                obtype=VAR,
                time=times[i],
                error=args.ob_error,
                lat=data["lat"],
                lon=data["lon"],
                assimilate_this=True,
                localize_radius=None,  # no localization, as in the notebook
            )
        )
    return dict(data=data, state=state, obs=obs)


def run(args, inp) -> dict:
    state = inp["state"]
    filt = EnSRF(state, inp["obs"], inflation=args.inflation or None,
                 verbose=True, loc=False)
    post, _ = filt.update()

    prior_arr = to_host(state[VAR])[:, 0, 0, :]  # [nt, nens]
    post_arr = to_host(post[VAR])[:, 0, 0, :]
    # The EFA payoff: variance shrinks at (and beyond) the assimilated times.
    assert post_arr.var(axis=1).mean() < prior_arr.var(axis=1).mean()
    return dict(post=post, prior_arr=prior_arr, post_arr=post_arr,
                prior_var=prior_arr.var(axis=1)[: args.n_obs + 2].round(3),
                post_var=post_arr.var(axis=1)[: args.n_obs + 2].round(3))


def report(args, res) -> list:
    return [f"prior var {res['prior_var']}", f"post  var {res['post_var']}"]


def plot(args, inp, res) -> None:
    """The 2x2 figure to ``args.out`` (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    times, obs = inp["data"]["times"], inp["obs"]
    prior_arr, post_arr = res["prior_arr"], res["post_arr"]
    fig, axes = plt.subplots(2, 2, figsize=(13, 8), sharex=True)
    for ax, arr, title in (
        (axes[0, 0], prior_arr, "Prior ensemble"),
        (axes[0, 1], post_arr, "Posterior ensemble"),
    ):
        ax.plot(times, arr, color="steelblue", alpha=0.35, lw=0.8)
        ax.plot(times, arr.mean(axis=1), color="k", lw=2, label="ens mean")
        ax.scatter([o.time for o in obs], [o.value for o in obs],
                   color="crimson", zorder=5, label="obs")
        ax.set_title(title)
        ax.legend(loc="upper left", fontsize=8)
        ax.set_ylabel("T2m [K]")
    axes[1, 0].plot(times, prior_arr.var(axis=1), label="prior")
    axes[1, 0].plot(times, post_arr.var(axis=1), label="posterior")
    axes[1, 0].set_title("Ensemble variance by lead time")
    axes[1, 0].legend()
    axes[1, 1].plot(times, prior_arr.mean(axis=1) - post_arr.mean(axis=1))
    axes[1, 1].set_title("Mean adjustment (prior - posterior)")
    fig.autofmt_xdate()
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    print(f"saved {args.out}")


def main(argv=None):
    args = parse_args(argv)
    inp = inputs(args)
    res = run(args, inp)
    plot(args, inp, res)
    for line in report(args, res):
        print(line)


if __name__ == "__main__":
    main()
