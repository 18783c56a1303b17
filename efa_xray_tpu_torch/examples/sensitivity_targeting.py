#!/usr/bin/env python
"""Ensemble sensitivity analysis + observation targeting — the EFA
companion workflow (Madaus & Hakim 2015 pair EFA with ensemble
sensitivity; the reference implements neither tool).

Port of ``examples/sensitivity_targeting.py``, in float64 on every device
(the state's ``dtype``; the EnSRF's float64 update is the plain route):

1. Define a scalar forecast metric J: the area-mean of the LAST lead
   time over a verification box (per-member values — trajectory EFA
   means early-lead obs move it through time covariances).
2. Map where J is sensitive: ``dJ/dx = cov(x, J)/var(x)`` over the whole
   state in one device matvec, with a t-test significance mask
   (Torn & Hakim 2008).
3. Score a network of CANDIDATE early-lead observations by predicted
   metric-variance reduction (Ancell & Hakim 2007) and pick the best.
4. Assimilate the winner with the EnSRF and confirm the realized change
   in J matches the prediction (exact for one unlocalized ob + a linear
   metric — the square-root gain identity).

Run: ``python -m efa_xray_tpu_torch.examples.sensitivity_targeting
[--ncand 200] [--plot] [--device cpu]``
"""

import argparse

import numpy as np

from efa_xray_tpu_torch import EnSRF, Observation
from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.postprocess import (
    ensemble_sensitivity,
    observation_impact,
    region_mean_metric,
)
from efa_xray_tpu_torch.utils.demo import add_device_arg, apply_device
from efa_xray_tpu_torch.utils.demo_data import gefs_like_state

# the metric's verification box (last lead time)
BOX_LAT = (38.0, 48.0)
BOX_LON = (245.0, 265.0)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ncand", type=int, default=200)
    ap.add_argument("--plot", action="store_true",
                    help="save sensitivity_map.png (matplotlib)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    args.device = apply_device(args)
    return args


def inputs(args) -> dict:
    """The float64 ensemble on ``args.device`` and the candidate network
    at the FIRST lead."""
    state, _truth = gefs_like_state(ntimes=8, nmems=21, seed=3,
                                    dtype="float64", device=args.device)
    s = state.structure
    rng = np.random.default_rng(0)
    cands = [
        Observation(
            value=float(285.0 + rng.normal(0, 2)), obtype=s.var_names[0],
            time=s.times64()[0], error=1.0,
            lat=float(rng.uniform(s.lat.min(), s.lat.max())),
            lon=float(rng.uniform(s.lon.min(), s.lon.max())),
            assimilate_this=True, localize_radius=None,
        )
        for _ in range(args.ncand)
    ]
    return dict(state=state, cands=cands)


def run(args, inp) -> dict:
    state, cands = inp["state"], inp["cands"]
    s = state.structure

    # 1. the forecast metric: last-lead area mean over a verification box
    J = region_mean_metric(s.var_names[0], time_index=s.ntimes - 1,
                           lat_range=BOX_LAT, lon_range=BOX_LON)
    j0 = J(state)

    # 2. sensitivity map (all leads at once — one matvec)
    sens = ensemble_sensitivity(state, J, confidence=0.95)[s.var_names[0]]
    frac_sig = sens["significant"].mean(axis=(1, 2))

    # 3. score and rank the candidates
    imp = observation_impact(state, cands, J)
    best = int(imp["dJ_var_pred"].idxmin())
    row = imp.iloc[best]

    # 4. assimilate the winner; realized-vs-predicted
    cfg = FilterConfig(localization=None, dtype="float64")
    post, _ = EnSRF(state, [cands[best]], config=cfg, verbose=False).update()
    j1 = J(post)
    tol = 1e-9 if np.asarray(j1).dtype == np.float64 else 1e-3
    assert abs(j1.mean() - j0.mean() - row["dJ_mean_pred"]) < tol
    return dict(sens=sens, impact=imp, best=best,
                j0_mean=float(j0.mean()), j0_spread=float(j0.std(ddof=1)),
                frac_sig=frac_sig, best_lat=float(row["lat"]),
                best_lon=float(row["lon"]),
                dj_var_pred=float(row["dJ_var_pred"]),
                dj_mean_pred=float(row["dJ_mean_pred"]),
                dj_realized=float(j1.mean() - j0.mean()),
                var_j0=float(np.var(j0, ddof=1)),
                var_j1=float(np.var(j1, ddof=1)))


def report(args, res) -> list:
    return [
        f"metric J: last-lead mean over {BOX_LAT}x{BOX_LON}; "
        f"prior mean {res['j0_mean']:.2f} K, spread {res['j0_spread']:.3f} K",
        "significant-fraction by lead: "
        + np.array2string(res["frac_sig"], precision=2),
        f"best of {args.ncand} candidates: ob #{res['best']} at "
        f"({res['best_lat']:.1f}, {res['best_lon']:.1f}) — predicted "
        f"dVar(J) {res['dj_var_pred']:+.4f}, dJ {res['dj_mean_pred']:+.3f}",
        f"realized dJ {res['dj_realized']:+.3f} "
        f"(predicted {res['dj_mean_pred']:+.3f}); metric variance "
        f"{res['var_j0']:.4f} -> {res['var_j1']:.4f} "
        f"(predicted change {res['dj_var_pred']:+.4f})",
    ]


def plot(args, inp, res) -> None:
    """sensitivity_map.png (matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    s, sens = inp["state"].structure, res["sens"]
    fig, ax = plt.subplots(figsize=(8, 5))
    m = ax.pcolormesh(s.lon, s.lat, sens["sensitivity"][0],
                      cmap="RdBu_r", shading="auto")
    sig = sens["significant"][0]
    ax.contour(s.lon, s.lat, sig.astype(float), levels=[0.5],
               colors="k", linewidths=0.7)
    ax.plot(res["best_lon"], res["best_lat"], "k*", ms=16, mec="w",
            label="targeted ob")
    ax.plot([BOX_LON[0], BOX_LON[1], BOX_LON[1], BOX_LON[0], BOX_LON[0]],
            [BOX_LAT[0], BOX_LAT[0], BOX_LAT[1], BOX_LAT[1], BOX_LAT[0]],
            "g-", lw=2, label="metric box (last lead)")
    ax.legend(loc="lower left")
    ax.set_title("dJ/dx at lead 0 (sig. contoured), targeted ob")
    fig.colorbar(m, ax=ax, label="K per K")
    fig.savefig("sensitivity_map.png", dpi=120, bbox_inches="tight")
    print("wrote sensitivity_map.png")


def main(argv=None):
    args = parse_args(argv)
    inp = inputs(args)
    res = run(args, inp)
    for line in report(args, res):
        print(line)
    if args.plot:
        plot(args, inp, res)


if __name__ == "__main__":
    main()
