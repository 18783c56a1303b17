#!/usr/bin/env python
"""Production observation pipeline: ingest -> QC/thin -> sort -> assimilate
-> diagnose -> persist.

Port of ``examples/obs_pipeline.py``, the batch-first pipeline:

1. observations arrive as a pandas DataFrame (the common operational form)
   and become an :class:`ObservationBatch` in one call;
2. superobbing + distance thinning reduce the dense network;
3. spherical Morton sorting picks the assimilation order that maximizes
   the fused kernel's localization culling;
4. the filter of choice (EnSRF / EnKF / LETKF) runs with per-ob
   diagnostics recorded (on the card the EnSRF's tail goes through B1
   and its body through B2);
5. Desroziers (2005) consistency diagnostics check the assigned R;
6. the posterior state AND posterior obs batch persist to
   netCDF4-compatible HDF5 (:func:`persist`, which needs h5py).

Run: ``python -m efa_xray_tpu_torch.examples.obs_pipeline [--solver ensrf]
[--nobs 600] [--device cpu]``
"""

import argparse
import tempfile

import numpy as np
import pandas as pd

from efa_xray_tpu_torch import EnKF, EnSRF, LETKF, obs_assimilation_statistics
from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.observation.observation import ObservationBatch
from efa_xray_tpu_torch.observation.thinning import (
    sort_spatially,
    superob,
    thin_by_distance,
)
from efa_xray_tpu_torch.postprocess import desroziers_diagnostics
from efa_xray_tpu_torch.utils.demo import add_device_arg, apply_device
from efa_xray_tpu_torch.utils.demo_data import gefs_like_state


def synthetic_obs_dataframe(state, truth, nobs, r_true=1.0, seed=7):
    """Obs as a DataFrame: the truth field observed with N(0, R) noise,
    plus duplicate clusters (what superobbing and thinning are for)."""
    rng = np.random.default_rng(seed)
    s = state.structure
    truth = truth[0, :, :, 0]  # first time, first var: [ny, nx]
    iy = rng.integers(1, s.ny - 1, nobs)
    ix = rng.integers(1, s.nx - 1, nobs)
    # 20% of obs are near-duplicates of earlier ones (dense clusters)
    dup = rng.random(nobs) < 0.2
    iy[dup] = iy[np.maximum(np.nonzero(dup)[0] - 1, 0)]
    ix[dup] = ix[np.maximum(np.nonzero(dup)[0] - 1, 0)]
    return pd.DataFrame(
        {
            "value": truth[iy, ix] + rng.normal(0, np.sqrt(r_true), nobs),
            "error": r_true,
            "lat": np.asarray(s.lat)[iy, ix],
            "lon": np.asarray(s.lon)[iy, ix],
            "time": np.repeat(s.times64()[0], nobs),
            "obtype": s.var_names[0],
            "localize_radius": 1500.0,
        }
    )


SOLVERS = {"ensrf": EnSRF, "enkf": EnKF, "letkf": LETKF}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", choices=["ensrf", "enkf", "letkf"],
                    default="ensrf")
    ap.add_argument("--nobs", type=int, default=600)
    ap.add_argument("--nmems", type=int, default=30)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    args.device = apply_device(args)
    return args


def inputs(args) -> dict:
    """The ensemble on ``args.device`` and the raw obs DataFrame."""
    state, truth = gefs_like_state(ny=40, nx=60, nmems=args.nmems, ntimes=1,
                                   device=args.device)
    return dict(state=state, df=synthetic_obs_dataframe(state, truth,
                                                        args.nobs))


def run(args, inp) -> dict:
    """Steps 1-5: ingest, thin, sort, assimilate, diagnose."""
    state = inp["state"]
    # 1. ingest
    batch = ObservationBatch.from_dataframe(inp["df"])
    nobs_ingested = batch.nobs

    # 2. preprocess: superob dense clusters, then enforce min separation
    batch = superob(batch, cell_deg=0.75)
    batch = thin_by_distance(batch, min_km=40.0)
    nobs_thinned = batch.nobs

    # 3. assimilation order: spatial Morton sort (maximizes kernel culling)
    batch = sort_spatially(batch)

    # 4. assimilate
    cfg = FilterConfig(localization="GC", fast_geometry=True,
                       spatial_sort=True, dtype="float32")
    kwargs = {"seed": 0} if args.solver == "enkf" else {}
    filt = SOLVERS[args.solver](state, batch, inflation=1.05, config=cfg,
                                verbose=False, **kwargs)
    post, out = filt.update()
    ok = np.asarray(out.assimilated, bool)

    # 5. diagnostics
    stats = obs_assimilation_statistics(state, post, out)
    dd = desroziers_diagnostics(stats)
    return dict(nobs_ingested=nobs_ingested, nobs_thinned=nobs_thinned,
                post=post, out=out, nassim=int(ok.sum()), nobs=out.nobs,
                stats=stats, desroziers=dd)


def report(args, res) -> list:
    return [
        f"ingested {res['nobs_ingested']} obs from DataFrame",
        f"after superob + thinning: {res['nobs_thinned']} obs",
        f"assimilated {res['nassim']}/{res['nobs']} obs with {args.solver}",
        res["desroziers"][["nobs", "R_assigned", "R_estimated", "R_ratio",
                           "innov_consistency"]].to_string(),
    ]


def persist(res) -> None:
    """6. the posterior state and obs to netCDF and back (h5py)."""
    from efa_xray_tpu_torch.utils import ncio

    post, out = res["post"], res["out"]
    with tempfile.TemporaryDirectory() as td:
        ncio.write_state(f"{td}/posterior.nc", post)
        ncio.write_obs(f"{td}/obs_posterior.nc", out)
        back = ncio.read_obs(f"{td}/obs_posterior.nc")
        assert np.allclose(back.post_mean, out.post_mean)
        print("persisted posterior state + obs (round-trip checked)")


def main(argv=None):
    args = parse_args(argv)
    res = run(args, inputs(args))
    for line in report(args, res):
        print(line)
    persist(res)


if __name__ == "__main__":
    main()
