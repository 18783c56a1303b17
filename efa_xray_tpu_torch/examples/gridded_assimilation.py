#!/usr/bin/env python
"""Gridded assimilation demo: CONUS-scale synthetic ensemble + point obs.

Port of ``examples/gridded_assimilation.py``: build a gridded
EnsembleState, assimilate a network of localized surface observations
(BASELINE config-2 shape) with the EnSRF (on the card: the tail through
B1, the body through B4) or the LETKF, verify with the postprocess
statistics table, checkpoint to netCDF, and (optionally) run sharded over
every card (``--mesh``; with ``--device cpu`` a mesh of the CPU).  The
netCDF (``--out``, h5py) and map (``--plot``, matplotlib) steps run where
those packages are installed.

Run: ``python -m efa_xray_tpu_torch.examples.gridded_assimilation
[--nobs 200] [--mesh] [--device cpu]``
"""

import argparse
import time

import numpy as np

from efa_xray_tpu_torch import EnSRF, LETKF, obs_assimilation_statistics
from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.interop import to_host
from efa_xray_tpu_torch.utils.demo import (
    add_device_arg,
    apply_device,
    synchronize,
)
from efa_xray_tpu_torch.utils.demo_data import (
    gefs_like_state,
    observations_from_truth,
)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nobs", type=int, default=200)
    ap.add_argument("--ny", type=int, default=33)
    ap.add_argument("--nx", type=int, default=49)
    ap.add_argument("--nmems", type=int, default=21)
    ap.add_argument("--radius", type=float, default=1000.0)
    ap.add_argument("--inflation", type=float, default=1.05)
    ap.add_argument("--mesh", action="store_true", help="shard over all devices")
    ap.add_argument("--solver", choices=["ensrf", "letkf"], default="ensrf",
                    help="serial square-root filter (reference parity) or "
                    "all-at-once local transform filter")
    ap.add_argument("--out", default=None, help="netCDF output path")
    ap.add_argument("--plot", default=None,
                    help="save a localization-footprint map (with the "
                         "built-in coastline overlay) to this PNG path")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    args.device = apply_device(args)
    return args


def inputs(args) -> dict:
    """The synthetic ensemble on ``args.device``, its truth, the obs and
    the mesh (None without ``--mesh``)."""
    state, truth = gefs_like_state(ny=args.ny, nx=args.nx, nmems=args.nmems,
                                   device=args.device)
    obs = observations_from_truth(state, truth, args.nobs, radius=args.radius)
    return dict(state=state, truth=truth, obs=obs, mesh=make_mesh(args))


def make_mesh(args):
    """``--mesh``: every card, or the CPU alone under ``--device cpu``."""
    if not args.mesh:
        return None
    from efa_xray_tpu_torch.parallel import make_mesh as _make_mesh

    return (_make_mesh() if args.device.type == "cuda"
            else _make_mesh([args.device]))


def run(args, inp) -> dict:
    """The update and its verification in obs space and against the
    truth."""
    state, truth, obs, mesh = (inp["state"], inp["truth"], inp["obs"],
                               inp["mesh"])
    cfg = FilterConfig(localization="GC", method="blocked")
    solver_cls = LETKF if args.solver == "letkf" else EnSRF
    filt = solver_cls(state, obs, inflation=args.inflation, config=cfg,
                      mesh=mesh)
    synchronize(args.device)
    t0 = time.perf_counter()
    post, batch = filt.update()
    synchronize(args.device)  # force completion before timing
    update_s = time.perf_counter() - t0

    df = obs_assimilation_statistics(state, post, batch)
    prior_rmse = np.sqrt(np.mean((df["value"] - df["prior mean"]) ** 2))
    post_rmse = np.sqrt(np.mean((df["value"] - df["post mean"]) ** 2))

    # field-space verification against the known truth
    tr = np.transpose(truth, (3, 0, 1, 2))  # [V,T,Y,X]
    prior_field_rmse = np.sqrt(np.mean((to_host(state.ensemble_mean()) - tr)
                                       ** 2))
    post_field_rmse = np.sqrt(np.mean((to_host(post.ensemble_mean()) - tr)
                                      ** 2))
    return dict(mesh=mesh, post=post, batch=batch, update_s=update_s,
                stats=df,
                obs_rmse_prior=float(prior_rmse),
                obs_rmse_post=float(post_rmse),
                field_rmse_prior=float(prior_field_rmse),
                field_rmse_post=float(post_field_rmse))


def report(args, res) -> list:
    """The lines the script prints after the update."""
    return [
        f"update: {res['update_s']:.2f}s",
        res["stats"].head(8).to_string(),
        f"obs-space RMSE: prior={res['obs_rmse_prior']:.3f} "
        f"posterior={res['obs_rmse_post']:.3f}",
        f"field RMSE vs truth: prior={res['field_rmse_prior']:.3f} "
        f"posterior={res['field_rmse_post']:.3f}",
    ]


def persist(args, inp, res) -> None:
    """``--out`` (netCDF, h5py) and ``--plot`` (matplotlib)."""
    if args.out:
        res["post"].save_to_disk(args.out)
        print(f"posterior checkpointed to {args.out}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        # localization footprint of the first ob, with the built-in
        # coastline overlay (reference observation.py:94-115 via Basemap)
        ax = inp["obs"][0].map_localization(inp["state"])
        ax.figure.savefig(args.plot, dpi=110, bbox_inches="tight")
        print(f"localization footprint map -> {args.plot}")


def main(argv=None):
    args = parse_args(argv)
    inp = inputs(args)
    print(f"state: {inp['state']!r}; {len(inp['obs'])} obs")
    if inp["mesh"] is not None:
        print(f"mesh: {inp['mesh']}")
    res = run(args, inp)
    for line in report(args, res):
        print(line)
    persist(args, inp, res)


if __name__ == "__main__":
    main()
