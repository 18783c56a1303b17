"""Real-data file ingest walkthrough: GEFS-like netCDF -> EnsembleState ->
CLI assimilation -> posterior + per-ob statistics.

Port of ``examples/real_data_ingest.py``.  The reference demo fetches a
live GEFS ensemble from Unidata THREDDS (``efa_demo.ipynb`` cell 6, via
siphon) — a network path that cannot run offline.  The file-based
production analog is this script:

1. a GEFS-like ensemble netCDF ON DISK (here synthesized with realistic
   structure if absent: 21 members, 2-m temperature over the Pacific
   Northwest, CF attrs, an ``fhour`` auxiliary coordinate — point the
   ``--state`` flag at a real file to use your own);
2. ``EnsembleState.from_netcdf`` ingest (units/attrs/extra coords are
   preserved end to end — metadata-faithful I/O);
3. a surface-station observation CSV;
4. one ``efa-xray-tpu-torch assimilate`` CLI call producing the posterior
   netCDF, the posterior obs file, and a per-ob statistics CSV;
5. verification: obs-space RMSE prior vs posterior, metadata check.

The netCDF files need h5py.  :func:`run` is the part that needs no file
library: the state in memory, the station CSV written with ``csv`` and
read by ``cli.read_obs_csv``, the update the CLI's ``assimilate`` runs at
its defaults, and the RMSE check.

Run: ``python -m efa_xray_tpu_torch.examples.real_data_ingest
[--workdir DIR] [--device cpu]``
"""

from __future__ import annotations

import argparse
import csv
import os
import tempfile

import numpy as np

from efa_xray_tpu_torch import cli
from efa_xray_tpu_torch.assimilation.ensrf import EnSRF
from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.interop import to_host
from efa_xray_tpu_torch.postprocess.postprocess import (
    obs_assimilation_statistics,
)
from efa_xray_tpu_torch.state.ensemble import EnsembleState
from efa_xray_tpu_torch.utils.demo import add_device_arg, apply_device


def synthesize_gefs_like_state(nmems: int = 21, ny: int = 28, nx: int = 36,
                               ntimes: int = 8, seed: int = 7, device=None):
    """A GEFS-like T2M ensemble on ``device``: smooth synoptic field +
    growing ensemble spread over lead time, CF-style metadata."""
    rng = np.random.default_rng(seed)
    lat1 = np.linspace(42.0, 52.0, ny)
    lon1 = np.linspace(230.0, 248.0, nx)
    lon, lat = np.meshgrid(lon1, lat1)
    times = np.datetime64("2026-08-01T00") + np.arange(ntimes) * np.timedelta64(6, "h")

    # Synoptic-looking mean: zonal gradient + a propagating warm anomaly.
    base = 288.0 - 0.6 * (lat - 42.0)
    field = np.empty((ntimes, ny, nx, nmems))
    for t in range(ntimes):
        cx = 234.0 + 1.5 * t
        anom = 6.0 * np.exp(-(((lon - cx) / 4.0) ** 2 + ((lat - 47.0) / 3.0) ** 2))
        spread = 0.4 + 0.15 * t  # spread grows with lead time
        for m in range(nmems):
            member_shift = rng.normal(0, spread, size=(3,))
            pert = (
                member_shift[0]
                + member_shift[1] * np.sin(np.radians(4 * lon))
                + member_shift[2] * np.cos(np.radians(6 * lat))
            )
            field[t, :, :, m] = base + anom + pert
    fhour = (np.arange(ntimes) * 6).astype(np.float64)

    return EnsembleState.from_vardict(
        {"T2M": field},
        {
            "validtime": times,
            "lat": lat,
            "lon": lon,
            "mem": np.arange(nmems),
            "fhour": (("validtime",), fhour),
        },
        attrs={
            "title": "GEFS-like 2-m temperature ensemble (synthetic)",
            "institution": "efa_xray_tpu examples",
            "source": "examples/real_data_ingest.py",
        },
        var_attrs={"T2M": {"units": "K", "long_name": "2-m temperature"}},
        device=device,
    )


def station_rows(state, nobs: int = 12, seed: int = 11) -> list:
    """Surface-station rows in the CLI's schema (value, lat, lon, time,
    obtype + error/radius), sampled inside the state's domain with 1 K
    observation noise around a slightly-warmer 'truth'."""
    s = state.structure
    rng = np.random.default_rng(seed)
    mean = to_host(state.ensemble_mean())  # [V, T, Y, X]
    t_idx = 2  # assimilate at the 12-h lead
    rows = []
    for _ in range(nobs):
        iy = rng.integers(2, s.ny - 2)
        ix = rng.integers(2, s.nx - 2)
        truth = mean[0, t_idx, iy, ix] + 1.5  # warm 'truth' the prior misses
        rows.append(
            {
                "value": f"{truth + rng.normal(0, 1.0):.2f}",
                "lat": f"{s.lat[iy, ix]:.3f}",
                "lon": f"{s.lon[iy, ix]:.3f}",
                "time": str(s.times64()[t_idx]),
                "obtype": "T2M",
                "error": "1.0",
                "radius": "600",
            }
        )
    return rows


def write_rows_csv(path: str, rows: list) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def write_station_obs_csv(path: str, state_file: str, nobs: int = 12,
                          seed: int = 11, device=None) -> None:
    """:func:`station_rows` of the state in ``state_file`` as a CSV."""
    state = EnsembleState.from_netcdf(state_file, device=device)
    write_rows_csv(path, station_rows(state, nobs=nobs, seed=seed))


def obs_space_rmse(values, prior_mean, post_mean) -> tuple:
    """``(prior, posterior)`` obs-space RMSE."""
    vals = np.asarray(values, dtype=np.float64)
    return (float(np.sqrt(np.mean((vals - np.asarray(prior_mean)) ** 2))),
            float(np.sqrt(np.mean((vals - np.asarray(post_mean)) ** 2))))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "efa_xray_tpu_torch_ingest"))
    ap.add_argument("--state", default=None,
                    help="existing GEFS-like netCDF (default: synthesize)")
    ap.add_argument("--inflation", type=float, default=1.05)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    args.device = apply_device(args)
    return args


def inputs(args) -> dict:
    """The prior: the ``--state`` file, or the synthesized ensemble."""
    state = (EnsembleState.from_netcdf(args.state, device=args.device)
             if args.state else synthesize_gefs_like_state(device=args.device))
    return dict(state=state)


def run(args, inp) -> dict:
    """The walkthrough without netCDF files: the station CSV (written with
    ``csv`` into ``--workdir``), ``cli.read_obs_csv``, the EnSRF update of
    ``cli assimilate`` at its default flags, its per-ob statistics and
    the obs-space RMSE check."""
    state = inp["state"]
    os.makedirs(args.workdir, exist_ok=True)
    obs_csv = os.path.join(args.workdir, "stations.csv")
    write_rows_csv(obs_csv, station_rows(state))
    batch = cli.read_obs_csv(obs_csv)
    flags = cli.build_parser().parse_args([
        "assimilate", "--state", "-", "--obs", obs_csv, "--out", "-",
        "--inflation", str(args.inflation), "--device", str(args.device)])
    post, out = EnSRF(state, batch, inflation=flags.inflation,
                      verbose=flags.verbose,
                      config=FilterConfig(**cli.config_kwargs(flags))).update()
    stats = obs_assimilation_statistics(state, post, out)
    rmse_prior, rmse_post = obs_space_rmse(stats["value"], stats["prior mean"],
                                           stats["post mean"])
    assert rmse_post < rmse_prior, "assimilation did not reduce obs misfit"
    return dict(post=post, out=out, stats=stats, rmse_prior=rmse_prior,
                rmse_post=rmse_post)


def main(argv=None) -> int:
    args = parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    prior_nc = args.state or os.path.join(args.workdir, "gefs_like_prior.nc")
    obs_csv = os.path.join(args.workdir, "stations.csv")
    post_nc = os.path.join(args.workdir, "posterior.nc")
    obs_out = os.path.join(args.workdir, "posterior_obs.nc")
    stats_csv = os.path.join(args.workdir, "stats.csv")

    if args.state is None:
        print(f"[1/4] synthesizing GEFS-like ensemble -> {prior_nc}")
        inputs(args)["state"].save_to_disk(prior_nc)
    else:
        print(f"[1/4] using state file {prior_nc}")

    print(f"[2/4] writing surface-station obs CSV -> {obs_csv}")
    write_station_obs_csv(obs_csv, prior_nc, device=args.device)

    print("[3/4] running the CLI assimilation")
    rc = cli.main([
        "assimilate",
        "--state", prior_nc,
        "--obs", obs_csv,
        "--out", post_nc,
        "--obs-out", obs_out,
        "--stats", stats_csv,
        "--inflation", str(args.inflation),
        "--device", str(args.device),
    ])
    if rc:
        return rc

    print("[4/4] verification")
    post = EnsembleState.from_netcdf(post_nc, device=args.device)
    # metadata made the full trip: file -> state -> update -> file
    assert post.var_attrs.get("T2M", {}).get("units") == "K", \
        "T2M units lost in the round-trip"
    assert "fhour" in post.extra_coords, "fhour coord lost in the round-trip"
    with open(stats_csv) as f:
        stats = list(csv.DictReader(f))
    rmse_prior, rmse_post = obs_space_rmse(
        [float(r["value"]) for r in stats],
        [float(r["prior mean"]) for r in stats],
        [float(r["post mean"]) for r in stats])
    print(f"    posterior metadata: T2M units = "
          f"{post.var_attrs['T2M']['units']}, "
          f"attrs title = {post.attrs.get('title')!r}")
    print(f"    obs-space RMSE: prior {rmse_prior:.3f} K -> "
          f"posterior {rmse_post:.3f} K")
    assert rmse_post < rmse_prior, "assimilation did not reduce obs misfit"
    print(f"    artifacts: {post_nc}, {obs_out}, {stats_csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
