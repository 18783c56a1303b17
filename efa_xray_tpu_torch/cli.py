"""Command-line interface: run an assimilation without writing any code.

Counterpart of ``efa_xray_tpu/cli.py`` (``read_obs_csv`` :33, ``cmd_info``
:86, ``cmd_assimilate`` :103, ``cmd_target`` :272, ``cmd_verify`` :321,
``main`` :388), with the same subcommands, flags, defaults, printed lines
and exit codes.  Schedulers drive it with no Python written:

    python -m efa_xray_tpu_torch.cli info --state prior.nc
    python -m efa_xray_tpu_torch.cli assimilate \\
        --state prior.nc --obs obs.csv --out posterior.nc \\
        [--solver ensrf|letkf|enkf] [--inflation 1.05] [--radius 2000] \\
        [--stats stats.csv] [--fast-geometry] [--device cuda|cpu]
    python -m efa_xray_tpu_torch.cli target \\
        --state prior.nc --obs candidates.csv --out impact.csv \\
        [--metric-var T2m --metric-time-index -1 \\
         --metric-lat-range 40 50] [--nselect 10]
    python -m efa_xray_tpu_torch.cli verify \\
        --prior prior.nc --post posterior.nc --obs obs_post.nc

Installed as the console script ``efa-xray-tpu-torch``.  Files are the
JAX package's: a state, obs or config file written by either CLI is read
by the other.  Where it differs from the JAX CLI:

(a) ``--device`` (default ``cuda``) on every subcommand: the tensors live
    there and the filter runs there.  Without a card, ``--device cpu``
    must be given; the CLI never falls back to the CPU.
(b) ``--dtype float64`` needs no switch (the JAX CLI turns on x64).  On
    the card it takes the plain update, as ``FilterConfig(dtype=
    "float64")`` does.
(c) ``--mesh`` splits the state over every visible CUDA device
    (``parallel.make_mesh()``), or over ``[cpu]`` with ``--device cpu``.
(d) ``--mxu-bf16`` casts the two large products of the B2, B2h and B3
    body kernels to bf16 on every device, as the JAX kernels do in
    interpret mode (``ops/precision.py``).
(e) ``--matmul-precision`` sets the body kernels' products on the card:
    high / tensorfloat32 TF32, default / bfloat16 bf16 tensor cores;
    every other product, and the CPU, stay fp32.
(f) ``--bias-file`` reads the obs-space prior means of
    ``compute_ob_priors`` back to the host through ``interop.to_host``.
(g) As in the JAX CLI, the tuning flags' defaults equal the
    ``FilterConfig`` defaults field for field (the port's fields), so a
    ``--config`` file is the base and only flags that differ from the
    defaults override it.

Observation CSV columns (header required): ``value, lat, lon, time,
obtype`` plus optional ``error`` (default 1.0), ``radius`` (km GC
halfwidth; blank/inf = no localization), ``vert``, ``vert_radius``,
``assimilate`` (0/1, default 1), ``description``.  ``time`` is anything
``numpy.datetime64`` parses (e.g. ``2026-08-01T06:00``).
"""

from __future__ import annotations

import argparse
import csv
import sys

import numpy as np


def read_obs_csv(path: str):
    """Parse an observation CSV into an ObservationBatch."""
    from efa_xray_tpu_torch.observation.observation import ObservationBatch
    from efa_xray_tpu_torch.utils import timeutil

    rows = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        required = {"value", "lat", "lon", "time", "obtype"}
        if reader.fieldnames is None or not required.issubset(
            {c.strip() for c in reader.fieldnames}
        ):
            raise SystemExit(
                f"obs CSV needs columns {sorted(required)}; "
                f"got {reader.fieldnames}"
            )
        for r in reader:
            rows.append({k.strip(): (v.strip() if v is not None else "")
                         for k, v in r.items()})
    if not rows:
        raise SystemExit(f"no observations in {path}")

    def fcol(name, default):
        out = []
        for r in rows:
            v = r.get(name, "")
            out.append(float(v) if v not in ("", None) else default)
        return np.asarray(out, dtype=np.float64)

    times = timeutil.to_epoch_seconds(
        np.asarray([np.datetime64(r["time"]) for r in rows])
    )
    # A blank cell means "not specified" -> the documented default of 1
    # (only an explicit 0/false excludes the row from assimilation).
    assim = np.asarray(
        [(r.get("assimilate") or "1") not in ("0", "false", "False")
         for r in rows], dtype=bool,
    )
    return ObservationBatch(
        values=fcol("value", np.nan),
        errors=fcol("error", 1.0),
        lats=fcol("lat", np.nan),
        lons=fcol("lon", np.nan),
        times_s=times,
        obtypes=[r["obtype"] for r in rows],
        localize_radius=fcol("radius", np.inf),
        assimilate_flags=assim,
        verts=fcol("vert", np.nan),
        vert_radius=fcol("vert_radius", np.inf),
        descriptions=[r.get("description") or None for r in rows],
    )


def _device(args):
    """The device ``--device`` names; ``cuda`` (the default) raises
    without a card instead of running on the CPU."""
    from efa_xray_tpu_torch.state.ensemble import default_device

    return default_device(None if args.device == "cuda" else args.device)


def _read_state(path: str, args):
    from efa_xray_tpu_torch.state.ensemble import EnsembleState

    return EnsembleState.from_netcdf(path, dtype=args.dtype,
                                     device=_device(args))


def _read_obs(path: str):
    if path.endswith((".nc", ".h5", ".hdf5")):
        from efa_xray_tpu_torch.utils.ncio import read_obs

        return read_obs(path)
    return read_obs_csv(path)


def cmd_info(args):
    from efa_xray_tpu_torch.interop import to_host
    from efa_xray_tpu_torch.state.ensemble import EnsembleState

    state = EnsembleState.from_netcdf(args.state, device=_device(args))
    s = state.structure
    print(f"state file : {args.state}")
    print(f"variables  : {', '.join(s.var_names)}")
    print(f"grid       : {s.ny} x {s.nx} ({'2-D' if s.grid_is_2d else 'points'})")
    print(f"times      : {s.ntimes} ({s.times64()[0]} .. {s.times64()[-1]})")
    print(f"members    : {s.nmems}")
    print(f"state rows : {s.nstate}")
    mean = to_host(state.ensemble_mean())
    spread = to_host(state.ensemble_spread())
    print(f"mean/spread: {mean.mean():.4g} / {spread.mean():.4g}")
    return 0


def config_kwargs(args) -> dict:
    """The ``FilterConfig`` fields the tuning flags set (their defaults
    are the dataclass defaults, field for field)."""
    var_loc = None
    if args.var_loc:
        var_loc = {}
        for spec in args.var_loc:
            key, sep, val = spec.rpartition("=")
            if not sep:
                raise SystemExit(f"--var-loc needs OBSVAR:STATEVAR=F, "
                                 f"got {spec!r}")
            var_loc[key] = float(val)
    return dict(
        localization=None if args.no_localization else "GC",
        variable_localization=var_loc,
        method=args.method,
        dtype=args.dtype,
        fast_geometry=args.fast_geometry,
        mxu_bf16=args.mxu_bf16,
        matmul_precision=args.matmul_precision,
        spatial_sort=args.sort_spatial,
        rtps_alpha=args.rtps,
        rtpp_alpha=args.rtpp,
        outlier_threshold=args.outlier_threshold,
        outlier_action=args.outlier_action,
        taps_topk=args.taps_topk,
        taps_search=args.taps_search,
        letkf_topk=args.letkf_topk,
        letkf_k_obs=args.letkf_k_obs,
        letkf_patch_size=args.letkf_patch_size,
        verbose=args.verbose,
    )


def cmd_assimilate(args):
    from efa_xray_tpu_torch.config import FilterConfig

    state = _read_state(args.state, args)
    batch = _read_obs(args.obs)
    if args.thin_km:
        from efa_xray_tpu_torch.observation.thinning import thin_by_distance

        n0 = len(batch)
        batch = thin_by_distance(batch, args.thin_km)
        print(f"thinned {n0} -> {len(batch)} obs (min {args.thin_km} km)")
    if args.superob_deg:
        from efa_xray_tpu_torch.observation.thinning import superob

        n0 = len(batch)
        batch = superob(batch, args.superob_deg)
        print(f"superobbed {n0} -> {len(batch)} obs "
              f"({args.superob_deg} deg cells)")
    if args.radius is not None:
        batch.localize_radius = np.where(
            np.isinf(batch.localize_radius), args.radius, batch.localize_radius
        )
    if args.sort_spatial:
        from efa_xray_tpu_torch.observation.thinning import sort_spatially

        batch = sort_spatially(batch)

    cli_kwargs = config_kwargs(args)
    if args.config:
        import dataclasses

        # The file is the base; explicit CLI flags win.  "Explicit" is
        # detected as differing from the FilterConfig default (CLI
        # defaults mirror the dataclass defaults field for field).
        defaults = {f.name: f.default for f in dataclasses.fields(FilterConfig)}
        cfg = FilterConfig.load(
            args.config,
            **{k: v for k, v in cli_kwargs.items() if v != defaults[k]},
        )
    else:
        cfg = FilterConfig(**cli_kwargs)
    mesh = None
    if args.mesh:
        from efa_xray_tpu_torch.parallel import make_mesh

        dev = _device(args)
        mesh = make_mesh() if dev.type == "cuda" else make_mesh([dev])

    if args.solver == "letkf":
        from efa_xray_tpu_torch.assimilation.letkf import LETKF

        filt = LETKF(state, batch, inflation=args.inflation,
                     verbose=args.verbose, config=cfg, mesh=mesh)
    elif args.solver == "enkf":
        from efa_xray_tpu_torch.assimilation.enkf import EnKF

        filt = EnKF(state, batch, inflation=args.inflation,
                    verbose=args.verbose, config=cfg, seed=args.seed,
                    mesh=mesh)
    else:
        from efa_xray_tpu_torch.assimilation.ensrf import EnSRF

        filt = EnSRF(state, batch, inflation=args.inflation,
                     verbose=args.verbose, config=cfg, mesh=mesh)

    if args.bias_file:
        # Cycle-persistent per-obtype bias correction: learn this batch's
        # forecast O-B mean per type (EMA across invocations via the JSON
        # file), subtract the updated estimate from the values, assimilate
        # the corrected obs.  observation/bias.py documents the scheme.
        import os

        from efa_xray_tpu_torch.interop import to_host
        from efa_xray_tpu_torch.observation.bias import BiasCorrection

        bias = (
            BiasCorrection.load(args.bias_file)
            if os.path.exists(args.bias_file)
            else BiasCorrection(alpha=args.bias_alpha)
        )
        tm, _ = filt.compute_ob_priors()
        batch.prior_mean = np.asarray(to_host(tm), dtype=np.float64)
        bias.update(batch)
        batch.prior_mean = None  # the filter writes its own diagnostics
        offsets = np.asarray(
            [bias.offset_for(t) for t in batch.obtypes], dtype=np.float64
        )
        batch.values = np.asarray(batch.values, dtype=np.float64) - offsets
        bias.save(args.bias_file)
        print(
            "bias correction: "
            + ", ".join(
                f"{t}={bias.offset_for(t):+.4g}"
                for t in dict.fromkeys(batch.obtypes)
            )
            + f" -> {args.bias_file}"
        )

    post, out_batch = filt.update()

    post.save_to_disk(args.out)
    nassim = int(np.sum(out_batch.assimilated))
    print(f"assimilated {nassim}/{len(out_batch)} obs -> {args.out}")
    if out_batch.qc_outlier is not None and np.any(out_batch.qc_outlier):
        verb = "rejected" if cfg.outlier_action == "reject" else "R-inflated"
        print(f"outlier check (t={cfg.outlier_threshold}) {verb} "
              f"{int(np.sum(out_batch.qc_outlier))} obs")
    if args.obs_out:
        from efa_xray_tpu_torch.utils.ncio import write_obs

        write_obs(args.obs_out, out_batch)
        print(f"wrote posterior observations -> {args.obs_out}")

    if args.stats:
        from efa_xray_tpu_torch.postprocess.postprocess import (
            obs_assimilation_statistics,
        )

        df = obs_assimilation_statistics(state, post, out_batch)
        df.to_csv(args.stats, index=False)
        pm = df["prior mean"].to_numpy()
        om = df["post mean"].to_numpy()
        vals = df["value"].to_numpy()
        ok = np.isfinite(om)
        print(
            f"obs-space RMSE prior={np.sqrt(np.mean((vals - pm) ** 2)):.4g} "
            f"posterior={np.sqrt(np.mean((vals[ok] - om[ok]) ** 2)):.4g} "
            f"-> {args.stats}"
        )
    return 0


def cmd_target(args):
    """Observation targeting: score candidate obs by predicted impact on
    a scalar forecast metric (Ancell & Hakim 2007), optionally designing
    an n-ob network greedily (exact obs-space serial update between
    picks).  The metric is the area mean of --metric-var over the
    optional --metric-time-index / lat/lon box."""
    from efa_xray_tpu_torch.postprocess.sensitivity import (
        greedy_obs_selection,
        observation_impact,
        region_mean_metric,
    )

    state = _read_state(args.state, args)
    batch = _read_obs(args.obs)

    metric = region_mean_metric(
        args.metric_var or state.structure.var_names[0],
        time_index=args.metric_time_index,
        lat_range=tuple(args.metric_lat_range) if args.metric_lat_range
        else None,
        lon_range=tuple(args.metric_lon_range) if args.metric_lon_range
        else None,
    )
    if args.nselect:
        df = greedy_obs_selection(state, batch, metric, args.nselect)
        print(f"greedy network: {len(df)} picks, cumulative predicted "
              f"dJ = {df['dJ_mean_cum'].iloc[-1]:+.4g}, "
              f"dVar(J) = {df['dJ_var_cum'].iloc[-1]:+.4g}")
    else:
        df = observation_impact(state, batch, metric)
        best = df["dJ_var_pred"].idxmin()
        print(f"scored {len(df)} candidates; best: #{best} at "
              f"({df['lat'][best]:.2f}, {df['lon'][best]:.2f}), "
              f"predicted dVar(J) = {df['dJ_var_pred'][best]:+.4g}")
    df.to_csv(args.out, index=False)
    print(f"wrote {args.out}")
    return 0


def cmd_verify(args):
    """Observation-space verification of an assimilation run: the per-ob
    statistics table (reference postprocess.py:8-39) plus the ensemble-
    quality diagnostics the reference never had: Desroziers R/HBH^T
    consistency, rank histogram, CRPS, innovation consistency."""
    from efa_xray_tpu_torch.postprocess import (
        crps,
        desroziers_diagnostics,
        obs_assimilation_statistics,
        rank_histogram,
    )

    prior = _read_state(args.prior, args)
    post = _read_state(args.post, args)
    batch = _read_obs(args.obs)
    if batch.assimilated is None or not np.any(batch.assimilated):
        # raw (pre-assimilation) obs file: score the obs that were
        # FLAGGED for assimilation (the posterior obs file from
        # `assimilate --obs-out` carries the real per-ob outcome)
        print("note: no per-ob assimilated outcomes in the obs file; "
              "using the assimilate_this flags")
        batch.assimilated = np.asarray(batch.assimilate_flags, dtype=bool)

    df = obs_assimilation_statistics(prior, post, batch)
    vals = df["value"].to_numpy()
    pm = df["prior mean"].to_numpy()
    om = df["post mean"].to_numpy()
    ok = np.isfinite(pm) & np.isfinite(om)
    print(f"{len(df)} obs ({int(df['assimilated'].sum())} assimilated); "
          f"obs-space RMSE prior={np.sqrt(np.mean((vals[ok]-pm[ok])**2)):.4g}"
          f" posterior={np.sqrt(np.mean((vals[ok]-om[ok])**2)):.4g}")

    _, crps_prior = crps(prior, batch)
    _, crps_post = crps(post, batch)
    print(f"obs-space CRPS prior={crps_prior:.4g} posterior={crps_post:.4g}")

    counts = rank_histogram(prior, batch)
    print(f"prior rank histogram (flat = reliable): {counts.tolist()}")

    try:
        dd = desroziers_diagnostics(df)
        print("Desroziers consistency (per obtype):")
        print(dd.to_string(
            float_format=lambda v: f"{v:.4g}",
            columns=["nobs", "R_assigned", "R_estimated", "R_ratio",
                     "HBHT_estimated", "prior_var_ensemble",
                     "innov_consistency"],
        ))
    except ValueError as e:
        print(f"Desroziers diagnostics skipped: {e}")

    if args.stats:
        df.to_csv(args.stats, index=False)
        print(f"wrote per-ob table -> {args.stats}")
    return 0


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device of the tensors and the filter "
                        "(default cuda: the card; without one pass "
                        "--device cpu)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="efa-xray-tpu-torch",
        description="ensemble data assimilation (EnSRF / LETKF / EnKF) in "
                    "PyTorch, on an NVIDIA GPU by default",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p_info = sub.add_parser("info", help="describe a state netCDF file")
    p_info.add_argument("--state", required=True)
    _add_device(p_info)
    p_info.set_defaults(func=cmd_info)

    p_as = sub.add_parser("assimilate", help="assimilate obs into a state")
    p_as.add_argument("--state", required=True, help="prior state netCDF")
    p_as.add_argument("--obs", required=True,
                      help="observation CSV or netCDF (.nc/.h5)")
    p_as.add_argument("--out", required=True, help="posterior netCDF path")
    p_as.add_argument("--obs-out", default=None,
                      help="write the posterior obs batch (with per-ob "
                           "diagnostics) to this netCDF path")
    p_as.add_argument("--stats", default=None, help="per-ob stats CSV path")
    p_as.add_argument("--config", default=None,
                      help="FilterConfig JSON file (FilterConfig.save of "
                           "either package / hand-written; only "
                           "non-default fields needed). Explicit CLI "
                           "tuning flags override the file.")
    p_as.add_argument("--method", choices=["blocked", "serial"],
                      default="blocked",
                      help="execution strategy for the EnSRF/EnKF solvers "
                           "(blocked two-phase, default, or the literal "
                           "per-ob serial scan)")
    p_as.add_argument("--solver", choices=["ensrf", "letkf", "enkf"],
                      default="ensrf")
    p_as.add_argument("--seed", type=int, default=0,
                      help="perturbation seed for --solver enkf")
    p_as.add_argument("--sort-spatial", action="store_true",
                      help="Hilbert-sort obs and Morton-sort state rows "
                           "(maximizes the fused kernel's localization "
                           "culling)")
    p_as.add_argument("--inflation", type=float, default=None)
    p_as.add_argument("--radius", type=float, default=None,
                      help="default GC halfwidth km for obs without one")
    p_as.add_argument("--no-localization", action="store_true")
    p_as.add_argument("--thin-km", type=float, default=None,
                      help="thin obs to a minimum pairwise separation (km)")
    p_as.add_argument("--outlier-threshold", type=float, default=None,
                      help="innovation-based gross-error QC: reject obs "
                           "with |y - mean(ye)| > t*sqrt(var(ye) + R) "
                           "(DART's outlier_threshold; typical 3-4)")
    p_as.add_argument("--outlier-action", default="reject",
                      choices=["reject", "inflate"],
                      help="flagged-outlier treatment: reject (skip the "
                           "ob; DART) or inflate (raise R so the "
                           "innovation sits at t sigma and assimilate "
                           "anyway; Minamide & Zhang 2017 AOEI)")
    p_as.add_argument("--bias-file", default=None,
                      help="per-obtype bias-correction state (JSON): loaded "
                           "if present, O-B-updated from this batch, applied "
                           "to the values, saved back (cycle-persistent)")
    p_as.add_argument("--bias-alpha", type=float, default=0.2,
                      help="EMA rate for a NEW --bias-file (default 0.2)")
    p_as.add_argument("--superob-deg", type=float, default=None,
                      help="average obs per lat/lon cell of this size (deg)")
    p_as.add_argument("--var-loc", action="append", default=None,
                      metavar="OBSVAR:STATEVAR=F",
                      help="cross-variable localization factor "
                           "(repeatable; e.g. --var-loc T2m:PS=0.0)")
    p_as.add_argument("--rtps", type=float, default=0.0,
                      help="RTPS posterior relaxation alpha (Whitaker & "
                           "Hamill 2012)")
    p_as.add_argument("--rtpp", type=float, default=0.0,
                      help="RTPP posterior relaxation alpha (Zhang et al. "
                           "2004); exclusive with --rtps")
    p_as.add_argument("--fast-geometry", action="store_true")
    p_as.add_argument("--mxu-bf16", action="store_true",
                      help="bf16 inputs (f32 accumulation) on the two "
                           "large products of the B2, B2h and B3 body "
                           "kernels, on every device")
    p_as.add_argument("--matmul-precision", default=None,
                      choices=["default", "high", "highest", "bfloat16",
                               "tensorfloat32", "float32"],
                      help="the body kernels' two large products on CUDA: "
                           "highest / float32 (or unset) fp32, high / "
                           "tensorfloat32 TF32, default / bfloat16 bf16 "
                           "tensor cores; every other product, and the "
                           "CPU, fp32")
    p_as.add_argument("--taps-topk", default="exact",
                      choices=["exact", "approx"],
                      help="forward-operator nearest-point candidate "
                           "selection (both run the exact top-k here)")
    p_as.add_argument("--taps-search", default="auto",
                      choices=["auto", "device"],
                      help="nearest-point search: auto resolves separable "
                           "lat x lon grids host-side (exact, certified, "
                           "no device dispatch); device forces the full "
                           "on-device search")
    p_as.add_argument("--letkf-topk", default="exact",
                      choices=["exact", "approx", "host"],
                      help="LETKF nearest-k obs selection primitive "
                           "(host: exact via kd-tree-certified candidate "
                           "sets, cached per obs network)")
    p_as.add_argument("--letkf-k-obs", type=int, default=64,
                      help="max observations per LETKF local solve")
    p_as.add_argument("--letkf-patch-size", type=int, default=1,
                      help="grid points sharing one LETKF solve (1 = "
                           "textbook per-point weights)")
    p_as.add_argument("--dtype", default="float32",
                      choices=["float32", "float64"])
    p_as.add_argument("--mesh", action="store_true",
                      help="shard over all visible devices")
    p_as.add_argument("--verbose", action="store_true")
    _add_device(p_as)
    p_as.set_defaults(func=cmd_assimilate)

    p_tg = sub.add_parser(
        "target",
        help="score candidate obs by predicted forecast-metric impact "
             "(ensemble sensitivity / observation targeting)",
    )
    p_tg.add_argument("--state", required=True, help="prior state netCDF")
    p_tg.add_argument("--obs", required=True,
                      help="candidate obs CSV or netCDF")
    p_tg.add_argument("--out", required=True, help="impact table CSV path")
    p_tg.add_argument("--metric-var", default=None,
                      help="metric variable (default: first state var)")
    p_tg.add_argument("--metric-time-index", type=int, default=None,
                      help="validtime index of the metric (default: all)")
    p_tg.add_argument("--metric-lat-range", type=float, nargs=2,
                      default=None, metavar=("LAT0", "LAT1"))
    p_tg.add_argument("--metric-lon-range", type=float, nargs=2,
                      default=None, metavar=("LON0", "LON1"))
    p_tg.add_argument("--nselect", type=int, default=0,
                      help="greedy network design: pick N obs sequentially "
                           "(0 = rank all candidates independently)")
    p_tg.add_argument("--dtype", default="float64",
                      choices=["float32", "float64"])
    _add_device(p_tg)
    p_tg.set_defaults(func=cmd_target)

    p_vf = sub.add_parser(
        "verify",
        help="observation-space verification of a prior/posterior pair "
             "(per-ob table, Desroziers, rank histogram, CRPS)",
    )
    p_vf.add_argument("--prior", required=True, help="prior state netCDF")
    p_vf.add_argument("--post", required=True, help="posterior state netCDF")
    p_vf.add_argument("--obs", required=True,
                      help="obs CSV or netCDF (ideally the --obs-out file "
                           "from `assimilate`, which carries per-ob "
                           "outcomes)")
    p_vf.add_argument("--stats", default=None,
                      help="write the per-ob table to this CSV")
    p_vf.add_argument("--dtype", default="float64",
                      choices=["float32", "float64"])
    _add_device(p_vf)
    p_vf.set_defaults(func=cmd_verify)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
