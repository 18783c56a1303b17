"""Synthetic demo data generators.

Copy of ``efa_xray_tpu/utils/demo_data.py`` (``get_ensemble_point`` :20,
``gefs_like_state`` :53, ``observations_from_truth`` :130), pointed at the
port's classes: ``gefs_like_state`` builds the state on ``device`` (the
card unless the caller names another).  ``get_ensemble_point`` and
``observations_from_truth`` build no tensor (a dict of NumPy arrays, a
list of ``Observation``), so they take no device: whoever builds a state
from them names it (``postprocess.viewer`` takes ``device``).  The rest of
this docstring is the JAX module's.

The reference demo (``efa_demo.ipynb`` cell 6) fetches a live GEFS
point-forecast ensemble from Unidata THREDDS via siphon — impossible
offline and irreproducible besides.  These generators produce statistically
GEFS-like ensembles with known truth, so the demo workflow (and benchmarks)
run hermetically.  ``get_ensemble_point`` mirrors the reference function's
return contract (dict of (ntimes, nens) arrays + datetimes).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from efa_xray_tpu_torch.state.ensemble import EnsembleState


def get_ensemble_point(
    location: Tuple[float, float] = (47.45, -122.31),
    variables: Sequence[str] = ("Temperature_height_above_ground_ens",),
    ntimes: int = 21,
    nens: int = 21,
    start=np.datetime64("2026-08-15T00:00"),
    step_hours: int = 3,
    seed: int = 0,
) -> Dict:
    """Synthetic stand-in for the reference's THREDDS point fetch
    (``efa_demo.ipynb`` cell 6): returns ``{'times': datetime64[nt],
    var: float[nt, nens], ...}`` for a single (lat, lon) point.

    The ensemble is built as truth + AR(1) member perturbations whose
    spread grows with lead time, qualitatively matching a GEFS point
    forecast."""
    rng = np.random.default_rng(seed)
    times = start + np.arange(ntimes) * np.timedelta64(step_hours, "h")
    hours = np.arange(ntimes) * step_hours
    out: Dict = {"times": times, "lat": location[0], "lon": location[1]}
    for k, var in enumerate(variables):
        base = 285.0 + 3.0 * np.sin(2 * np.pi * hours / 24.0 + k) + 0.05 * hours
        spread = 0.5 + 0.08 * hours  # growing ensemble spread
        pert = np.zeros((ntimes, nens))
        pert[0] = rng.normal(0, spread[0], nens)
        for t in range(1, ntimes):
            pert[t] = 0.9 * pert[t - 1] + rng.normal(
                0, spread[t] * np.sqrt(1 - 0.81), nens
            )
        out[var] = base[:, None] + pert
    return out


def gefs_like_state(
    nvars: int = 1,
    ntimes: int = 8,
    ny: int = 33,
    nx: int = 49,
    nmems: int = 21,
    var_names: Sequence[str] = None,
    lat_range: Tuple[float, float] = (24.0, 52.0),
    lon_range: Tuple[float, float] = (230.0, 295.0),
    start=np.datetime64("2026-08-15T00:00"),
    step_hours: int = 6,
    seed: int = 0,
    dtype=None,
    device=None,
) -> Tuple[EnsembleState, np.ndarray]:
    """A CONUS-scale synthetic gridded ensemble with smooth spatially
    correlated errors.  Returns (state, truth[ntimes, ny, nx, nvars]),
    the state on ``device`` (the card when None)."""
    rng = np.random.default_rng(seed)
    names = list(var_names) if var_names else [f"VAR{i}" if i else "T2m" for i in range(nvars)]
    lat1d = np.linspace(*lat_range, ny)
    lon1d = np.linspace(*lon_range, nx)
    lon, lat = np.meshgrid(lon1d, lat1d)
    times = start + np.arange(ntimes) * np.timedelta64(step_hours, "h")
    hours = np.arange(ntimes) * step_hours

    def smooth_noise(shape, n_modes=6):
        """Random low-wavenumber field -> spatially correlated errors."""
        field = np.zeros(shape)
        for _ in range(n_modes):
            ky, kx = rng.uniform(0.5, 3.0, 2)
            phy, phx = rng.uniform(0, 2 * np.pi, 2)
            amp = rng.normal(0, 1.0)
            field += amp * np.sin(
                ky * np.pi * (lat - lat_range[0]) / (lat_range[1] - lat_range[0]) + phy
            ) * np.sin(
                kx * np.pi * (lon - lon_range[0]) / (lon_range[1] - lon_range[0]) + phx
            )
        return field / np.sqrt(n_modes)

    def error_draw():
        """One realization of the (growing-with-lead) forecast error
        process, shape [ntimes, ny, nx]."""
        err0 = smooth_noise((ny, nx))
        return np.stack(
            [
                (0.8 + 0.1 * t) * (err0 + 0.5 * smooth_noise((ny, nx)))
                for t in range(ntimes)
            ]
        )

    truth = np.zeros((ntimes, ny, nx, nvars))
    vardict = {}
    for v, name in enumerate(names):
        base = (
            288.0
            - 0.6 * (lat - lat_range[0])
            + 3.0 * np.cos(np.radians(3 * lon))
            + 10.0 * v
        )
        base = base[None] + 0.15 * hours[:, None, None] + np.stack(
            [smooth_noise((ny, nx)) for _ in range(ntimes)]
        )
        # Calibrated ensemble: the truth is one more exchangeable draw of
        # the same error process the members sample, so ensemble spread
        # matches the ensemble-mean error and assimilation is beneficial.
        truth[..., v] = base + error_draw()
        members = np.zeros((ntimes, ny, nx, nmems))
        for m in range(nmems):
            members[..., m] = base + error_draw()
        vardict[name] = members
    coorddict = {"validtime": times, "lat": lat, "lon": lon, "mem": np.arange(nmems)}
    return EnsembleState.from_vardict(vardict, coorddict, dtype=dtype,
                                      device=device), truth


def observations_from_truth(
    state: EnsembleState,
    truth: np.ndarray,
    nobs: int,
    ob_error: float = 1.0,
    radius: float = 2000.0,
    seed: int = 1,
):
    """Point observations sampled from the truth field at random grid
    points/times, perturbed with N(0, ob_error)."""
    from efa_xray_tpu_torch.observation.observation import Observation

    rng = np.random.default_rng(seed)
    s = state.structure
    obs = []
    for i in range(nobs):
        v = int(rng.integers(0, s.nvars))
        t = int(rng.integers(0, s.ntimes))
        y = int(rng.integers(0, s.ny))
        x = int(rng.integers(0, s.nx))
        obs.append(
            Observation(
                value=float(truth[t, y, x, v] + rng.normal(0, np.sqrt(ob_error))),
                obtype=s.var_names[v],
                time=s.times64()[t],
                error=ob_error,
                lat=float(s.lat[y, x]),
                lon=float(s.lon[y, x]),
                assimilate_this=True,
                localize_radius=radius,
                description=f"synthetic-{i}",
            )
        )
    return obs
