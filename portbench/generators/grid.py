"""Generator of ``kind: "grid"``: a global lat-lon grid (``ny`` x ``nx``,
one variable, one time) with a prior ensemble ``field [1, ny, nx, M]``
(float32), and obs at random places.

Obs latitudes are stratified (one in each of ``count`` equal bands, in
shuffled order) and longitudes uniform, so every seed gives the same
number of (ob, row) pairs within reach to within a fraction of a
percent; the seed moves where they fall.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.generate import F32, F64, gen, stratified

CHOICES = {"obs.placement": ("random",)}


def axes(config: dict):
    """``(lat1d, lon1d)`` float64 NumPy axes of the grid."""
    lat0, lat1 = config["lat_range"]
    lat1d = np.linspace(lat0, lat1, config["ny"])
    lon1d = np.arange(config["nx"]) * (360.0 / config["nx"])
    return lat1d, lon1d


def prior(config: dict, seed: int, device):
    p = config["prior"]
    return p["mean"] + p["sd"] * torch.randn(
        1, config["ny"], config["nx"], config["nmems"],
        generator=gen(seed, "prior", device), device=device, dtype=F32)


def make(config: dict, seed: int, device) -> dict:
    ob = config["obs"]
    nobs = int(ob["count"])
    g = gen(seed, "network", device)
    lat1d, lon1d = axes(config)
    glat = torch.tensor(lat1d, dtype=F32, device=device)
    glon = torch.tensor(lon1d, dtype=F32, device=device)
    row_lat = glat[:, None].expand(len(lat1d), len(lon1d)).reshape(-1)
    row_lon = glon[None, :].expand(len(lat1d), len(lon1d)).reshape(-1)
    lat = stratified(nobs, *ob["lat_range"], g, device)
    lat = lat[torch.randperm(nobs, generator=g, device=device)]
    lo0, lo1 = ob["lon_range"]
    lon = lo0 + (lo1 - lo0) * torch.rand(nobs, generator=g, device=device,
                                         dtype=F64)
    return dict(nstate=len(lat1d) * len(lon1d), row_lat=row_lat,
                row_lon=row_lon, ob_lat=lat, ob_lon=lon,
                grid=(lat1d, lon1d))
