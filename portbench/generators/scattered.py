"""Generator of ``kind: "scattered"``: ``nstate`` points drawn uniformly in
latitude and longitude and sorted by Hilbert key (a flat state), with a
prior mean ``bm [N]`` and centred perturbations ``bp [N, M]`` (float32),
and obs at state rows.

Obs rows are stratified along the Hilbert order (one in each of
``count`` equal runs, ascending, so the obs are in Hilbert order too):
every seed gives the same number of (ob, row) pairs within reach to
within a fraction of a percent.
"""

from __future__ import annotations

import torch

from portbench import hilbert
from portbench.generate import F32, F64, gen, stratified

CHOICES = {"row_order": ("hilbert",), "obs.placement": ("state_rows",),
           "obs.order": ("hilbert",)}


def prior(config: dict, seed: int, device):
    p = config["prior"]
    n, m = config["nstate"], config["nmems"]
    g = gen(seed, "prior", device)
    bm = p["mean"] + p["mean_sd"] * torch.randn(n, generator=g,
                                                device=device, dtype=F32)
    bp = torch.randn(n, m, generator=g, device=device, dtype=F32)
    bp.mul_(p["pert_sd"])
    bp.sub_(bp.mean(dim=1, keepdim=True))
    return bm, bp


def make(config: dict, seed: int, device) -> dict:
    nobs = int(config["obs"]["count"])
    nstate = int(config["nstate"])
    g = gen(seed, "network", device)
    la0, la1 = config["lat_range"]
    lo0, lo1 = config["lon_range"]
    row_lat = (la0 + (la1 - la0) * torch.rand(
        nstate, generator=g, device=device, dtype=F64)).to(F32)
    row_lon = (lo0 + (lo1 - lo0) * torch.rand(
        nstate, generator=g, device=device, dtype=F64)).to(F32)
    o = hilbert.order(row_lat, row_lon)
    row_lat, row_lon = row_lat[o].contiguous(), row_lon[o].contiguous()
    del o
    rows = stratified(nobs, 0.0, float(nstate), g, device).floor().to(
        torch.int64).clamp_(0, nstate - 1)
    return dict(nstate=nstate, row_lat=row_lat, row_lon=row_lon,
                ob_lat=row_lat[rows].double(), ob_lon=row_lon[rows].double(),
                ob_rows=rows)
