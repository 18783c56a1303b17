"""Plain reference of one EnSRF update: the serial Whitaker-Hamill filter
in float64 torch, one observation at a time, over an augmented state.

It imports nothing of the program and takes nothing the program made:
geometry, obs priors and localization are worked out again here from
the inputs the benchmark hands to both sides (``portbench.generate``).

* Forward operator (grid states): each ob's ``npt`` nearest grid points
  by great-circle distance, a brute-force search over the whole grid;
  inverse-distance weights, or the nearest point alone when it lies
  within ``exact_km`` (the reference filter's ``ensemble.py:152-200``).
  A scattered state's obs sit at state rows: their priors are those rows.
* Localization: Gaspari-Cohn (1999, eq. 4.10) of the haversine distance
  with the ob's halfwidth; zero beyond twice the halfwidth.
* Update: for each ob in order, the obs prior ``ye`` and its variance
  (``ddof`` 0, as the reference filter's ``np.var``), the localized gain
  ``K = rho (X ye) / ((M - 1) (var + R))``, the mean ``+ K (y - mean(ye))``
  and the perturbations ``- beta K ye^T`` with
  ``beta = 1 / (1 + sqrt(R / (var + R)))``, applied to every row of the
  augmented state (the sampled state rows and every obs prior).

Only the sampled state rows are carried: a row's posterior depends on its
own prior and on the obs-space sequence alone, so a sample of rows is
exact for those rows.
"""

from __future__ import annotations

import torch

F64 = torch.float64
EARTH_RADIUS_KM = 6371.0

# What ``portbench/check.py`` compares of an answer.  Each part's gap is
# taken as a share of what the update changed: the RMS of the difference
# of the two keys of :func:`expected`'s answer that ``SCALES`` gives it.
# A compared number is the widest gap of its parts (``NUMBERS``), or the
# count of entries that differ (``EXACT``).  Means and spreads are kept
# apart because float32 rounding moves them by different amounts; each
# number takes in state and obs parts, so that a control that changes
# the state's body only moves both.
SCALES = dict(
    state_mean=("state_mean", "state_prior_mean"),
    state_perts=("state_perts", "state_prior_perts"),
    prior_mean=("post_mean", "prior_mean"),
    post_mean=("post_mean", "prior_mean"),
    prior_var=("prior_var", "post_var"),
    post_var=("prior_var", "post_var"),
    obs_mean=("obs_mean", "obs_prior_mean"),
    obs_perts=("obs_perts", "obs_prior_perts"))
NUMBERS = dict(
    mean_gap=("state_mean", "prior_mean", "post_mean", "obs_mean"),
    spread_gap=("state_perts", "prior_var", "post_var", "obs_perts"))
EXACT = dict(flag_gaps="assimilated")


def haversine(lat1, lon1, lat2, lon2):
    """Great-circle distance (km), degrees in, float64; broadcasts."""
    p1, p2 = torch.deg2rad(lat1), torch.deg2rad(lat2)
    dlat = p2 - p1
    dlon = torch.deg2rad(lon2 - lon1)
    a = (torch.sin(dlat / 2) ** 2
         + torch.cos(p1) * torch.cos(p2) * torch.sin(dlon / 2) ** 2)
    return EARTH_RADIUS_KM * 2 * torch.atan2(
        torch.sqrt(a), torch.sqrt(torch.clamp(1 - a, min=0.0)))


def gaspari_cohn(dist, halfwidth):
    r = dist / halfwidth
    inner = (((-0.25 * r + 0.5) * r + 0.625) * r - 5.0 / 3.0) * r**2 + 1.0
    rs = torch.where(r > 0, r, torch.ones_like(r))
    outer = (((((rs / 12.0 - 0.5) * rs + 0.625) * rs + 5.0 / 3.0) * rs
              - 5.0) * rs + 4.0 - 2.0 / (3.0 * rs))
    return torch.where(r <= 1.0, inner,
                       torch.where(r < 2.0, outer, torch.zeros_like(r)))


def nearest_taps(grid_lat, grid_lon, ob_lat, ob_lon, npt: int = 4,
                 exact_km: float = 1.0, chunk: int = 64):
    """``(rows [No, npt], weights [No, npt])`` of each ob's ``npt`` nearest
    grid points (``grid_lat``/``grid_lon`` flat, float64)."""
    rows, dists = [], []
    for s in range(0, ob_lat.shape[0], chunk):
        d = haversine(ob_lat[s:s + chunk, None], ob_lon[s:s + chunk, None],
                      grid_lat[None, :], grid_lon[None, :])
        v, i = torch.topk(d, npt, dim=1, largest=False)
        rows.append(i)
        dists.append(v)
    rows, d = torch.cat(rows), torch.cat(dists)
    inv = 1.0 / d
    inv = torch.where(torch.isfinite(inv), inv, torch.zeros_like(inv))
    w = inv / inv.sum(1, keepdim=True)
    near = d.argmin(1)
    onehot = torch.zeros_like(w)
    onehot[torch.arange(w.shape[0], device=w.device), near] = 1.0
    exact = (d < exact_km).any(1, keepdim=True)
    return rows, torch.where(exact, onehot, w)


def serial_update(xm, xp, ym, yp, values, errors, ob_lat, ob_lon, radii,
                  row_lat, row_lon, assim, unbiased: bool = False,
                  chunk: int = 512):
    """The serial update of state rows ``(xm [S], xp [S, M])`` by obs with
    priors ``(ym [No], yp [No, M])``.  ``assim`` is a host sequence of
    bools.  Returns a dict of float64 tensors: the rows' posterior
    ``state_mean``/``state_perts``, the obs' posterior ``obs_mean``/
    ``obs_perts``, and per ob ``prior_mean``/``prior_var`` (at its turn),
    ``post_mean``/``post_var`` (right after it) and ``assimilated``."""
    s, m = xp.shape
    no = ym.shape[0]
    dev = xm.device
    # Column 0 the mean, columns 1..M the perturbations, rows the state
    # sample then the obs.
    a = torch.cat([torch.cat([xm[:, None], xp], 1),
                   torch.cat([ym[:, None], yp], 1)]).to(F64)
    alat = torch.cat([row_lat, ob_lat]).to(F64)
    alon = torch.cat([row_lon, ob_lon]).to(F64)
    w = torch.empty(no, s + no, dtype=F64, device=dev)
    for c in range(0, no, chunk):
        d = haversine(alat[None, :], alon[None, :],
                      ob_lat[c:c + chunk, None], ob_lon[c:c + chunk, None])
        w[c:c + chunk] = gaspari_cohn(d, radii[c:c + chunk, None])
    pre = torch.empty(no, m + 1, dtype=F64, device=dev)
    post = torch.full((no, m + 1), float("nan"), dtype=F64, device=dev)
    ddof = 1 if unbiased else 0
    for i in range(no):
        pre[i] = a[s + i]
        if not assim[i]:
            continue
        ye = pre[i, 1:]
        var = torch.var(ye, correction=ddof)
        kdenom = var + errors[i]
        k = (a[:, 1:] @ ye) * w[i] / ((m - 1) * kdenom)
        a[:, 0] += k * (values[i] - pre[i, 0])
        beta = 1.0 / (1.0 + torch.sqrt(errors[i] / kdenom))
        a[:, 1:].addr_(k * beta, ye, alpha=-1.0)
        post[i] = a[s + i]
    flags = torch.as_tensor(list(assim), dtype=torch.bool, device=dev)
    return dict(
        state_mean=a[:s, 0], state_perts=a[:s, 1:], obs_mean=a[s:, 0],
        obs_perts=a[s:, 1:], prior_mean=pre[:, 0],
        prior_var=torch.var(pre[:, 1:], dim=1, correction=ddof),
        post_mean=post[:, 0],
        post_var=torch.var(post[:, 1:], dim=1, correction=ddof),
        assimilated=flags)


def expected(inputs, k: int, sample):
    """The reference's answer to update ``k`` of a run (values set ``k``)
    at the state rows ``sample``: :func:`serial_update` on the run's
    inputs, with the prior and the obs priors worked out again here: by
    the forward operator on a grid, as the state at the obs' rows where
    the obs sit at state rows."""
    dev = inputs.device
    if inputs.grid is not None:
        field = inputs.prior().reshape(-1, inputs.nmems)
        lat1d, lon1d = inputs.grid
        glat = torch.tensor(lat1d, dtype=F64, device=dev)
        glon = torch.tensor(lon1d, dtype=F64, device=dev)
        glat = glat[:, None].expand(len(lat1d), len(lon1d)).reshape(-1)
        glon = glon[None, :].expand(len(lat1d), len(lon1d)).reshape(-1)
        taps = inputs.config["forward"]
        rows, wts = nearest_taps(glat, glon, inputs.ob_lat, inputs.ob_lon,
                                 npt=taps["npt"],
                                 exact_km=taps["exact_match_km"])
        ye = torch.einsum("okm,ok->om", field[rows].to(F64), wts)
        x = field[sample].to(F64)
        del field
        xm, ym = x.mean(1), ye.mean(1)
        xp, yp = x - xm[:, None], ye - ym[:, None]
        row_lat, row_lon = glat[sample], glon[sample]
    else:
        bm, bp = inputs.prior()
        xm, xp = bm[sample].to(F64), bp[sample].to(F64)
        ym = bm[inputs.ob_rows].to(F64)
        yp = bp[inputs.ob_rows].to(F64)
        del bm, bp
        row_lat = inputs.row_lat[sample].to(F64)
        row_lon = inputs.row_lon[sample].to(F64)
    out = serial_update(
        xm, xp, ym, yp, inputs.value_set(k), inputs.errors, inputs.ob_lat,
        inputs.ob_lon, inputs.radii, row_lat, row_lon,
        [True] * inputs.nobs)
    out["state_prior_mean"], out["state_prior_perts"] = xm, xp
    out["obs_prior_mean"], out["obs_prior_perts"] = ym, yp
    return out
