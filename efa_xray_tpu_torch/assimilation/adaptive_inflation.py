"""Adaptive covariance inflation (Anderson 2009) and posterior relaxation.

Counterpart of ``efa_xray_tpu/assimilation/adaptive_inflation.py``:
``_anderson_update`` :54, ``_log_posterior`` :96, ``_anderson_sd_update``
:109, ``update_inflation_rows`` :139 (one step per ob, in caller order: a
Python loop over tensor ops where the JAX package scans),
``build_obs_coloring`` :245 (host NumPy/SciPy, copied),
``update_inflation_rows_colored`` :346, ``pack_color_tables`` :414, the
``AdaptiveInflation`` class :442 and ``row_spread`` / ``rtps`` / ``rtpp``
:649-705.

The inflation field is a variance multiplier lambda per state point with
two moments (mean, std), learned from the innovations: for an ob with
innovation d, prior obs-space variance s^2, error variance r^2 and
localization weight gamma at a point, the posterior mode of lambda is the
root of a quadratic closest to the prior mean, and with ``evolve_sd`` the
std is refit from the posterior density one prior std above the mode,
never growing and floored at ``sd_min``.

The colored form updates every ob of one color at once: same-colored obs
have disjoint Gaspari-Cohn supports, so their sequential updates touch
disjoint points and commute.  Its result equals the per-ob scan in the
color order (colors ascending, caller order within a color), which is not
the caller's order.  Each point takes the attributes of its covering ob
by an index gather, where the JAX package multiplies by a one-hot matrix
(a Mosaic workaround).

The learned fields stay NumPy float64 on the host, as in the JAX package;
the updates run in float64 on the device they are given (the filter's).
Four faults of the JAX package are not copied: its posterior-mode root
``(-b +- sqrt(b^2 - 4c)) / 2`` cancels where ``|b|`` is huge (an ob at the
edge of its support, gamma ~ 1e-15, gives lambda errors of 0.1-0.5 in
float64), which the port evaluates without cancellation (see
:func:`_anderson_update`); a radius-0 ob weighs 0 in the colored form as
in the scan (the JAX package's colored form treats it as unlocalized);
the coloring cache evicts its oldest entry after it caches a ``None``
too; and an empty batch is a no-op.  The file forms are the JAX
package's (``_load`` and ``save_to_disk`` :472-500, through the port's
copy of ``utils/ncio.py``), with one fault not copied: the JAX constructor
catches every exception of ``_load`` and quietly builds fresh fields, so
an existing file of other variables restarts the learned inflation from
its initial values, and ``_load`` checks no shape, so a file of another
grid gives fields of the wrong shape.  The port builds fresh fields only
where the file does not exist; an existing file that does not fit the
state raises.
"""

from __future__ import annotations

import collections
import hashlib
import math
import os

import numpy as np
import torch

from efa_xray_tpu_torch.observation.localization import (
    gaspari_cohn,
    haversine,
)
from efa_xray_tpu_torch.state.ensemble import EnsembleState, default_device
from efa_xray_tpu_torch.utils import ncio, timeutil

_SQRT_2PI = math.sqrt(2.0 * math.pi)


def _clip(x, lo, hi):
    """``jnp.clip``: ``min(max(x, lo), hi)`` for scalar or tensor bounds."""
    return torch.minimum(torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                                          device=x.device)),
                         torch.as_tensor(hi, dtype=x.dtype, device=x.device))


def _anderson_update(lam_mean, lam_sd, gamma, innov2, sigma_p2, sigma_o2,
                     lambda_min=1.0, lambda_max=1e6):
    """One ob's Bayesian update of the inflation mean at every point:
    ``lam_mean`` and ``gamma`` per point, the rest scalars or per point
    (the colored form gathers them per point)."""
    sqrt_lam = torch.sqrt(torch.clamp(lam_mean, min=1e-12))
    lam_loc = (1.0 + gamma * (sqrt_lam - 1.0)) ** 2
    theta2 = lam_loc * sigma_p2 + sigma_o2
    theta = torch.sqrt(theta2)
    # Gaussian likelihood of the innovation and its lambda-derivative.
    l_bar = torch.exp(-0.5 * innov2 / theta2) / (_SQRT_2PI * theta)
    dtheta_dlam = (0.5 * gamma * sigma_p2 * (1.0 + gamma * (sqrt_lam - 1.0))
                   / (theta * sqrt_lam))
    l_prime = l_bar * (innov2 / theta2 - 1.0) / theta * dtheta_dlam
    # Posterior mode: the root of lambda^2 + b lambda + c closest to the
    # prior mean.  Where l' is tiny (gamma near 0 at the edge of a support,
    # or an innovation at one expected std) |b| is huge and the root near
    # the prior mean cancels in (-b +- sq) / 2; it is taken as c / q from
    # the other root q (r1 r2 = c) instead.
    safe = torch.abs(l_prime) > 1e-30
    lp = torch.where(safe, l_prime, torch.ones_like(l_prime))
    b = l_bar / lp - 2.0 * lam_mean
    c = lam_mean ** 2 - lam_sd ** 2 - l_bar * lam_mean / lp
    disc_raw = b ** 2 - 4.0 * c
    sq = torch.sqrt(torch.clamp(disc_raw, min=0.0))
    pos = b >= 0.0
    q = -0.5 * (b + torch.where(pos, sq, -sq))
    other = torch.where(disc_raw > 0.0, c / q, q)
    r1 = torch.where(pos, other, q)  # (-b + sq) / 2
    r2 = torch.where(pos, q, other)  # (-b - sq) / 2
    new_lam = torch.where(torch.abs(r1 - lam_mean) < torch.abs(r2 - lam_mean),
                          r1, r2)
    new_lam = torch.where(safe & (gamma > 0.0), new_lam, lam_mean)
    return _clip(new_lam, lambda_min, lambda_max)


def _log_posterior(lam, lam_prior, lam_sd, gamma, innov2, sigma_p2,
                   sigma_o2):
    """Unnormalized log posterior density of lambda given one innovation:
    ``log N(d; 0, theta^2(lambda)) + log N(lambda; prior, sd^2)``."""
    sqrt_lam = torch.sqrt(torch.clamp(lam, min=1e-12))
    theta2 = (1.0 + gamma * (sqrt_lam - 1.0)) ** 2 * sigma_p2 + sigma_o2
    log_l = -0.5 * (torch.log(theta2) + innov2 / theta2)
    sd2 = torch.clamp(lam_sd, min=1e-12) ** 2
    return log_l - 0.5 * (lam - lam_prior) ** 2 / sd2


def _anderson_sd_update(lam_post, lam_prior, lam_sd, gamma, innov2,
                        sigma_p2, sigma_o2, sd_min=0.0):
    """Anderson (2009) section 4 Gaussian refit of the inflation std at the
    posterior mode ``lam_post``: ``sd^2 / (-2 ln R)`` with ``R`` the
    posterior density ratio one prior std above the mode; never grows,
    floored at ``sd_min``."""
    log_r = (_log_posterior(lam_post + lam_sd, lam_prior, lam_sd, gamma,
                            innov2, sigma_p2, sigma_o2)
             - _log_posterior(lam_post, lam_prior, lam_sd, gamma, innov2,
                              sigma_p2, sigma_o2))
    shrinking = log_r < -1e-12
    denom = torch.where(shrinking, -2.0 * log_r, torch.ones_like(log_r))
    sd_new = lam_sd * torch.sqrt(1.0 / denom)
    sd_new = torch.where(shrinking & (gamma > 0.0), sd_new, lam_sd)
    return _clip(sd_new, sd_min, lam_sd)


def _full_sd(lam, lam_sd):
    """The std carried per element with ``evolve_sd``."""
    return torch.broadcast_to(torch.as_tensor(lam_sd, dtype=lam.dtype,
                                              device=lam.device),
                              lam.shape).clone()


def update_inflation_rows(lam, lam_sd, row_lats, row_lons, obs_lats,
                          obs_lons, radii, innovations, prior_vars,
                          ob_err_vars, assim, lambda_min=1.0,
                          lambda_max=1e6, evolve_sd: bool = False,
                          sd_min=0.0):
    """Anderson (2009) update of an inflation field from an obs batch, one
    ob after another in the given order.

    ``lam [..., rows]`` (a flat field, or stacked ``[V, T, G]`` fields with
    a per-variable ``lam_sd [V, 1, 1]``); the per-ob weight ``gamma
    [rows]`` (Gaspari-Cohn of the haversine distance; ``inf`` radius:
    weight 1) broadcasts over the leading axes.  Per-ob inputs are 1-D
    tensors on ``lam``'s device.  With ``evolve_sd`` the std is carried
    per element and refit after every ob, and ``(lam, sd)`` is returned;
    else ``lam``."""
    d2 = innovations ** 2
    sd = _full_sd(lam, lam_sd) if evolve_sd else lam_sd
    for i in range(obs_lats.shape[0]):
        gamma = gaspari_cohn(
            haversine((row_lats, row_lons), (obs_lats[i], obs_lons[i])),
            radii[i])
        new = _anderson_update(lam, sd, gamma, d2[i], prior_vars[i],
                               ob_err_vars[i], lambda_min=lambda_min,
                               lambda_max=lambda_max)
        if evolve_sd:
            new_sd = _anderson_sd_update(new, lam, sd, gamma, d2[i],
                                         prior_vars[i], ob_err_vars[i],
                                         sd_min=sd_min)
            sd = torch.where(assim[i], new_sd, sd)
        lam = torch.where(assim[i], new, lam)
    return (lam, sd) if evolve_sd else lam


# ---------------------------------------------------------------------------
# Colored form
# ---------------------------------------------------------------------------

_COLOR_CACHE: "collections.OrderedDict" = collections.OrderedDict()
COLOR_CACHE_MAX = 8


def _unit(lat, lon):
    la, lo = np.radians(lat), np.radians(lon)
    cl = np.cos(la)
    return np.stack([cl * np.cos(lo), cl * np.sin(lo), np.sin(la)], -1)


def _cache_put(key, value):
    _COLOR_CACHE[key] = value
    while len(_COLOR_CACHE) > COLOR_CACHE_MAX:
        _COLOR_CACHE.popitem(last=False)
    return value


def build_obs_coloring(row_lats, row_lons, obs_lats, obs_lons, radii,
                       max_colors_fraction: float = 0.25,
                       slack_km: float = 2.0, device="cpu"):
    """Host obs coloring and per-(color, row) ob assignment.

    Returns ``(order [No], color_sizes [C], row_ob [C, rows])`` or ``None``
    when coloring cannot help (no obs, a non-finite radius, or more than
    ``max_colors_fraction * No`` colors; the JAX package fails on an empty
    batch).  ``order`` lists the obs colors
    ascending (caller order within a color); ``row_ob[c, g]`` is the index
    within color c's slice of ``order`` of the one same-colored ob whose
    support covers row g, or -1.  ``row_ob`` is an int64 tensor on
    ``device``.  Cached on a digest of the coordinates and radii and on
    the device, so that a stationary network builds once per device and a
    row map built for one device never serves a filter on another."""
    row_lats = np.asarray(row_lats, np.float64)
    row_lons = np.asarray(row_lons, np.float64)
    obs_lats = np.asarray(obs_lats, np.float64)
    obs_lons = np.asarray(obs_lons, np.float64)
    radii = np.asarray(radii, np.float64)
    nobs = obs_lats.shape[0]
    if nobs == 0 or not np.isfinite(radii).all():
        return None
    nrows = row_lats.shape[0]

    h = hashlib.sha1()
    for a in (row_lats, row_lons, obs_lats, obs_lons, radii):
        h.update(np.ascontiguousarray(a).tobytes())
    key = (h.hexdigest(), float(max_colors_fraction), float(slack_km),
           str(torch.device(device)))
    if key in _COLOR_CACHE:
        _COLOR_CACHE.move_to_end(key)
        return _COLOR_CACHE[key]

    from scipy.spatial import cKDTree

    oxyz = _unit(obs_lats, obs_lons)
    tree = cKDTree(oxyz)
    # Two obs conflict when their supports (open disks of radius 2 r)
    # overlap: great-circle distance < 2 (r_i + r_j) (+ slack).
    rmax = float(radii.max())
    ang_i = np.minimum(2.0 * (radii + rmax + slack_km) / 6371.0, np.pi)
    chord_i = 2.0 * np.sin(ang_i / 2.0)
    colors = np.full(nobs, -1, np.int64)
    neigh = tree.query_ball_point(oxyz, chord_i, workers=-1)
    for i in range(nobs):
        used = set()
        for j in neigh[i]:
            if j == i or colors[j] < 0:
                continue
            # the exact pairwise test (the query radius over-approximates)
            dot = float(np.clip(np.dot(oxyz[i], oxyz[j]), -1.0, 1.0))
            reach = 2.0 * (radii[i] + radii[j]) + slack_km
            if 6371.0 * np.arccos(dot) < reach:
                used.add(int(colors[j]))
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    ncolors = int(colors.max()) + 1
    if ncolors > max_colors_fraction * max(nobs, 4):
        return _cache_put(key, None)

    order = np.argsort(colors, kind="stable").astype(np.int64)
    color_sizes = np.bincount(colors, minlength=ncolors)
    # The one covering ob per (color, row), by per-ob support queries on a
    # tree of the rows (a nearest-ob query would mis-assign with mixed
    # radii).
    rtree = cKDTree(_unit(row_lats, row_lons))
    row_ob = np.full((ncolors, nrows), -1, np.int64)
    ang_o = np.minimum((2.0 * radii + slack_km) / 6371.0, np.pi)
    chord_o = 2.0 * np.sin(ang_o / 2.0)
    off = 0
    for c in range(ncolors):
        idx = order[off:off + color_sizes[c]]
        for local, j in enumerate(idx):
            row_ob[c, rtree.query_ball_point(oxyz[j], chord_o[j])] = local
        off += color_sizes[c]
    return _cache_put(key, (order, color_sizes.astype(np.int64),
                            torch.from_numpy(row_ob).to(device)))


def update_inflation_rows_colored(lam, lam_sd, row_lats, row_lons, row_ob,
                                  ob_attrs, ob_use, lambda_min=1.0,
                                  lambda_max=1e6, evolve_sd: bool = False,
                                  sd_min=0.0):
    """The colored form of :func:`update_inflation_rows`: one update of
    the whole field per color.  ``row_ob [C, rows]`` from
    :func:`build_obs_coloring`; ``ob_attrs [C, n_max, 6]`` (lat, lon,
    radius, d^2, prior var, error var) and ``ob_use [C, n_max]`` from
    :func:`pack_color_tables`, as tensors on ``lam``'s device.  Equals the
    per-ob scan over the batch in color order."""
    sd = _full_sd(lam, lam_sd) if evolve_sd else lam_sd
    for c in range(row_ob.shape[0]):
        rob = row_ob[c]
        idx = rob.clamp(min=0)
        g = ob_attrs[c][idx]  # [rows, 6]: each row's covering ob
        covered = (rob >= 0) & ob_use[c][idx]
        radius = g[:, 2]
        # A radius-0 ob weighs 0, as in the scan.
        live = covered & (radius > 0)
        gamma = torch.where(
            live, gaspari_cohn(haversine((row_lats, row_lons),
                                         (g[:, 0], g[:, 1])), radius),
            torch.zeros_like(radius))
        new = _anderson_update(lam, sd, gamma, g[:, 3], g[:, 4], g[:, 5],
                               lambda_min=lambda_min, lambda_max=lambda_max)
        if evolve_sd:
            new_sd = _anderson_sd_update(new, lam, sd, gamma, g[:, 3],
                                         g[:, 4], g[:, 5], sd_min=sd_min)
            sd = torch.where(covered, new_sd, sd)
        lam = torch.where(covered, new, lam)
    return (lam, sd) if evolve_sd else lam


def pack_color_tables(order, color_sizes, obs_lats, obs_lons, radii,
                      innovations, prior_vars, ob_err_vars, assim,
                      dtype=np.float64):
    """Per-color ob tables for :func:`update_inflation_rows_colored`:
    ``(ob_attrs [C, n_max, 6], ob_use [C, n_max])`` NumPy arrays, padding
    all zero and unused."""
    order = np.asarray(order)
    sizes = np.asarray(color_sizes)
    n_max = int(sizes.max())
    ncolors = sizes.shape[0]
    attrs = np.zeros((ncolors, n_max, 6), dtype)
    use = np.zeros((ncolors, n_max), bool)
    cols = np.stack([
        np.asarray(obs_lats, dtype), np.asarray(obs_lons, dtype),
        np.asarray(radii, dtype), np.asarray(innovations, dtype) ** 2,
        np.asarray(prior_vars, dtype), np.asarray(ob_err_vars, dtype),
    ], axis=1)[order]
    am = np.asarray(assim, bool)[order]
    off = 0
    for c in range(ncolors):
        n = int(sizes[c])
        attrs[c, :n] = cols[off:off + n]
        use[c, :n] = am[off:off + n]
        off += n
    return attrs, use


# ---------------------------------------------------------------------------
# The inflation fields
# ---------------------------------------------------------------------------

class AdaptiveInflation:
    """Adaptive inflation state: per-variable (mean, std) fields of shape
    ``[ntimes, ny, nx]`` on the prior's grid, NumPy float64 on the host.
    Updates run on ``device`` (the prior's) unless the caller names
    another; inflation runs on the inflated state's device."""

    def __init__(self, priorstate: EnsembleState, priorinf):
        """``priorinf`` is ``(inftype, infile, initvals)``, as in the
        reference: an existing ``infile`` is loaded (and raises when it
        cannot be read); otherwise uniform fields are built from
        ``initvals = (mean, std)``."""
        if not isinstance(priorstate, EnsembleState):
            raise TypeError("AdaptiveInflation needs an EnsembleState")
        _inftype, infile, initvals = priorinf
        self.structure = priorstate.structure
        self.device = priorstate.device
        if infile is not None and os.path.exists(infile):
            self._load(infile)
        else:
            self.build_initial_inflation(priorstate, initvals)

    @classmethod
    def from_fields(cls, structure, mean: dict, std: dict,
                    device=None) -> "AdaptiveInflation":
        """Fields given as ``{var: [ntimes, ny, nx]}`` arrays (copied to
        float64), e.g. those of the JAX package's ``AdaptiveInflation``
        mid-cycle, updating on ``device``: the card when None (without a
        card a missing ``device`` raises, as ``default_device`` does)."""
        self = cls.__new__(cls)
        self.structure = structure
        self.device = default_device(device)
        shape = (structure.ntimes, structure.ny, structure.nx)
        self.mean, self.std = {}, {}
        for v in structure.var_names:
            self.mean[v] = np.array(mean[v], dtype=np.float64).reshape(shape)
            self.std[v] = np.array(std[v], dtype=np.float64).reshape(shape)
        return self

    def build_initial_inflation(self, priorstate: EnsembleState,
                                initvals) -> None:
        """Uniform initial fields (the reference's
        ``adaptive_inflation.py:32-56``)."""
        s = priorstate.structure
        mean0, std0 = initvals
        shape = (s.ntimes, s.ny, s.nx)
        self.mean = {v: np.full(shape, float(mean0)) for v in s.var_names}
        self.std = {v: np.full(shape, float(std0)) for v in s.var_names}

    def _load(self, infile: str) -> None:
        """The (mean, std) fields of a file :meth:`save_to_disk` wrote:
        each state variable ``[ntimes, ny, nx, 2]``."""
        ds = ncio.read_dataset(infile)
        s = self.structure
        want = (s.ntimes, s.ny, s.nx, 2)
        self.mean, self.std = {}, {}
        for v in s.var_names:
            if v not in ds.variables:
                raise ValueError(f"inflation file {infile!r} has no "
                                 f"variable {v!r}")
            arr = np.asarray(ds[v], dtype=np.float64)
            if arr.shape != want:
                raise ValueError(
                    f"inflation file {infile!r}: {v!r} has shape "
                    f"{arr.shape}, the state needs {want}")
            self.mean[v] = arr[..., 0]
            self.std[v] = arr[..., 1]

    def save_to_disk(self, filename: str = "prior_inflation.nc") -> None:
        """Checkpoint (reference ``adaptive_inflation.py:76-80``): each
        variable ``[validtime, y, x, moment]`` with the mean and std as
        its two moments, validtime in lead hours."""
        s = self.structure
        lead = timeutil.lead_hours(s.times_s, s.times_s[0])
        variables = {
            "validtime": (("validtime",), lead),
            "lat": (("y", "x"), np.asarray(s.lat)),
            "lon": (("y", "x"), np.asarray(s.lon)),
        }
        for v in s.var_names:
            variables[v] = (
                ("validtime", "y", "x", "moment"),
                np.stack([self.mean[v], self.std[v]], axis=-1),
            )
        ds = ncio.NcDataset(
            dims={"validtime": s.ntimes, "y": s.ny, "x": s.nx, "moment": 2},
            variables=variables,
        )
        ncio.write_dataset(filename, ds)

    def mean_field(self) -> np.ndarray:
        """Stacked inflation means, ``[nvars, ntimes, ny, nx]``."""
        return np.stack([self.mean[v] for v in self.structure.var_names])

    def inflate_state(self, priorstate: EnsembleState) -> EnsembleState:
        """Scale the perturbations by ``sqrt`` of the mean field: lambda is
        a variance multiplier (the JAX package's convention, which mends
        the reference's direct multiply)."""
        data = priorstate.data
        factor = torch.sqrt(torch.as_tensor(self.mean_field(),
                                            dtype=data.dtype,
                                            device=data.device))
        mean = data.mean(dim=-1, keepdim=True)
        return priorstate.replace_data(factor[..., None] * (data - mean)
                                       + mean)

    def update_inflation(self, obs_lats, obs_lons, obs_radii, innovations,
                         prior_vars, ob_err_vars, assimilated=None,
                         lambda_min: float = 1.0, lambda_max: float = 1e6,
                         lambda_sd_floor: float = 1e-4,
                         evolve_sd: bool = False, sd_min: float = 0.05,
                         damp: float = 1.0, device=None) -> None:
        """Anderson (2009) update of the mean fields (and with
        ``evolve_sd`` the std fields) from a batch of innovations, given
        as 1-D host arrays over the batch.  Runs the colored form when
        every radius is finite and the supports color sparsely, else the
        per-ob scan in the batch's order.  ``damp < 1`` relaxes the new
        mean toward 1 (DART's damping).  On ``device``, the instance's
        unless given."""
        dev = self.device if device is None else torch.device(device)
        s = self.structure
        f64 = torch.float64
        t = lambda x: torch.as_tensor(np.array(x, np.float64), dtype=f64,
                                      device=dev)
        nvars = len(s.var_names)
        lam = t(self.mean_field().reshape(nvars, s.ntimes, s.ny * s.nx))
        stacked_sd = np.stack([self.std[v] for v in s.var_names])
        if evolve_sd:
            lam_sd = t(np.maximum(
                stacked_sd.reshape(nvars, s.ntimes, s.ny * s.nx),
                lambda_sd_floor))
        else:
            lam_sd = t([max(float(np.mean(self.std[v])), lambda_sd_floor)
                        for v in s.var_names]).reshape(nvars, 1, 1)
        mask = (np.ones(len(np.asarray(obs_lats)), dtype=bool)
                if assimilated is None
                else np.asarray(assimilated, dtype=bool))
        glat, glon = t(s.lat.ravel()), t(s.lon.ravel())
        kw = dict(lambda_min=lambda_min, lambda_max=lambda_max,
                  evolve_sd=evolve_sd, sd_min=sd_min)
        coloring = build_obs_coloring(s.lat.ravel(), s.lon.ravel(), obs_lats,
                                      obs_lons, obs_radii, device=dev)
        if coloring is not None:
            order, sizes, row_ob = coloring
            attrs, use = pack_color_tables(order, sizes, obs_lats, obs_lons,
                                           obs_radii, innovations,
                                           prior_vars, ob_err_vars, mask)
            out = update_inflation_rows_colored(
                lam, lam_sd, glat, glon, row_ob, t(attrs),
                torch.as_tensor(use, device=dev), **kw)
        else:
            out = update_inflation_rows(
                lam, lam_sd, glat, glon, t(obs_lats), t(obs_lons),
                t(obs_radii), t(innovations), t(prior_vars),
                t(ob_err_vars), torch.as_tensor(mask, device=dev), **kw)
        lam, sd = out if evolve_sd else (out, None)
        if damp < 1.0:
            lam = torch.clamp(1.0 + damp * (lam - 1.0), min=lambda_min)
        mean_out = lam.cpu().numpy().reshape(nvars, s.ntimes, s.ny, s.nx)
        for i, v in enumerate(s.var_names):
            self.mean[v] = mean_out[i]
        if sd is not None:
            sd_out = sd.cpu().numpy().reshape(nvars, s.ntimes, s.ny, s.nx)
            for i, v in enumerate(s.var_names):
                self.std[v] = sd_out[i]


# ---------------------------------------------------------------------------
# Posterior relaxation
# ---------------------------------------------------------------------------


def row_spread(perts):
    """Per-row ensemble spread (ddof 1): ``[rows]`` from ``[rows, M]``."""
    return torch.sqrt(torch.sum(perts ** 2, dim=1) / (perts.shape[1] - 1))


def rtps(prior_spread, post_perts, alpha):
    """Relaxation to prior spread (Whitaker & Hamill 2012): per row,
    ``X_a *= 1 + alpha (sigma_b - sigma_a) / sigma_a``; rows whose
    posterior spread is zero are left as they are.  ``prior_spread`` is
    :func:`row_spread` of the prior perturbations, taken before the
    update."""
    sb = prior_spread
    sa = row_spread(post_perts)
    safe = sa > 0
    factor = torch.where(
        safe, 1.0 + alpha * (sb - sa) / torch.where(safe, sa,
                                                    torch.ones_like(sa)),
        torch.ones_like(sa))
    return post_perts * factor[:, None].to(post_perts.dtype)


def rtpp(prior_perts, post_perts, alpha):
    """Relaxation to prior perturbations (Zhang, Snyder & Sun 2004):
    ``X_a' = (1 - alpha) X_a + alpha X_b``.  ``prior_perts`` must be a copy
    taken before an update that overwrites the prior in place."""
    return ((1.0 - alpha) * post_perts
            + alpha * prior_perts.to(post_perts.dtype))
