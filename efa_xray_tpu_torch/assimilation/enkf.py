"""Stochastic (perturbed-observation) EnKF in torch.

Counterpart of ``efa_xray_tpu/assimilation/enkf.py``:
``draw_ob_perturbations`` :52, ``enkf_serial`` :74, ``enkf_tail_scan``
:211, ``enkf_blocked`` :328 and the ``EnKF`` class :363 (RTPS/RTPP
:431-437, :505-511; adaptive-inflation learning :514).  Each member
assimilates a perturbed observation ``y + eps_m`` with the full Kalman
gain (Burgers, van Leeuwen & Evensen 1998)::

    x_m <- x_m + K (y + eps_m - H x_m),   eps_m ~ N(0, R)

so the perturbation update is ``Xa' = Xb' - K (ye - eps)`` with centred
perturbations ``eps`` and no square-root ``beta`` factor.

``method="blocked"`` is the two-phase form: the per-ob tail scan, then
the body in blocks through ``ensrf_core.ensrf_blocked_body`` with the
apply rows ``z = ye - eps`` (correction Gram ``Z Ye^T``).  The JAX package
runs it in plain XLA, with no Pallas kernel; here it runs as plain torch
on every device.  The body kernels B2-B4 never serve it: their Gram is the
symmetric ``Y Y^T`` and they apply ``Y``.  ``method="serial"`` is the
literal per-ob loop.

JAX's threefry stream cannot be matched: the draws come from a
``torch.Generator`` on the filter's device seeded with ``seed``, centred
and (by default) rescaled to the exact variance, as in the JAX package.
Given the same draws, the two packages give the same analysis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from efa_xray_tpu_torch.assimilation import ensrf_core as core
from efa_xray_tpu_torch.assimilation.adaptive_inflation import (
    row_spread,
    rtpp,
    rtps,
)
from efa_xray_tpu_torch.assimilation.assimilation import Assimilation
from efa_xray_tpu_torch.assimilation.ensrf_core import (
    ObsArrays,
    ObsDiagnostics,
    TailSolution,
    _cast_obs,
    _empty_diags,
    _loc_weights,
    _ye_var,
)
from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.observation.localization import latlon_to_unit


def draw_ob_perturbations(seed: int, errors: torch.Tensor, nmems: int,
                          scale: bool = True) -> torch.Tensor:
    """Centred observation perturbations ``[nobs, M]`` on the device and
    in the dtype of ``errors``, drawn from a ``torch.Generator`` seeded
    with ``seed``.

    ``eps ~ N(0, R)`` per ob row, centred so the perturbed-ob mean is the
    ob itself; ``scale=True`` rescales each row so its ddof=1 sample
    variance is exactly ``R``.
    """
    nobs = errors.shape[0]
    gen = torch.Generator(device=errors.device).manual_seed(int(seed))
    eps = torch.randn((nobs, nmems), generator=gen, dtype=errors.dtype,
                      device=errors.device)
    eps = eps - eps.mean(dim=1, keepdim=True)
    if scale:
        sd = torch.std(eps, dim=1, correction=1, keepdim=True)
        eps = eps / torch.clamp(sd, min=1e-30)
    return eps * torch.sqrt(errors)[:, None]


def _weights(rows_lat, rows_lon, rows_xyz, rows_vert, ob: ObsArrays, i: int,
             localize: bool, fast_geometry: bool, vertical: bool, dtype):
    """Ob ``i``'s localization weights on a set of rows (None when off)."""
    vkw = (dict(row_vert=rows_vert, ob_vert=ob.verts[i],
                vert_radius=ob.vert_radii[i])
           if (localize and vertical) else {})
    if localize and fast_geometry:
        ob_xyz = latlon_to_unit(ob.lats[i], ob.lons[i]).to(dtype)
        return _loc_weights(None, None, None, None, ob.radii[i], True, dtype,
                            row_xyz=rows_xyz, ob_xyz=ob_xyz, **vkw)
    return _loc_weights(rows_lat, rows_lon, ob.lats[i], ob.lons[i],
                        ob.radii[i], localize, dtype, **vkw)


def enkf_serial(body_mean, body_perts, tail_mean, tail_perts, body_lat,
                body_lon, obs: ObsArrays, eps, localize: bool = True,
                unbiased: bool = False, fast_geometry: bool = False,
                body_vert=None, vertical: bool = False, varloc=None,
                row_var=None, ob_var=None):
    """Serial perturbed-obs EnKF, one observation at a time over body and
    tail: :func:`ensrf_core.ensrf_serial`'s structure with the full gain
    applied to ``ye - eps``.  Returns ``(body_mean, body_perts, tail_mean,
    tail_perts, diags)``."""
    nens = body_perts.shape[1]
    dtype = body_perts.dtype
    device = body_perts.device
    nobs = obs.values.shape[0]
    if nobs == 0:
        return (body_mean, body_perts, tail_mean, tail_perts,
                _empty_diags(dtype, device))
    use_vl = varloc is not None
    if use_vl:
        if row_var is None or ob_var is None:
            raise ValueError("varloc needs row_var and ob_var")
        vl = varloc.to(dtype)
        rvar = row_var.long()
        ovar_all = ob_var.long()
    body_xyz = tail_xyz = None
    if localize and fast_geometry:
        body_xyz = latlon_to_unit(body_lat, body_lon).to(dtype)
        tail_xyz = latlon_to_unit(obs.lats, obs.lons).to(dtype)
    obs_raw = obs.with_default_verts()
    obs = _cast_obs(obs, dtype)
    vert_on = localize and vertical
    bvert = body_vert.to(dtype) if vert_on else None
    eps = eps.to(dtype)

    bm, bp, tm, tp = body_mean, body_perts, tail_mean, tail_perts
    pm, pv, om, ov = [], [], [], []
    nan = torch.tensor(float("nan"), dtype=dtype, device=device)
    for i in range(nobs):
        ye, mye, varye, innov, _, scale, _ = core._serial_step_scalars(
            tp, tm, i, obs.values, obs.errors, nens, unbiased)
        kcov_b = bp @ ye
        kcov_t = tp @ ye
        w_b = _weights(body_lat, body_lon, body_xyz, bvert, obs, i, localize,
                       fast_geometry, vertical, dtype)
        w_t = _weights(obs_raw.lats, obs_raw.lons, tail_xyz, obs.verts, obs,
                       i, localize, fast_geometry, vertical, dtype)
        if localize:
            kcov_b = kcov_b * w_b
            kcov_t = kcov_t * w_t
        if use_vl:
            fr = vl[ovar_all[i]]
            kcov_b = kcov_b * fr[rvar]
            kcov_t = kcov_t * fr[ovar_all]
        kmat_b = kcov_b * scale
        kmat_t = kcov_t * scale
        # Mean: the EnSRF's Kalman update.  Perturbations: the full gain
        # applied to the perturbed-ob departures (Burgers et al. eq. 10).
        z = ye - eps[i]
        a = obs.assim[i]
        bm = torch.where(a, bm + kmat_b * innov, bm)
        tm = torch.where(a, tm + kmat_t * innov, tm)
        bp = torch.where(a, bp - kmat_b[:, None] * z[None, :], bp)
        tp = torch.where(a, tp - kmat_t[:, None] * z[None, :], tp)
        pm.append(mye)
        pv.append(varye)
        om.append(torch.where(a, tm[i], nan))
        ov.append(torch.where(a, _ye_var(tp[i], unbiased), nan))
    diags = ObsDiagnostics(torch.stack(pm), torch.stack(pv), torch.stack(om),
                           torch.stack(ov), obs.assim)
    return bm, bp, tm, tp, diags


def enkf_tail_scan(tail_mean, tail_perts, obs: ObsArrays, eps,
                   localize: bool = True, unbiased: bool = False,
                   fast_geometry: bool = False, vertical: bool = False,
                   varloc=None, ob_var=None) -> Tuple[TailSolution,
                                                      torch.Tensor]:
    """The stochastic EnKF on the observation-space tail only: the exact
    ``ye`` sequence, the per-ob coefficients (``gain_coef = innov *
    scale``, ``sqrt_coef = scale``: the full gain, no beta) and the
    perturbed-ob departure rows ``z = ye - eps`` the blocked body applies.
    Returns ``(TailSolution, z)``."""
    nens = tail_perts.shape[1]
    dtype = tail_perts.dtype
    device = tail_perts.device
    nobs = obs.values.shape[0]
    if nobs == 0:
        zc = torch.zeros((0,), dtype=dtype, device=device)
        rows = torch.zeros((0, nens), dtype=dtype, device=device)
        return TailSolution(ye=rows, gain_coef=zc, sqrt_coef=zc,
                            tail_mean=tail_mean, tail_perts=tail_perts,
                            diags=_empty_diags(dtype, device)), rows
    use_vl = varloc is not None
    if use_vl:
        if ob_var is None:
            raise ValueError("varloc needs ob_var")
        vl = varloc.to(dtype)
        ovar_all = ob_var.long()
    tail_xyz = (latlon_to_unit(obs.lats, obs.lons).to(dtype)
                if (localize and fast_geometry) else None)
    obs_raw = obs.with_default_verts()
    obs = _cast_obs(obs, dtype)
    eps = eps.to(dtype)
    tm, tp = tail_mean, tail_perts
    zero = torch.zeros((), dtype=dtype, device=device)
    nan = torch.tensor(float("nan"), dtype=dtype, device=device)
    ye_rows, z_rows, gains, coefs = [], [], [], []
    pm, pv, om, ov = [], [], [], []
    for i in range(nobs):
        ye, mye, varye, innov, _, scale, _ = core._serial_step_scalars(
            tp, tm, i, obs.values, obs.errors, nens, unbiased)
        kcov_t = tp @ ye
        w_t = _weights(obs_raw.lats, obs_raw.lons, tail_xyz, obs.verts, obs,
                       i, localize, fast_geometry, vertical, dtype)
        if localize:
            kcov_t = kcov_t * w_t
        if use_vl:
            kcov_t = kcov_t * vl[ovar_all[i]][ovar_all]
        kmat_t = kcov_t * scale
        z = ye - eps[i]
        a = obs.assim[i]
        tm = torch.where(a, tm + kmat_t * innov, tm)
        tp = torch.where(a, tp - kmat_t[:, None] * z[None, :], tp)
        ye_rows.append(ye)
        z_rows.append(z)
        gains.append(torch.where(a, innov * scale, zero))
        coefs.append(torch.where(a, scale, zero))
        pm.append(mye)
        pv.append(varye)
        om.append(torch.where(a, tm[i], nan))
        ov.append(torch.where(a, _ye_var(tp[i], unbiased), nan))
    return TailSolution(
        ye=torch.stack(ye_rows), gain_coef=torch.stack(gains),
        sqrt_coef=torch.stack(coefs), tail_mean=tm, tail_perts=tp,
        diags=ObsDiagnostics(torch.stack(pm), torch.stack(pv),
                             torch.stack(om), torch.stack(ov), obs.assim),
    ), torch.stack(z_rows)


def enkf_blocked(body_mean, body_perts, tail_mean, tail_perts, body_lat,
                 body_lon, obs: ObsArrays, eps, localize: bool = True,
                 unbiased: bool = False, fast_geometry: bool = False,
                 body_vert=None, vertical: bool = False,
                 block_size: int = 128, varloc=None, row_var=None,
                 ob_var=None):
    """Blocked two-phase stochastic EnKF: :func:`enkf_tail_scan`, then the
    body in ``block_size`` blocks through the EnSRF's Gram-corrected
    recurrence with the apply rows ``z``.  Equal to :func:`enkf_serial`
    for the same ``eps`` up to fp reassociation."""
    tail, z = enkf_tail_scan(
        tail_mean, tail_perts, obs, eps, localize=localize,
        unbiased=unbiased, fast_geometry=fast_geometry, vertical=vertical,
        varloc=varloc, ob_var=ob_var)
    bm, bp = core.ensrf_blocked_body(
        body_mean, body_perts, body_lat, body_lon, tail, obs,
        localize=localize, block_size=block_size,
        fast_geometry=fast_geometry, body_vert=body_vert, vertical=vertical,
        apply_rows=z, varloc=varloc, row_var=row_var, ob_var=ob_var)
    return bm, bp, tail.tail_mean, tail.tail_perts, tail.diags


class EnKF(Assimilation):
    """``EnKF(state, obs, config=..., seed=..., device=...).update()``
    returns ``(posterior_state, observations)`` like
    :class:`~efa_xray_tpu_torch.assimilation.ensrf.EnSRF`.  The arguments
    and their defaults are the JAX package's (``enkf.py:373-384``), plus
    ``device`` (the state's by default).  ``seed`` fixes the perturbation
    draw; ``scale_perturbations`` the variance-exact rescale.  ``mesh=``
    splits the body over the mesh's devices with the tail and the draws
    replicated (``parallel.sharded.enkf_update_sharded``), so the
    analysis does not depend on the mesh."""

    def __init__(self, state, obs, inflation=None, verbose: bool = True,
                 loc=False, config: Optional[FilterConfig] = None,
                 seed: int = 0, scale_perturbations: bool = True, mesh=None,
                 device=None):
        if config is None:
            config = FilterConfig(
                localization="GC" if loc not in (None, False) else None,
                verbose=verbose)
        super().__init__(state, obs, inflation=inflation, verbose=verbose,
                         config=config, device=device, mesh=mesh)
        self.seed = int(seed)
        self.scale_perturbations = bool(scale_perturbations)

    def update(self):
        """Assimilate all observations; return ``(posterior,
        observations)`` with the observations in the caller's order."""
        cfg = self.config
        if cfg.hybrid_alpha < 1.0:
            raise ValueError(
                "hybrid covariance (hybrid_alpha < 1) is implemented for "
                "the EnSRF solver only; the stochastic EnKF would silently "
                "ignore the static-B blend")
        if self.verbose:
            self.log.info("Beginning stochastic EnKF update sequence")
        body_mean, body_perts, tail_mean, tail_perts = self.format_prior_state()
        obs = self.obs_arrays()
        obs = self.apply_outlier_check(obs, tail_mean, tail_perts)
        dtype = self.dtype
        st = self.prior.structure
        body_lat, body_lon = st.row_latlon_device(dtype, self.device)
        vertical = cfg.localize and self._vertical_active()
        body_vert = (torch.tensor(st.row_vert(), dtype=dtype,
                                  device=self.device) if vertical else None)
        prior_spread = row_spread(body_perts) if cfg.rtps_alpha > 0.0 else None
        # Neither method updates the prior in place: a reference suffices.
        prior_perts = body_perts if cfg.rtpp_alpha > 0.0 else None
        eps = draw_ob_perturbations(self.seed, obs.errors.to(dtype),
                                    st.nmems, scale=self.scale_perturbations)
        kw = dict(localize=cfg.localize, unbiased=cfg.unbiased_variance,
                  fast_geometry=cfg.fast_geometry, body_vert=body_vert,
                  vertical=vertical, **self.varloc_kwargs())
        if self.mesh is not None:
            from efa_xray_tpu_torch.parallel.sharded import (
                enkf_update_sharded,
            )

            bm, bp, _, _, diags = enkf_update_sharded(
                body_mean, body_perts, tail_mean, tail_perts, body_lat,
                body_lon, obs, eps, mesh=self.mesh, method=cfg.method,
                block_size=cfg.block_size, **kw)
        elif cfg.method == "blocked":
            bm, bp, _, _, diags = enkf_blocked(
                body_mean, body_perts, tail_mean, tail_perts, body_lat,
                body_lon, obs, eps, block_size=cfg.block_size, **kw)
        else:
            bm, bp, _, _, diags = enkf_serial(
                body_mean, body_perts, tail_mean, tail_perts, body_lat,
                body_lon, obs, eps, **kw)
        if prior_spread is not None:
            bp = rtps(prior_spread, bp, cfg.rtps_alpha)
        if prior_perts is not None:
            bp = rtpp(prior_perts, bp, cfg.rtpp_alpha)
        self.record_diagnostics(diags)
        self.maybe_update_adaptive_inflation()
        self.post, _ = self.format_posterior_state(bm, bp)
        return self.post, self.obs
