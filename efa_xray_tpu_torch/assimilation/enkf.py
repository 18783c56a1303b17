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

``method="blocked"`` is the two-phase form: the tail scan, then the body
in blocks with the apply rows ``z = ye - eps`` (correction Gram ``Z
Ye^T``).  The JAX package runs both in plain XLA (the tail a ``lax.scan``),
with no Pallas kernel.  Here the blocked update takes a route as the
EnSRF's ``FlatRoute`` does (:func:`enkf_route`): on float32 (and on CPU
tensors, where the kernels' plain versions run) the tail goes panel by
panel through B1e, the rows outside a panel and then the body through B2e
(``fast_geometry`` or unlocalized, no ``variable_localization``) or B4e
(everywhere else), the EnKF instantiations of B1, B2 and B4
(:mod:`efa_xray_tpu_torch.ops`), which apply ``z`` and take ``Z Y^T`` as
their Gram (:func:`enkf_kernel_update`).  float64 on the card takes the
plain route, :func:`enkf_blocked`: the per-ob :func:`enkf_tail_scan` and
``ensrf_core.ensrf_blocked_body``, the reference the kernel route is held
against.  ``method="serial"`` is the literal per-ob loop.

JAX's threefry stream cannot be matched: the draws come from a
``torch.Generator`` on the filter's device seeded with ``seed``, centred
and (by default) rescaled to the exact variance, as in the JAX package.
Given the same draws, the two packages give the same analysis.
"""

from __future__ import annotations

from typing import Optional

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
    _ob_weights,
    _ye_var,
    enkf_tail_scan,
)
from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.observation.localization import latlon_to_unit
from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid
from efa_xray_tpu_torch.utils import profiling


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
        w_b = _ob_weights(body_lat, body_lon, body_xyz, bvert, obs, i,
                          localize, fast_geometry, vertical, dtype)
        w_t = _ob_weights(obs_raw.lats, obs_raw.lons, tail_xyz, obs.verts,
                          obs, i, localize, fast_geometry, vertical, dtype)
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


def enkf_route(method: str, localize: bool, fast_geometry: bool,
               use_vl: bool, device, dtype) -> str:
    """The route of an EnKF update: ``"serial"``, ``"plain"``
    (:func:`enkf_blocked`; float64 on the card, as the EnSRF's), ``"B2"``
    (B1e tail, B2e body: ``fast_geometry`` or unlocalized, no varloc) or
    ``"B4"`` (B1e tail, B4e body: exact haversine or varloc).  The tail's
    out-of-panel apply takes the body's kernel
    (``ensrf_core.tail_apply_route``)."""
    if method != "blocked":
        return "serial"
    if torch.device(device).type == "cuda" and dtype != torch.float32:
        return "plain"
    return core.tail_apply_route(localize, fast_geometry, use_vl, False)


def enkf_kernel_body(route: str, body_mean, body_perts, body_lat, body_lon,
                     tail: TailSolution, obs: ObsArrays,
                     localize: bool = True, block_size: int = 128,
                     fast_geometry: bool = False, body_vert=None,
                     vertical: bool = False, cull: bool = True, varloc=None,
                     row_var=None, ob_var=None):
    """Phase 2 on ``route``: the body through B2e (``"B2"``) or B4e
    (``"B4"``, the rows a flat state, ``varloc`` a per-(ob, row) factor)
    against the tail's ``apply_rows``, in fp32 products (the EnKF takes no
    product mode).  The prior is not updated in place."""
    if route == "B2":
        return ensrf_fused.fused_body(
            body_mean, body_perts, body_lat, body_lon, tail, obs,
            body_vert=body_vert if vertical else None, localize=localize,
            block_size=block_size, vertical=vertical, cull=cull,
            apply_rows=tail.apply_rows)
    vkw = (dict(varloc=varloc, row_var=row_var, ob_var=ob_var)
           if varloc is not None else {})
    return ensrf_grid.blocked_body(
        body_mean, body_perts, body_lat, body_lon, tail, obs,
        localize=localize, block_size=block_size,
        fast_geometry=fast_geometry, body_vert=body_vert, vertical=vertical,
        apply_rows=tail.apply_rows, **vkw)


def enkf_kernel_update(route: str, body_mean, body_perts, tail_mean,
                       tail_perts, body_lat, body_lon, obs: ObsArrays, eps,
                       localize: bool = True, unbiased: bool = False,
                       fast_geometry: bool = False, body_vert=None,
                       vertical: bool = False, block_size: int = 128,
                       panel: int = 512, cull: bool = True, varloc=None,
                       row_var=None, ob_var=None):
    """The blocked EnKF on the kernel route ``route`` (:func:`enkf_route`):
    the tail ``panel`` obs at a time through B1e and the rows outside each
    panel through B2e or B4e (``ensrf_core.tail_scan_blocked(kernels=True,
    eps=eps)``, the solution carrying ``z`` as ``apply_rows``), then
    :func:`enkf_kernel_body`.  Equal to :func:`enkf_blocked` up to fp
    reassociation; ``(body_mean, body_perts, tail_mean, tail_perts,
    diags)``."""
    vkw = dict(varloc=varloc, ob_var=ob_var) if varloc is not None else {}
    tail = core.tail_scan_blocked(
        tail_mean, tail_perts, obs, localize=localize, unbiased=unbiased,
        fast_geometry=fast_geometry, vertical=vertical, panel=panel,
        kernels=True, eps=eps, **vkw)
    bm, bp = enkf_kernel_body(
        route, body_mean, body_perts, body_lat, body_lon, tail, obs,
        localize=localize, block_size=block_size,
        fast_geometry=fast_geometry, body_vert=body_vert, vertical=vertical,
        cull=cull, varloc=varloc, row_var=row_var, ob_var=ob_var)
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
    analysis does not depend on the mesh.  The update takes
    :func:`enkf_route`'s route; ``matmul_precision`` and ``mxu_bf16`` leave
    it in fp32."""

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

    @profiling.spanned(profiling.ENTRY_UPDATE)
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
        vl = self.varloc_kwargs()
        kw = dict(localize=cfg.localize, unbiased=cfg.unbiased_variance,
                  fast_geometry=cfg.fast_geometry, body_vert=body_vert,
                  vertical=vertical, **vl)
        route = enkf_route(cfg.method, cfg.localize, cfg.fast_geometry,
                           bool(vl), self.device, dtype)
        if self.mesh is not None:
            from efa_xray_tpu_torch.parallel.sharded import (
                enkf_update_sharded,
            )

            bm, bp, _, _, diags = enkf_update_sharded(
                body_mean, body_perts, tail_mean, tail_perts, body_lat,
                body_lon, obs, eps, mesh=self.mesh, method=cfg.method,
                block_size=cfg.block_size, tail_panel=cfg.tail_panel,
                cull=cfg.cull, **kw)
        elif route in ("B2", "B4"):
            bm, bp, _, _, diags = enkf_kernel_update(
                route, body_mean, body_perts, tail_mean, tail_perts,
                body_lat, body_lon, obs, eps, block_size=cfg.block_size,
                panel=cfg.tail_panel, cull=cfg.cull, **kw)
        elif route == "plain":
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
