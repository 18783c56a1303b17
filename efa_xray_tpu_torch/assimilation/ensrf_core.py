"""The EnSRF update in plain torch: the reference B1 and B2 are held against.

Counterpart of ``efa_xray_tpu/assimilation/ensrf_core.py``: the tuples
:76-140, ``_ye_var`` :142, ``_loc_weights`` :164, ``ensrf_serial`` :194,
``tail_scan`` :388, ``tail_scan_blocked`` :588 (plain branch and kernel
branch), ``_block_recurrence`` :886, ``apply_obs_block`` :943,
``ensrf_blocked_body`` :990 and ``ensrf_blocked`` :1148.  The module
docstring there derives the exact two-phase (tail, then body in blocks)
reformulation of the serial Whitaker-Hamill filter that these functions
implement.

Vertical localization, cross-variable localization (``varloc``,
``row_var``, ``ob_var``: the factor ``varloc[ob_var, row_var]`` multiplies
the gain like a Gaspari-Cohn weight) and the hybrid ensemble-static
covariance (``hybrid_alpha < 1``, Hamill & Snyder 2000: a fixed column
``sigma_row sigma_ob GC(d, static_length)`` at exact haversine distance
blended into the gain) are ported, and so are the stochastic EnKF's
``apply_rows`` (the rows ``z = ye - eps`` the solved gain columns are
applied against, ``apply_obs_block`` :943-987; refused with hybrid,
:1029-1031).

Every function runs eagerly on the device of its inputs.  The sequential
per-ob loops stay Python loops over tensor ops: they are the plain
reference, not the fast path (the kernels in :mod:`efa_xray_tpu_torch.ops`
are).  No function reads a tensor back to the host inside its loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from efa_xray_tpu_torch.observation.localization import (
    chordal_gc_weights,
    gaspari_cohn,
    haversine,
    latlon_to_unit,
)
from efa_xray_tpu_torch.utils import profiling


class ObsArrays(NamedTuple):
    """Per-observation tensors consumed by the update.

    ``radii = inf`` disables horizontal localization per ob and
    ``vert_radii = inf`` vertical localization (``ensrf_core.py:76-105``).
    """

    values: torch.Tensor  # [No]
    errors: torch.Tensor  # [No] observation error variance R
    lats: torch.Tensor  # [No]
    lons: torch.Tensor  # [No]
    radii: torch.Tensor  # [No] GC halfwidth km; inf = no localization
    assim: torch.Tensor  # bool [No] assimilate_this AND qc_ok
    verts: Optional[torch.Tensor] = None  # [No] vertical coordinate
    vert_radii: Optional[torch.Tensor] = None  # [No] vertical halfwidth

    def with_default_verts(self) -> "ObsArrays":
        v = self.values
        verts = self.verts
        vrad = self.vert_radii
        if verts is None:
            verts = torch.zeros_like(v)
        if vrad is None:
            vrad = torch.full_like(v, float("inf"))
        return self._replace(verts=verts, vert_radii=vrad)


class ObsDiagnostics(NamedTuple):
    """Per-observation filter diagnostics."""

    prior_mean: torch.Tensor
    prior_var: torch.Tensor
    post_mean: torch.Tensor
    post_var: torch.Tensor
    assimilated: torch.Tensor  # bool


class TailSolution(NamedTuple):
    """Phase-1 output: everything the state body needs, per observation.

    In hybrid mode the ensemble coefficients carry the ``alpha`` factor
    and two more per-ob scalars describe the fixed static column
    ``s_j = (1-a) sigma_row sigma_ob gc_j / kdenom_j``: the body applies
    ``mean += sigma_row (Gc @ static_gain)`` and
    ``X -= [g_j (w_j o d_j) + sigma_row static_sqrt_j gc_j] Y``."""

    ye: torch.Tensor  # [No, M] the pre-update obs-space perturbation rows
    gain_coef: torch.Tensor  # [No] [a] innov / (kdenom (M-1)); 0 when skipped
    sqrt_coef: torch.Tensor  # [No] [a] beta / (kdenom (M-1)); 0 when skipped
    tail_mean: torch.Tensor  # [No] posterior tail mean
    tail_perts: torch.Tensor  # [No, M] posterior tail perts
    diags: ObsDiagnostics
    # hybrid static-column scalars, None in pure-ensemble mode; 0 when
    # skipped: (1-a) sigma_ob innov / kdenom and (1-a) sigma_ob beta / kdenom
    static_gain: Optional[torch.Tensor] = None  # [No]
    static_sqrt: Optional[torch.Tensor] = None  # [No]
    # the stochastic EnKF's departure rows z = ye - eps, which the body
    # applies (its gain_coef / sqrt_coef carry no beta); None for the EnSRF
    apply_rows: Optional[torch.Tensor] = None  # [No, M]


def _pad(x: torch.Tensor, n: int, fill=0.0) -> torch.Tensor:
    """Pad the leading axis of ``x`` with ``n`` entries of ``fill``."""
    if n == 0:
        return x
    tail = torch.full((n,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail])


def _ye_var(ye: torch.Tensor, unbiased: bool) -> torch.Tensor:
    """Ensemble variance of an obs-space perturbation row: ddof 0
    reproduces the reference's ``np.var``; ddof 1 when ``unbiased``."""
    m = torch.mean(ye)
    sq = (ye - m) ** 2
    if unbiased:
        return torch.sum(sq) / (ye.shape[0] - 1)
    return torch.mean(sq)


def _empty_diags(dtype, device) -> ObsDiagnostics:
    z = torch.zeros((0,), dtype=dtype, device=device)
    return ObsDiagnostics(z, z, z, z, torch.zeros((0,), dtype=torch.bool,
                                                  device=device))


def _loc_weights(row_lat, row_lon, ob_lat, ob_lon, radius, localize: bool,
                 dtype, row_xyz=None, ob_xyz=None,
                 row_vert=None, ob_vert=None, vert_radius=None):
    """Gaspari-Cohn weights from one ob to a set of rows (None when
    localization is off); chordal when unit vectors are given, times a
    vertical GC factor when a row vertical coordinate is given."""
    if not localize:
        return None
    if row_xyz is not None:
        w = chordal_gc_weights(row_xyz, ob_xyz, radius).to(dtype)
    else:
        d = haversine((row_lat, row_lon), (ob_lat, ob_lon))
        w = gaspari_cohn(d, radius).to(dtype)
    if row_vert is not None:
        w = w * gaspari_cohn(torch.abs(row_vert - ob_vert),
                             vert_radius).to(dtype)
    return w


def sigma_rows(sigma, like: torch.Tensor) -> torch.Tensor:
    """A static-B std, scalar or one per row, as a tensor shaped, typed
    and placed like ``like``."""
    return torch.as_tensor(sigma, dtype=like.dtype,
                           device=like.device).expand(like.shape)


def _check_hybrid(hybrid: bool, use_vl: bool, *needed) -> None:
    if hybrid and any(x is None for x in needed):
        raise ValueError("hybrid_alpha < 1 needs the static-B sigma(s) and "
                         "static_length")
    if hybrid and use_vl:
        raise ValueError("varloc does not combine with hybrid covariance "
                         "(the static column would be untapered)")


def _cast_obs(obs: ObsArrays, dtype) -> ObsArrays:
    obs = obs.with_default_verts()
    return ObsArrays(
        values=obs.values.to(dtype), errors=obs.errors.to(dtype),
        lats=obs.lats.to(dtype), lons=obs.lons.to(dtype),
        radii=obs.radii.to(dtype), assim=obs.assim,
        verts=obs.verts.to(dtype), vert_radii=obs.vert_radii.to(dtype),
    )


def _serial_step_scalars(tp, tm, i, values, errors, nens, unbiased,
                         blend=None):
    """``blend = (alpha, sigma_ob)`` mixes the static variance into
    ``varye`` (hybrid mode)."""
    ye = tp[i].clone()
    mye = tm[i]
    varye = _ye_var(ye, unbiased)
    innov = values[i] - mye
    if blend is not None:
        alpha, sig_ob = blend
        varye = alpha * varye + (1.0 - alpha) * sig_ob * sig_ob
    kdenom = varye + errors[i]
    scale = 1.0 / (kdenom * (nens - 1))
    beta = 1.0 / (1.0 + torch.sqrt(errors[i] / kdenom))
    return ye, mye, varye, innov, kdenom, scale, beta


# ---------------------------------------------------------------------------
# Strategy 1: direct serial loop
# ---------------------------------------------------------------------------


def ensrf_serial(body_mean, body_perts, tail_mean, tail_perts, body_lat,
                 body_lon, obs: ObsArrays, localize: bool = True,
                 unbiased: bool = False, fast_geometry: bool = False,
                 body_vert=None, vertical: bool = False,
                 hybrid_alpha: float = 1.0, body_sigma=None, tail_sigma=None,
                 static_length=None, varloc=None, row_var=None, ob_var=None):
    """Serial EnSRF, one observation at a time over body and tail.

    ``hybrid_alpha < 1`` blends a static background covariance into the
    gain, held fixed over the batch::

        cov(row, ob) = alpha loc_w ens_cov
                       + (1 - alpha) sigma(row) sigma(ob) GC(d, static_length)
        var(ye)      = alpha var_ens(ye) + (1 - alpha) sigma(ob)^2

    with ``body_sigma [Ns]`` / ``tail_sigma [No]`` (or scalars) and ``d``
    the exact haversine distance.

    ``varloc [nv(+1), nvars]`` with ``row_var [Ns]`` and ``ob_var [No]``
    (integer indices) multiplies ob i's gain at row r by
    ``varloc[ob_var[i], row_var[r]]``, on the tail rows by
    ``varloc[ob_var[i], ob_var[r]]``.

    Returns ``(body_mean, body_perts, tail_mean, tail_perts, diags)``.
    """
    nens = body_perts.shape[1]
    dtype = body_perts.dtype
    device = body_perts.device
    nobs = obs.values.shape[0]
    hybrid = hybrid_alpha < 1.0
    use_vl = varloc is not None
    _check_hybrid(hybrid, use_vl, body_sigma, tail_sigma, static_length)
    if nobs == 0:
        return (body_mean, body_perts, tail_mean, tail_perts,
                _empty_diags(dtype, device))
    if hybrid:
        alpha = float(hybrid_alpha)
        bsig = sigma_rows(body_sigma, body_mean.to(dtype))
        tsig = sigma_rows(tail_sigma, tail_mean.to(dtype))
        slen = float(static_length)
    if use_vl:
        if row_var is None or ob_var is None:
            raise ValueError("varloc needs row_var and ob_var")
        vl = varloc.to(dtype)
        rvar = row_var.long()
        ovar_all = ob_var.long()
    if localize and fast_geometry:
        body_xyz = latlon_to_unit(body_lat, body_lon).to(dtype)
        tail_xyz = latlon_to_unit(obs.lats, obs.lons).to(dtype)
    obs_raw = obs.with_default_verts()
    obs = _cast_obs(obs, dtype)
    vert_on = localize and vertical
    bvert = body_vert.to(dtype) if vert_on else None
    tvert = obs.verts if vert_on else None

    bm, bp, tm, tp = body_mean, body_perts, tail_mean, tail_perts
    pm, pv, om, ov = [], [], [], []
    nan = torch.tensor(float("nan"), dtype=dtype, device=device)
    for i in range(nobs):
        ye, mye, varye, innov, kdenom, scale, beta = _serial_step_scalars(
            tp, tm, i, obs.values, obs.errors, nens, unbiased,
            blend=(alpha, tsig[i]) if hybrid else None)
        kcov_b = bp @ ye
        kcov_t = tp @ ye
        vkw_b = vkw_t = {}
        if vert_on:
            vkw_b = dict(row_vert=bvert, ob_vert=obs.verts[i],
                         vert_radius=obs.vert_radii[i])
            vkw_t = dict(row_vert=tvert, ob_vert=obs.verts[i],
                         vert_radius=obs.vert_radii[i])
        if localize and fast_geometry:
            ob_xyz = latlon_to_unit(obs.lats[i], obs.lons[i]).to(dtype)
            w_b = _loc_weights(None, None, None, None, obs.radii[i], True,
                               dtype, row_xyz=body_xyz, ob_xyz=ob_xyz, **vkw_b)
            w_t = _loc_weights(None, None, None, None, obs.radii[i], True,
                               dtype, row_xyz=tail_xyz, ob_xyz=ob_xyz, **vkw_t)
        else:
            w_b = _loc_weights(body_lat, body_lon, obs.lats[i], obs.lons[i],
                               obs.radii[i], localize, dtype, **vkw_b)
            w_t = _loc_weights(obs_raw.lats, obs_raw.lons, obs.lats[i],
                               obs.lons[i], obs.radii[i], localize, dtype,
                               **vkw_t)
        if localize:
            kcov_b = kcov_b * w_b
            kcov_t = kcov_t * w_t
        if use_vl:
            fr = vl[ovar_all[i]]  # this ob's factor row [nvars]
            kcov_b = kcov_b * fr[rvar]
            kcov_t = kcov_t * fr[ovar_all]
        kmat_b = kcov_b * scale
        kmat_t = kcov_t * scale
        if hybrid:
            # The fixed static column, added to the localized ensemble
            # gain; kdenom already blends the variances.
            gcb = _loc_weights(body_lat, body_lon, obs.lats[i], obs.lons[i],
                               slen, True, dtype)
            gct = _loc_weights(obs_raw.lats, obs_raw.lons, obs.lats[i],
                               obs.lons[i], slen, True, dtype)
            kmat_b = (alpha * kmat_b
                      + (1.0 - alpha) * bsig * tsig[i] * gcb / kdenom)
            kmat_t = (alpha * kmat_t
                      + (1.0 - alpha) * tsig * tsig[i] * gct / kdenom)
        a = obs.assim[i]
        bm = torch.where(a, bm + kmat_b * innov, bm)
        tm = torch.where(a, tm + kmat_t * innov, tm)
        bp = torch.where(a, bp - (beta * kmat_b)[:, None] * ye[None, :], bp)
        tp = torch.where(a, tp - (beta * kmat_t)[:, None] * ye[None, :], tp)
        pm.append(mye)
        pv.append(varye)
        om.append(torch.where(a, tm[i], nan))
        ov.append(torch.where(a, _ye_var(tp[i], unbiased), nan))
    diags = ObsDiagnostics(torch.stack(pm), torch.stack(pv), torch.stack(om),
                           torch.stack(ov), obs.assim)
    return bm, bp, tm, tp, diags


# ---------------------------------------------------------------------------
# Strategy 2, phase 1: tail-only scan
# ---------------------------------------------------------------------------


def tail_scan(tail_mean, tail_perts, obs: ObsArrays, localize: bool = True,
              unbiased: bool = False, fast_geometry: bool = False,
              vertical: bool = False, hybrid_alpha: float = 1.0,
              tail_sigma=None, static_length=None, varloc=None,
              ob_var=None) -> TailSolution:
    """Serial filter on the observation-space tail only: the exact ``ye``
    sequence and scalar coefficients of the full serial algorithm, plus
    every per-ob diagnostic.  ``hybrid_alpha < 1`` runs the hybrid blend
    of :func:`ensrf_serial` on the tail rows and also returns the static
    column's scalars.  ``varloc``/``ob_var`` as in :func:`ensrf_serial`
    (the tail rows are the obs rows)."""
    nens = tail_perts.shape[1]
    dtype = tail_perts.dtype
    device = tail_perts.device
    nobs = obs.values.shape[0]
    hybrid = hybrid_alpha < 1.0
    use_vl = varloc is not None
    _check_hybrid(hybrid, use_vl, tail_sigma, static_length)
    if use_vl:
        if ob_var is None:
            raise ValueError("varloc needs ob_var")
        vl = varloc.to(dtype)
        ovar_all = ob_var.long()
    if nobs == 0:
        z = torch.zeros((0,), dtype=dtype, device=device)
        return TailSolution(
            ye=torch.zeros((0, nens), dtype=dtype, device=device),
            gain_coef=z, sqrt_coef=z, tail_mean=tail_mean,
            tail_perts=tail_perts, diags=_empty_diags(dtype, device),
            static_gain=z if hybrid else None,
            static_sqrt=z if hybrid else None)
    if hybrid:
        alpha = float(hybrid_alpha)
        tsig = sigma_rows(tail_sigma, tail_mean.to(dtype))
        slen = float(static_length)
    tail_xyz = (latlon_to_unit(obs.lats, obs.lons).to(dtype)
                if (localize and fast_geometry) else None)
    obs_raw = obs.with_default_verts()
    obs = _cast_obs(obs, dtype)
    vert_on = localize and vertical
    tm, tp = tail_mean, tail_perts
    zero = torch.zeros((), dtype=dtype, device=device)
    nan = torch.tensor(float("nan"), dtype=dtype, device=device)
    ye_rows, gains, sqrts, sgains, ssqrts = [], [], [], [], []
    pm, pv, om, ov = [], [], [], []
    for i in range(nobs):
        ye, mye, varye, innov, kdenom, scale, beta = _serial_step_scalars(
            tp, tm, i, obs.values, obs.errors, nens, unbiased,
            blend=(alpha, tsig[i]) if hybrid else None)
        kcov_t = tp @ ye
        vkw = (dict(row_vert=obs.verts, ob_vert=obs.verts[i],
                    vert_radius=obs.vert_radii[i]) if vert_on else {})
        if localize and fast_geometry:
            w_t = _loc_weights(
                None, None, None, None, obs.radii[i], True, dtype,
                row_xyz=tail_xyz,
                ob_xyz=latlon_to_unit(obs.lats[i], obs.lons[i]).to(dtype),
                **vkw)
        else:
            w_t = _loc_weights(obs_raw.lats, obs_raw.lons, obs.lats[i],
                               obs.lons[i], obs.radii[i], localize, dtype,
                               **vkw)
        if localize:
            kcov_t = kcov_t * w_t
        if use_vl:
            kcov_t = kcov_t * vl[ovar_all[i]][ovar_all]
        kmat_t = kcov_t * scale
        if hybrid:
            gct = _loc_weights(obs_raw.lats, obs_raw.lons, obs.lats[i],
                               obs.lons[i], slen, True, dtype)
            kmat_t = (alpha * kmat_t
                      + (1.0 - alpha) * tsig * tsig[i] * gct / kdenom)
        a = obs.assim[i]
        tm = torch.where(a, tm + kmat_t * innov, tm)
        tp = torch.where(a, tp - (beta * kmat_t)[:, None] * ye[None, :], tp)
        ye_rows.append(ye)
        if hybrid:
            gains.append(torch.where(a, alpha * innov * scale, zero))
            sqrts.append(torch.where(a, alpha * beta * scale, zero))
            s_base = (1.0 - alpha) * tsig[i] / kdenom
            sgains.append(torch.where(a, s_base * innov, zero))
            ssqrts.append(torch.where(a, s_base * beta, zero))
        else:
            gains.append(torch.where(a, innov * scale, zero))
            sqrts.append(torch.where(a, beta * scale, zero))
        pm.append(mye)
        pv.append(varye)
        om.append(torch.where(a, tm[i], nan))
        ov.append(torch.where(a, _ye_var(tp[i], unbiased), nan))
    return TailSolution(
        ye=torch.stack(ye_rows), gain_coef=torch.stack(gains),
        sqrt_coef=torch.stack(sqrts), tail_mean=tm, tail_perts=tp,
        diags=ObsDiagnostics(torch.stack(pm), torch.stack(pv),
                             torch.stack(om), torch.stack(ov), obs.assim),
        static_gain=torch.stack(sgains) if hybrid else None,
        static_sqrt=torch.stack(ssqrts) if hybrid else None,
    )


def _ob_weights(rows_lat, rows_lon, rows_xyz, rows_vert, ob: ObsArrays,
                i: int, localize: bool, fast_geometry: bool, vertical: bool,
                dtype):
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


def enkf_tail_scan(tail_mean, tail_perts, obs: ObsArrays, eps,
                   localize: bool = True, unbiased: bool = False,
                   fast_geometry: bool = False, vertical: bool = False,
                   varloc=None, ob_var=None) -> Tuple[TailSolution,
                                                      torch.Tensor]:
    """The stochastic EnKF on the observation-space tail only: the exact
    ``ye`` sequence, the per-ob coefficients (``gain_coef = innov *
    scale``, ``sqrt_coef = scale``: the full gain, no beta) and the
    perturbed-ob departure rows ``z = ye - eps`` the blocked body applies.
    Returns ``(TailSolution, z)``, the solution carrying ``z`` as its
    ``apply_rows`` too.  The plain reference of the EnKF's tail on the
    kernel route (:func:`tail_scan_blocked` with ``eps``), and its panel
    solve there where no kernel runs."""
    nens = tail_perts.shape[1]
    dtype = tail_perts.dtype
    device = tail_perts.device
    nobs = obs.values.shape[0]
    if nobs == 0:
        zc = torch.zeros((0,), dtype=dtype, device=device)
        rows = torch.zeros((0, nens), dtype=dtype, device=device)
        return TailSolution(ye=rows, gain_coef=zc, sqrt_coef=zc,
                            tail_mean=tail_mean, tail_perts=tail_perts,
                            diags=_empty_diags(dtype, device),
                            apply_rows=rows), rows
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
    nan = torch.full((), float("nan"), dtype=dtype, device=device)
    ye_rows, z_rows, gains, coefs = [], [], [], []
    pm, pv, om, ov = [], [], [], []
    for i in range(nobs):
        ye, mye, varye, innov, _, scale, _ = _serial_step_scalars(
            tp, tm, i, obs.values, obs.errors, nens, unbiased)
        kcov_t = tp @ ye
        w_t = _ob_weights(obs_raw.lats, obs_raw.lons, tail_xyz, obs.verts,
                          obs, i, localize, fast_geometry, vertical, dtype)
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
    z = torch.stack(z_rows)
    return TailSolution(
        ye=torch.stack(ye_rows), gain_coef=torch.stack(gains),
        sqrt_coef=torch.stack(coefs), tail_mean=tm, tail_perts=tp,
        diags=ObsDiagnostics(torch.stack(pm), torch.stack(pv),
                             torch.stack(om), torch.stack(ov), obs.assim),
        apply_rows=z), z


@profiling.spanned(profiling.OPS_PANEL_WEIGHTS)
def panel_weights(pxyz, pob: ObsArrays, vertical: bool, dtype,
                  localize: bool = True, varloc=None, ob_var=None):
    """Ob-ob weight matrix of one panel, ``w[i, j]`` = weight of ob i at
    panel row j, exactly the factors :func:`tail_scan` applies to ob i's
    covariances: chordal GC when unit vectors ``pxyz`` are given (the
    build ``ensrf_core._panel_solve_pallas`` :560-568 streams into B1),
    else GC of the exact haversine distance; times the vertical GC; times
    ``varloc[ob_var_i, ob_var_j]``.  None when no factor applies."""
    w = None
    if localize:
        if pxyz is not None:
            w = chordal_gc_weights(pxyz[None, :, :], pxyz[:, None, :],
                                   pob.radii[:, None]).to(dtype)
        else:
            w = gaspari_cohn(
                haversine((pob.lats[None, :], pob.lons[None, :]),
                          (pob.lats[:, None], pob.lons[:, None])),
                pob.radii[:, None]).to(dtype)
        if vertical:
            w = w * gaspari_cohn(
                torch.abs(pob.verts[:, None] - pob.verts[None, :]),
                pob.vert_radii[:, None],
            ).to(dtype)
    if varloc is not None:
        ov = ob_var.long()
        fac = varloc.to(dtype)[ov][:, ov]
        w = fac if w is None else w * fac
    return w


def static_weights(pob: ObsArrays, static_length: float, dtype):
    """The hybrid static correlation of one panel, ``gc[i, j] =
    GC(haversine(ob i, row j), static_length)``, as :func:`tail_scan`
    applies it."""
    return gaspari_cohn(
        haversine((pob.lats[None, :], pob.lons[None, :]),
                  (pob.lats[:, None], pob.lons[:, None])),
        float(static_length)).to(dtype)


def _panel_solve_kernel(tm, tp, pob: ObsArrays, pxyz, localize: bool,
                        unbiased: bool, vertical: bool, dtype, varloc=None,
                        ob_var=None, hybrid_alpha: float = 1.0,
                        tail_sigma=None, static_length=None,
                        eps=None) -> TailSolution:
    """Serial solve of one obs panel through B1, B1h in hybrid mode, or
    B1e given the stochastic EnKF's draws ``eps [P, M]``
    (:func:`efa_xray_tpu_torch.ops.tail_solve.tail_panel_solve`), with the
    panel's weights built here once: chordal when ``pxyz`` is given, else
    exact haversine."""
    from efa_xray_tpu_torch.ops.tail_solve import tail_panel_solve

    wmat = panel_weights(pxyz, pob, vertical, dtype, localize=localize,
                         varloc=varloc, ob_var=ob_var)
    hybrid = hybrid_alpha < 1.0
    hkw = {}
    if hybrid:
        hkw = dict(alpha=float(hybrid_alpha), sigma=tail_sigma.to(dtype),
                   static_gc=static_weights(pob, static_length, dtype))
    if eps is not None:
        hkw = dict(eps=eps.to(dtype))
    out = tail_panel_solve(tm, tp, pob.values, pob.errors, pob.assim, wmat,
                           unbiased=unbiased, **hkw)
    ptm, ptp, pye, pg, psq, ppm, ppv, pom, pov = out[:9]
    return TailSolution(
        ye=pye, gain_coef=pg, sqrt_coef=psq, tail_mean=ptm, tail_perts=ptp,
        diags=ObsDiagnostics(ppm, ppv, pom, pov, pob.assim),
        static_gain=out[9] if hybrid else None,
        static_sqrt=out[10] if hybrid else None,
        apply_rows=out[9] if eps is not None else None,
    )


def _cut(sol: TailSolution, n: int) -> TailSolution:
    """The first ``n`` obs of a panel's solution."""
    cut = lambda x: None if x is None else x[:n]
    return TailSolution(
        ye=cut(sol.ye), gain_coef=cut(sol.gain_coef),
        sqrt_coef=cut(sol.sqrt_coef), tail_mean=cut(sol.tail_mean),
        tail_perts=cut(sol.tail_perts),
        diags=ObsDiagnostics(*(cut(d) for d in sol.diags)),
        static_gain=cut(sol.static_gain), static_sqrt=cut(sol.static_sqrt),
        apply_rows=cut(sol.apply_rows))


# The in-kernel panel solve serves panels up to this many obs, the bound
# of the JAX package's kernel (``ensrf_core.py:659``); larger panels keep
# the kernel apply and solve each panel with the plain scan.
MAX_KERNEL_PANEL = 1024
# Obs per B4 launch in the tail's out-of-panel apply.
TAIL_APPLY_BLOCK = 128


def tail_apply_route(localize: bool, fast_geometry: bool, use_vl: bool,
                     hybrid: bool) -> str:
    """The out-of-panel apply of the kernel tail: ``"B2"`` (chordal or
    unlocalized, no varloc, no hybrid), ``"B4"`` (exact haversine or
    varloc, pure ensemble) or ``"plain"`` (hybrid: the static column at
    exact haversine, which no kernel carries)."""
    if hybrid:
        return "plain"
    if use_vl or (localize and not fast_geometry):
        return "B4"
    return "B2"


@profiling.spanned(profiling.ROUTE_TAIL)
def tail_scan_blocked(tail_mean, tail_perts, obs: ObsArrays,
                      localize: bool = True, unbiased: bool = False,
                      fast_geometry: bool = False, vertical: bool = False,
                      panel: int = 512, kernels: bool = False,
                      max_radius_km=None, hybrid_alpha: float = 1.0,
                      tail_sigma=None, static_length=None, varloc=None,
                      ob_var=None, eps=None) -> TailSolution:
    """Panel-blocked phase 1: same outputs as :func:`tail_scan`, exact up
    to fp reassociation.  Each panel of obs is solved serially on its own
    rows, then applied to every row outside the panel with the body
    operator; the in-panel rows are then overwritten by the exact panel
    solution.

    ``kernels=True`` solves each panel through B1, with the panel's
    weights (chordal or exact haversine, vertical, ``varloc``) built once
    in torch, or through B1h in hybrid mode, and applies it out of panel
    per :func:`tail_apply_route`: B2
    (:mod:`efa_xray_tpu_torch.ops.ensrf_fused`) for chordal or unlocalized
    runs without varloc, B4 (:func:`efa_xray_tpu_torch.ops.ensrf_grid.
    apply_obs_block`, blocks of ``TAIL_APPLY_BLOCK`` obs on the tail rows
    as a flat state) for exact haversine or varloc, and the plain
    :func:`apply_obs_block` with its static columns in hybrid mode.  On
    CPU tensors the kernels' plain versions run.  ``max_radius_km`` lets
    B2 pick its cheaper angle form.  ``kernels=False`` is the plain
    per-ob scan of each panel, the reference the kernel branch is held
    against.

    ``eps [No, M]`` (the stochastic EnKF's draws; no hybrid) solves
    :func:`enkf_tail_scan` instead:
    each panel through B1e (plain: that per-ob scan), the rows outside it
    through B2e / B4e (plain: :func:`apply_obs_block`) against the
    panel's departure rows, which the solution carries as ``apply_rows``.
    """
    nens = tail_perts.shape[1]
    dtype = tail_perts.dtype
    nobs = obs.values.shape[0]
    hybrid = hybrid_alpha < 1.0
    use_vl = varloc is not None
    if use_vl and ob_var is None:
        raise ValueError("varloc needs ob_var")
    vkw = dict(varloc=varloc, ob_var=ob_var) if use_vl else {}
    hkw = dict(hybrid_alpha=hybrid_alpha,
               static_length=static_length) if hybrid else {}
    _check_hybrid(hybrid, use_vl, tail_sigma, static_length)
    enkf = eps is not None
    if hybrid and enkf:
        raise ValueError("eps (stochastic EnKF) does not combine with "
                         "hybrid covariance")
    solve_kernel = kernels and panel <= MAX_KERNEL_PANEL
    obs = obs.with_default_verts()
    chordal = localize and fast_geometry

    def plain_solve(tm, tp, pob, pe, **kw):
        if not enkf:
            return tail_scan(tm, tp, pob, localize=localize,
                             unbiased=unbiased, fast_geometry=fast_geometry,
                             vertical=vertical, **kw)
        return enkf_tail_scan(tm, tp, pob, pe, localize=localize,
                              unbiased=unbiased, fast_geometry=fast_geometry,
                              vertical=vertical, **kw)[0]

    if nobs == 0 or nobs <= panel:
        # One panel (an empty batch: one empty panel).
        with profiling.annotate(profiling.ROUTE_TAIL_PANEL):
            if not (solve_kernel and nobs > 0):
                return plain_solve(tail_mean, tail_perts, obs, eps,
                                   **(dict(tail_sigma=tail_sigma, **hkw)
                                      if hybrid else {}), **vkw)
            # One panel covers the batch: pad it to the full panel width
            # (padded obs have assim=False and are exact no-ops) and slice
            # every output back.
            pad1 = panel - nobs
            obs1 = _pad_obs(obs, pad1, dtype)
            sol = _panel_solve_kernel(
                _pad(tail_mean, pad1), _pad(tail_perts, pad1), obs1,
                latlon_to_unit(obs1.lats, obs1.lons).to(dtype)
                if chordal else None,
                localize=localize, unbiased=unbiased, vertical=vertical,
                dtype=dtype,
                **(dict(varloc=varloc, ob_var=_pad(ob_var.long(), pad1, 0))
                   if use_vl else {}),
                **(dict(tail_sigma=_pad(
                    sigma_rows(tail_sigma, tail_mean.to(dtype)), pad1),
                        **hkw) if hybrid else {}),
                eps=_pad(eps.to(dtype), pad1) if enkf else None)
            return _cut(sol, nobs)

    npanels = -(-nobs // panel)
    pad = npanels * panel - nobs
    tm = _pad(tail_mean, pad)
    tp = _pad(tail_perts, pad)
    allo = _pad_obs(obs, pad, dtype)
    ntot = nobs + pad
    all_xyz = (latlon_to_unit(allo.lats, allo.lons).to(dtype)
               if chordal else None)
    row_idx = torch.arange(ntot, device=tm.device)
    if use_vl:
        vl = varloc.to(dtype)
        ovarr = _pad(ob_var.long(), pad, 0)
    if hybrid:
        tsig_all = _pad(sigma_rows(tail_sigma, tail_mean.to(dtype)), pad)
        slen = float(static_length)
    eps_all = _pad(eps.to(dtype), pad) if enkf else None
    apply = (tail_apply_route(localize, fast_geometry, use_vl, hybrid)
             if kernels else "plain")
    tail_geo = None
    if apply == "B4":
        from efa_xray_tpu_torch.ops import ensrf_grid

        # The tail rows' geometry, once, where B4 computes its weights.
        tail_geo = ensrf_grid.points_for_kernel(
            allo.lats, allo.lons, dtype, on_card=tm.is_cuda,
            localize=localize, fast_geometry=fast_geometry,
            vertical=localize and vertical, vt=1, row_factor=use_vl)
    # The B4 apply updates the tail in place once this call owns it.
    owned = False

    outs = []
    for p in range(npanels):
        with profiling.annotate(profiling.ROUTE_TAIL_PANEL):
            base = p * panel
            sl = slice(base, base + panel)
            pob = ObsArrays(*(x[sl] for x in allo))
            pvkw = dict(varloc=vl, ob_var=ovarr[sl]) if use_vl else {}
            pe = eps_all[sl] if enkf else None
            if solve_kernel:
                sol = _panel_solve_kernel(
                    tm[sl], tp[sl], pob, all_xyz[sl] if chordal else None,
                    localize=localize, unbiased=unbiased, vertical=vertical,
                    dtype=dtype, **pvkw,
                    **(dict(tail_sigma=tsig_all[sl], **hkw) if hybrid else {}),
                    eps=pe)
            else:
                sol = plain_solve(tm[sl], tp[sl], pob, pe,
                                  **(dict(tail_sigma=tsig_all[sl], **hkw)
                                     if hybrid else {}), **pvkw)
            if apply == "B2":
                from efa_xray_tpu_torch.ops.ensrf_fused import fused_body

                # The in-panel rows are overwritten right below, so the B2
                # apply may touch them freely (no out-of-panel mask).
                tm2, tp2 = fused_body(
                    tm, tp, allo.lats, allo.lons, sol, pob,
                    body_vert=allo.verts if (localize and vertical) else None,
                    localize=localize, block_size=min(128, panel),
                    vertical=localize and vertical,
                    max_radius_km=max_radius_km,
                    apply_rows=sol.apply_rows,
                )
            elif apply == "B4":
                # As with B2, no out-of-panel mask: the tail rows are a flat
                # state (vt = 1) with the obs' own places and levels.
                tm2, tp2 = tm, tp
                for lo in range(0, panel, TAIL_APPLY_BLOCK):
                    bl = slice(lo, min(panel, lo + TAIL_APPLY_BLOCK))
                    tm2, tp2 = ensrf_grid.apply_obs_block(
                        tm2, tp2, allo.lats, allo.lons, sol.ye[bl],
                        sol.gain_coef[bl], sol.sqrt_coef[bl], pob.lats[bl],
                        pob.lons[bl], pob.radii[bl], localize=localize,
                        fast_geometry=fast_geometry, body_vert=allo.verts,
                        ob_vert=pob.verts[bl], ob_vrad=pob.vert_radii[bl],
                        vertical=localize and vertical, ngrid=None,
                        ob_row_factor=(vl[ovarr[sl][bl]][:, ovarr] if use_vl
                                       else None),
                        donate=owned,
                        apply_rows=None if not enkf else sol.apply_rows[bl],
                        point_geo=tail_geo)
                    owned = True
            else:
                outside = ((row_idx < base)
                           | (row_idx >= base + panel)).to(dtype)
                if chordal:
                    w = chordal_gc_weights(all_xyz[:, None, :],
                                           all_xyz[sl][None, :, :],
                                           pob.radii[None, :]).to(dtype)
                elif localize:
                    w = gaspari_cohn(
                        haversine((allo.lats[:, None], allo.lons[:, None]),
                                  (pob.lats[None, :], pob.lons[None, :])),
                        pob.radii[None, :]).to(dtype)
                else:
                    w = torch.ones((ntot, panel), dtype=dtype,
                                   device=tm.device)
                if localize and vertical:
                    w = w * gaspari_cohn(
                        torch.abs(allo.verts[:, None] - pob.verts[None, :]),
                        pob.vert_radii[None, :]).to(dtype)
                if use_vl:
                    # factor[r, j] = vl[panel_ob_var_j, row_ob_var_r]
                    w = w * vl[ovarr[sl]][:, ovarr].T
                w = w * outside[:, None]
                static_mean = static_tilde = None
                if hybrid:
                    # Static columns toward the out-of-panel obs rows (the
                    # panel's own rows were solved exactly above), at exact
                    # haversine distance: part of the covariance model.
                    gc = gaspari_cohn(
                        haversine((allo.lats[:, None], allo.lons[:, None]),
                                  (pob.lats[None, :], pob.lons[None, :])),
                        slen).to(dtype) * outside[:, None]
                    static_mean = tsig_all * (gc @ sol.static_gain)
                    static_tilde = (tsig_all[:, None] * gc
                                    * sol.static_sqrt[None, :])
                tm2, tp2 = apply_obs_block(tm, tp, sol.ye, sol.gain_coef,
                                           sol.sqrt_coef, w,
                                           static_mean=static_mean,
                                           static_tilde=static_tilde,
                                           apply_rows=sol.apply_rows)
            tm2[sl] = sol.tail_mean
            tp2[sl] = sol.tail_perts
            tm, tp = tm2, tp2
            outs.append(sol)

    cat = lambda xs: torch.cat(xs)[:nobs]
    return TailSolution(
        ye=cat([s.ye for s in outs]),
        gain_coef=cat([s.gain_coef for s in outs]),
        sqrt_coef=cat([s.sqrt_coef for s in outs]),
        tail_mean=tm[:nobs],
        tail_perts=tp[:nobs],
        diags=ObsDiagnostics(*(cat([s.diags[k] for s in outs])
                               for k in range(5))),
        static_gain=cat([s.static_gain for s in outs]) if hybrid else None,
        static_sqrt=cat([s.static_sqrt for s in outs]) if hybrid else None,
        apply_rows=cat([s.apply_rows for s in outs]) if enkf else None,
    )


def _pad_obs(obs: ObsArrays, pad: int, dtype) -> ObsArrays:
    """Pad an ObsArrays with ``pad`` no-op obs: zero value, unit error,
    infinite radii, not assimilated."""
    obs = obs.with_default_verts()
    f = lambda x, fill=0.0: _pad(x.to(dtype), pad, fill)
    inf = float("inf")
    return ObsArrays(
        values=f(obs.values), errors=f(obs.errors, 1.0), lats=f(obs.lats),
        lons=f(obs.lons), radii=f(obs.radii, inf),
        assim=_pad(obs.assim, pad, False), verts=f(obs.verts),
        vert_radii=f(obs.vert_radii, inf),
    )


# ---------------------------------------------------------------------------
# Strategy 2, phase 2: blocked state-body update
# ---------------------------------------------------------------------------


def _block_recurrence(d0, gram, w, sqrt_coef, panel: int = 8,
                      static_tilde=None):
    """Panel-blocked forward substitution of the within-block recurrence.

    ``d0 [rows, B] = X_0 Y^T``, ``gram [B, B] = Y Y^T``, ``w [rows, B]``
    (or None), ``static_tilde [rows, B]`` the hybrid static columns
    ``sigma_row static_sqrt_j gc_j`` (or None).  Returns ``(U, V)`` with
    ``U = [w_j d_j]`` and ``V = [g_j U_j + static_tilde_j]``;
    ``d_j = d0_j - sum_{i<j} V_i G_ij``.
    """
    bsz = d0.shape[1]
    u_done = v_done = None
    for base in range(0, bsz, panel):
        width = min(panel, bsz - base)
        d_panel = d0[:, base:base + width]
        if base > 0:
            d_panel = d_panel - v_done @ gram[:base, base:base + width]
        u_cols, v_cols = [], []
        for t in range(width):
            d_j = d_panel[:, t]
            if t > 0:
                v_p = torch.stack(v_cols, dim=1)
                d_j = d_j - v_p @ gram[base:base + t, base + t]
            u_j = d_j if w is None else w[:, base + t] * d_j
            v_j = u_j * sqrt_coef[base + t]
            if static_tilde is not None:
                v_j = v_j + static_tilde[:, base + t]
            u_cols.append(u_j)
            v_cols.append(v_j)
        u_slab = torch.stack(u_cols, dim=1)
        v_slab = torch.stack(v_cols, dim=1)
        u_done = u_slab if u_done is None else torch.cat([u_done, u_slab], 1)
        v_done = v_slab if v_done is None else torch.cat([v_done, v_slab], 1)
    return u_done, v_done


def apply_obs_block(body_mean, body_perts, ye_block, gain_coef, sqrt_coef,
                    w_block, static_mean=None, static_tilde=None,
                    apply_rows=None):
    """Apply one block of B pre-solved obs to the state body: two matrix
    products and a B-step recurrence.  ``w_block [rows, B]`` or None.
    Hybrid mode adds the static columns' summed mean pull ``static_mean
    [rows]`` once and lets ``static_tilde [rows, B]`` ride the
    recurrence.

    ``apply_rows [B, M]`` (default ``ye_block``) are the rows the solved
    gain columns are applied against: the stochastic EnKF's perturbed-ob
    departures ``z = ye - eps``.  The correction Gram is then
    ``gram[i, j] = a_i . ye_j`` (``A Y^T``, not symmetric): a later ob's
    prior sees the state updated by ``V A``."""
    y = ye_block.to(body_perts.dtype)
    a = y if apply_rows is None else apply_rows.to(body_perts.dtype)
    d0 = body_perts @ y.T
    gram = a @ y.T
    u, v = _block_recurrence(d0, gram, w_block, sqrt_coef,
                             static_tilde=static_tilde)
    body_mean = body_mean + u @ gain_coef
    if static_mean is not None:
        body_mean = body_mean + static_mean
    return body_mean, body_perts - v @ a


def ensrf_blocked_body(body_mean, body_perts, body_lat, body_lon,
                       tail: TailSolution, obs: ObsArrays,
                       localize: bool = True, block_size: int = 32,
                       fast_geometry: bool = False, body_vert=None,
                       vertical: bool = False, hybrid: bool = False,
                       body_sigma=None, static_length=None, varloc=None,
                       row_var=None, ob_var=None, apply_rows=None):
    """Phase 2: sweep the pre-solved obs sequence over the body in
    blocks.  Exact (up to fp reassociation) match of the serial filter.
    ``hybrid=True`` also applies each ob's fixed static column (a
    hybrid-mode ``tail``'s ``static_gain``/``static_sqrt`` times
    ``body_sigma GC(d, static_length)`` at exact haversine distance)
    through the same recurrence.  ``varloc``/``row_var``/``ob_var`` as in
    :func:`ensrf_serial`.  ``apply_rows [No, M]``: the stochastic EnKF's
    apply rows ``z = ye - eps`` (:func:`apply_obs_block`); refused with
    hybrid; by default the tail's own ``apply_rows`` (None for the
    EnSRF)."""
    nobs = tail.ye.shape[0]
    dtype = body_perts.dtype
    if apply_rows is None:
        apply_rows = tail.apply_rows
    _check_hybrid(hybrid, varloc is not None, body_sigma, static_length,
                  tail.static_gain)
    if hybrid and apply_rows is not None:
        raise ValueError("apply_rows (stochastic EnKF) does not combine "
                         "with hybrid covariance")
    if nobs == 0:
        return body_mean, body_perts
    nblocks = -(-nobs // block_size)
    pad = nblocks * block_size - nobs
    po = _pad_obs(obs, pad, dtype)
    ye = _pad(tail.ye, pad)
    arows = None if apply_rows is None else _pad(apply_rows.to(dtype), pad)
    gain = _pad(tail.gain_coef.to(dtype), pad)
    sqrtc = _pad(tail.sqrt_coef.to(dtype), pad)
    use_vl = varloc is not None
    if use_vl:
        if row_var is None or ob_var is None:
            raise ValueError("varloc needs row_var and ob_var")
        vl = varloc.to(dtype)
        rvar = row_var.long()
        ovar = _pad(ob_var.long(), pad, 0)
    if hybrid:
        # Padded obs carry zero static coefficients: their columns are 0.
        sgain = _pad(tail.static_gain.to(dtype), pad)
        ssqrt = _pad(tail.static_sqrt.to(dtype), pad)
        bsig = sigma_rows(body_sigma, body_mean.to(dtype))
        slen = float(static_length)
    body_xyz = (latlon_to_unit(body_lat, body_lon).to(dtype)
                if (localize and fast_geometry) else None)
    bm, bp = body_mean, body_perts
    for b in range(nblocks):
        sl = slice(b * block_size, (b + 1) * block_size)
        if localize and fast_geometry:
            ob_xyz = latlon_to_unit(po.lats[sl], po.lons[sl]).to(dtype)
            w = chordal_gc_weights(body_xyz[:, None, :], ob_xyz[None, :, :],
                                   po.radii[sl][None, :]).to(dtype)
        elif localize:
            d = haversine((body_lat[:, None], body_lon[:, None]),
                          (po.lats[sl][None, :], po.lons[sl][None, :]))
            w = gaspari_cohn(d, po.radii[sl][None, :]).to(dtype)
        else:
            w = None
        if localize and vertical:
            w = w * gaspari_cohn(
                torch.abs(body_vert.to(dtype)[:, None] - po.verts[sl][None, :]),
                po.vert_radii[sl][None, :]).to(dtype)
        if use_vl:
            # factor[r, j] = vl[block_ob_var_j, row_var_r]: enters the
            # recurrence exactly like a GC weight, so blocked == serial.
            fmat = vl[ovar[sl]][:, rvar].T
            w = fmat if w is None else w * fmat
        static_mean = static_tilde = None
        if hybrid:
            gc = gaspari_cohn(
                haversine((body_lat[:, None], body_lon[:, None]),
                          (po.lats[sl][None, :], po.lons[sl][None, :])),
                slen).to(dtype)
            static_mean = bsig * (gc @ sgain[sl])
            static_tilde = bsig[:, None] * gc * ssqrt[sl][None, :]
        bm, bp = apply_obs_block(bm, bp, ye[sl], gain[sl], sqrtc[sl], w,
                                 static_mean=static_mean,
                                 static_tilde=static_tilde,
                                 apply_rows=None if arows is None
                                 else arows[sl])
    return bm, bp


def ensrf_blocked(body_mean, body_perts, tail_mean, tail_perts, body_lat,
                  body_lon, obs: ObsArrays, localize: bool = True,
                  block_size: int = 32, unbiased: bool = False,
                  fast_geometry: bool = False, body_vert=None,
                  vertical: bool = False, tail_panel: Optional[int] = None,
                  hybrid_alpha: float = 1.0, body_sigma=None,
                  tail_sigma=None, static_length=None, varloc=None,
                  row_var=None, ob_var=None):
    """Full blocked update: phase-1 tail + phase-2 body sweep.  Drop-in
    equivalent of :func:`ensrf_serial` (the hybrid blend and ``varloc``
    included).  ``tail_panel`` selects the panel-blocked phase 1 (None =
    plain per-ob scan)."""
    hkw = dict(hybrid_alpha=hybrid_alpha, tail_sigma=tail_sigma,
               static_length=static_length)
    vkw = dict(varloc=varloc, ob_var=ob_var) if varloc is not None else {}
    if tail_panel:
        tail = tail_scan_blocked(tail_mean, tail_perts, obs,
                                 localize=localize, unbiased=unbiased,
                                 fast_geometry=fast_geometry,
                                 vertical=vertical, panel=tail_panel,
                                 **hkw, **vkw)
    else:
        tail = tail_scan(tail_mean, tail_perts, obs, localize=localize,
                         unbiased=unbiased, fast_geometry=fast_geometry,
                         vertical=vertical, **hkw, **vkw)
    bm, bp = ensrf_blocked_body(body_mean, body_perts, body_lat, body_lon,
                                tail, obs, localize=localize,
                                block_size=block_size,
                                fast_geometry=fast_geometry,
                                body_vert=body_vert, vertical=vertical,
                                hybrid=hybrid_alpha < 1.0,
                                body_sigma=body_sigma,
                                static_length=static_length,
                                varloc=varloc, row_var=row_var,
                                ob_var=ob_var)
    return bm, bp, tail.tail_mean, tail.tail_perts, tail.diags
