"""Ensemble sensitivity analysis and observation-impact prediction.

Counterpart of ``efa_xray_tpu/postprocess/sensitivity.py``:
``region_mean_metric`` :44, ``metric_values`` :75, ``_sig_mask`` :88,
``ensemble_sensitivity`` :107, ``observation_impact`` :170 and
``greedy_obs_selection`` :239.  The reductions over the state run on the
state's device: the region mean of :func:`region_mean_metric` (the JAX
package copies the variable to the host first), the ``[Ns, M] x [M]``
covariance product and the variance sum of :func:`ensemble_sensitivity`,
and the obs-space priors of :func:`observation_impact` through the taps.
Only ``[M]``, ``[Ns]`` and ``[No]`` vectors come back to the host.
:func:`greedy_obs_selection` stays host float64 over the ``[No, M]``
obs-space priors, as in the JAX package.

* :func:`ensemble_sensitivity`: Torn & Hakim (2008, MWR) regression
  sensitivity of a scalar forecast metric ``J`` to every state element,
  ``dJ/dx_i = cov(x_i, J) / var(x_i)``, with the correlation field and an
  optional statistical-significance mask.
* :func:`observation_impact`: Ancell & Hakim (2007, MWR) prediction of the
  change in ``J``'s mean and variance from assimilating each candidate
  observation (observation targeting).  For a single observation and a
  metric linear in the state it is exact for the serial EnSRF update; for
  a batch it is the independent-obs approximation.
* :func:`greedy_obs_selection`: sequential network design, each pick
  scored after the exact serial update of the picks before it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Union

import numpy as np
import pandas as pd
import torch

from efa_xray_tpu_torch.observation import forward as _fwd
from efa_xray_tpu_torch.observation.observation import ObservationBatch
from efa_xray_tpu_torch.state.ensemble import EnsembleState

Metric = Union[np.ndarray, Callable[[EnsembleState], np.ndarray]]


def _host64(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float64).cpu().numpy()


def region_mean_metric(
    var: str,
    time_index: Optional[int] = None,
    lat_range: Optional[tuple] = None,
    lon_range: Optional[tuple] = None,
) -> Callable[[EnsembleState], np.ndarray]:
    """Convenience metric builder: per-member mean of ``var`` over an
    optional validtime index and lat/lon box, the usual "forecast metric
    J" of the EFA/ESA literature.  The mean is taken on the state's
    device; the metric returns the ``[M]`` vector as NumPy."""

    def metric(state: EnsembleState) -> np.ndarray:
        s = state.structure
        vi = s.var_names.index(var)
        data = state.data[vi]  # [T, Y, X, M]
        if time_index is not None:
            ti = time_index % data.shape[0]  # support negative indices
            data = data[ti:ti + 1]
        mask = np.ones((s.ny, s.nx), dtype=bool)
        if lat_range is not None:
            mask &= (s.lat >= lat_range[0]) & (s.lat <= lat_range[1])
        if lon_range is not None:
            mask &= (s.lon >= lon_range[0]) & (s.lon <= lon_range[1])
        if not mask.any():
            raise ValueError("region selects no grid points")
        sel = torch.as_tensor(mask, device=data.device)
        return data[:, sel, :].mean(dim=(0, 1)).cpu().numpy()

    return metric


def metric_values(state: EnsembleState, metric: Metric) -> np.ndarray:
    """Resolve a metric spec to a per-member vector ``[M]`` (float64)."""
    j = metric(state) if callable(metric) else metric
    if isinstance(j, torch.Tensor):
        j = j.detach().cpu().numpy()
    j = np.asarray(j, dtype=np.float64)
    if j.shape != (state.structure.nmems,):
        raise ValueError(
            f"metric must give one value per member "
            f"({state.structure.nmems}), got shape {j.shape}"
        )
    return j


def _sig_mask(corr: np.ndarray, nmems: int, confidence: float) -> np.ndarray:
    """Two-sided test of nonzero correlation at the given confidence via
    the exact t transform ``t = r sqrt((M-2)/(1-r^2))`` (SciPy's t
    quantile)."""
    from scipy.stats import t as tdist

    r = np.clip(corr, -0.999999, 0.999999)
    t = np.abs(r) * np.sqrt((nmems - 2) / (1.0 - r * r))
    alpha = 1.0 - confidence
    return t > tdist.ppf(1.0 - alpha / 2.0, df=nmems - 2)


def ensemble_sensitivity(
    state: EnsembleState,
    metric: Metric,
    unbiased: bool = True,
    confidence: Optional[float] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Torn & Hakim (2008) ensemble sensitivity of ``J`` to every state
    element.

    ``metric`` is a per-member ``[M]`` array or a callable
    ``state -> [M]`` (see :func:`region_mean_metric`).  Returns, keyed by
    variable name, dicts with ``[ntimes, ny, nx]`` NumPy fields:
    ``sensitivity`` (``cov(x, J)/var(x)``), ``covariance``,
    ``correlation`` and, when ``confidence`` is given, ``significant``
    (two-sided t-test of a nonzero correlation).  The covariance and
    variance sweeps run on the state's device in its dtype; ``unbiased``
    selects the ddof=1 sample convention.
    """
    s = state.structure
    nm = s.nmems
    j = metric_values(state, metric)
    jp = torch.tensor(j - j.mean(), dtype=state.data.dtype,
                      device=state.device)

    x = state.to_vect()  # [Ns, M]
    xp = x - x.mean(dim=1, keepdim=True)
    ddof = 1 if unbiased else 0
    cov = _host64(xp @ jp / (nm - ddof))  # [Ns]
    varx = _host64((xp * xp).sum(dim=1) / (nm - ddof))
    del xp
    varj = float(np.sum((j - j.mean()) ** 2) / (nm - ddof))

    sens = np.divide(cov, varx, out=np.zeros_like(cov), where=varx > 0)
    denom = np.sqrt(varx * varj)
    corr = np.divide(cov, denom, out=np.zeros_like(cov), where=denom > 0)

    sig = _sig_mask(corr, nm, confidence) if confidence is not None else None
    shape = (s.nvars, s.ntimes, s.ny, s.nx)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for vi, name in enumerate(s.var_names):
        fields = {
            "sensitivity": sens.reshape(shape)[vi],
            "covariance": cov.reshape(shape)[vi],
            "correlation": corr.reshape(shape)[vi],
        }
        if sig is not None:
            fields["significant"] = sig.reshape(shape)[vi]
        out[name] = fields
    return out


def _obs_priors(state: EnsembleState, batch: ObservationBatch,
                time_weighting: str):
    """``(ye [No, M] on the state's device, qc_ok [No])`` through the
    cached taps."""
    s = state.structure
    taps = _fwd.build_taps_cached(
        s, batch.lats, batch.lons, batch.times_s, batch.var_indices(s),
        time_weighting=time_weighting, device=state.device)
    return _fwd.apply_taps_obj(state.to_vect(), taps), np.asarray(taps.qc_ok)


def observation_impact(
    state: EnsembleState,
    obs,
    metric: Metric,
    unbiased: bool = False,
    time_weighting: str = "linear",
) -> pd.DataFrame:
    """Predicted impact of each candidate observation on the scalar
    forecast metric ``J`` (Ancell & Hakim 2007): with obs-space prior
    ``ye`` and ``kdenom = var(ye) + R``,

    * ``dJ_mean_pred  =  cov(J, ye)/kdenom * (y - mean(ye))``
    * ``dJ_var_pred   = -cov(J, ye)^2 / kdenom``

    Ranking candidates by ``-dJ_var_pred`` is the classic
    observation-targeting recipe.  ``unbiased`` must match the filter's
    ``FilterConfig.unbiased_variance`` for the single-ob prediction to
    reproduce the serial EnSRF exactly (the covariance is always ddof=1,
    the reference's gain convention).  QC-failing obs get NaN predictions
    and ``qc_ok = False``.
    """
    nm = state.structure.nmems
    batch = ObservationBatch.coerce(obs)
    j = metric_values(state, metric)
    jp = torch.tensor(j - j.mean(), dtype=state.data.dtype,
                      device=state.device)

    ye, qc = _obs_priors(state, batch, time_weighting)
    mye_t = ye.mean(dim=1, keepdim=True)
    yep = ye - mye_t
    ddof_den = 1 if unbiased else 0
    varye = _host64((yep * yep).sum(dim=1) / (nm - ddof_den))
    covj = _host64(yep @ jp / (nm - 1))
    mye = _host64(mye_t[:, 0])

    kdenom = varye + np.asarray(batch.errors, dtype=np.float64)
    innov = np.asarray(batch.values, dtype=np.float64) - mye
    dj_mean = covj / kdenom * innov
    dj_var = -(covj * covj) / kdenom
    dj_mean[~qc] = np.nan
    dj_var[~qc] = np.nan

    return pd.DataFrame(
        {
            "obtype": list(batch.obtypes),
            "lat": np.asarray(batch.lats, dtype=np.float64),
            "lon": np.asarray(batch.lons, dtype=np.float64),
            "value": np.asarray(batch.values, dtype=np.float64),
            "ob error": np.asarray(batch.errors, dtype=np.float64),
            "prior mean": np.where(qc, mye, np.nan),
            "prior variance": np.where(qc, varye, np.nan),
            "metric cov": np.where(qc, covj, np.nan),
            "dJ_mean_pred": dj_mean,
            "dJ_var_pred": dj_var,
            "qc_ok": qc,
        }
    )


def greedy_obs_selection(
    state: EnsembleState,
    obs,
    metric: Metric,
    nselect: int,
    unbiased: bool = False,
    time_weighting: str = "linear",
) -> pd.DataFrame:
    """Greedy sequential observation-network design: repeatedly pick the
    candidate whose assimilation most reduces the forecast-metric
    variance, accounting for the obs already selected.

    After each pick the candidate ``ye`` matrix and the metric members get
    the exact serial square-root update (``Xap = Xbp - beta K (x) ye``,
    reference ``efa_xray/assimilation/ensrf.py:135-141``, restricted to
    the ``[No, M]`` tail), so later scores see the information already
    harvested.  For unlocalized obs and a linear metric the cumulative
    predictions are exact.  Obs-space only, host float64 (a planning tool,
    not a hot path).  Returns one row per pick, in pick order.
    ``unbiased`` mirrors ``FilterConfig.unbiased_variance``.
    """
    nm = state.structure.nmems
    batch = ObservationBatch.coerce(obs)
    if not 0 < nselect <= batch.nobs:
        raise ValueError(f"nselect must be in 1..{batch.nobs}")
    j = metric_values(state, metric)
    jp = j - j.mean()

    ye, qc = _obs_priors(state, batch, time_weighting)
    ye = _host64(ye)
    mye = ye.mean(axis=1)
    yep = ye - mye[:, None]
    errors = np.asarray(batch.errors, dtype=np.float64)
    values = np.asarray(batch.values, dtype=np.float64)
    ddof_den = 1 if unbiased else 0

    avail = qc.copy()
    rows = []
    cum_dj, cum_dvar = 0.0, 0.0
    for _ in range(nselect):
        varye = np.sum(yep * yep, axis=1) / (nm - ddof_den)
        kdenom = varye + errors
        covj = yep @ jp / (nm - 1)
        score = np.where(avail, covj * covj / kdenom, -np.inf)
        pick = int(np.argmax(score))
        if not np.isfinite(score[pick]):
            break  # no eligible candidates left
        avail[pick] = False

        kd, r = kdenom[pick], errors[pick]
        innov = values[pick] - mye[pick]
        dj_mean = covj[pick] / kd * innov
        dj_var = -covj[pick] * covj[pick] / kd
        cum_dj += dj_mean
        cum_dvar += dj_var
        rows.append(
            {
                "candidate": pick,
                "obtype": batch.obtypes[pick],
                "lat": float(batch.lats[pick]),
                "lon": float(batch.lons[pick]),
                "dJ_mean_step": dj_mean,
                "dJ_var_step": dj_var,
                "dJ_mean_cum": cum_dj,
                "dJ_var_cum": cum_dvar,
            }
        )

        # exact serial square-root update of the obs-space tail + metric
        ye_p = yep[pick].copy()
        kvec = (yep @ ye_p) / (nm - 1) / kd  # [No] gains onto candidates
        kj = covj[pick] / kd
        beta = 1.0 / (1.0 + math.sqrt(r / kd))
        mye = mye + kvec * innov
        yep = yep - beta * np.outer(kvec, ye_p)
        jp = jp - beta * kj * ye_p

    return pd.DataFrame(rows)
