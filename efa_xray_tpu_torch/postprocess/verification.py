"""Ensemble verification statistics in observation space.

Counterpart of ``efa_xray_tpu/postprocess/verification.py``:
``rank_histogram`` :67, ``crps`` :84 and ``innovation_consistency`` :128.
The obs-space ensemble estimates come from the port's forward-operator
taps, gathered on the state's device; the statistics over them are NumPy
float64 on the host, as in the JAX package.  ``field_verification`` and
``desroziers_diagnostics`` (pandas tables) are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from efa_xray_tpu_torch.observation import forward as _fwd
from efa_xray_tpu_torch.observation.observation import ObservationBatch
from efa_xray_tpu_torch.state.ensemble import EnsembleState


def _obs_space(state: EnsembleState, batch: ObservationBatch,
               time_weighting: str):
    """``(ye [nobs, nmems] float64 NumPy, qc_ok [nobs])``: the members'
    estimates of every ob, through the cached taps."""
    s = state.structure
    taps = _fwd.build_taps_cached(
        s, batch.lats, batch.lons, batch.times_s, batch.var_indices(s),
        time_weighting=time_weighting, device=state.device)
    ye = _fwd.apply_taps_obj(state.to_vect(), taps)
    return ye.detach().cpu().numpy().astype(np.float64), np.asarray(taps.qc_ok)


def rank_histogram(state: EnsembleState, obs,
                   time_weighting: str = "linear") -> np.ndarray:
    """Observation-space rank histogram: the rank of each observed value
    within the members' estimates.  ``counts`` of length ``nmems + 1``
    (flat for a reliable ensemble)."""
    batch = ObservationBatch.coerce(obs)
    ye, ok = _obs_space(state, batch, time_weighting)
    ranks = (ye[ok] < batch.values[ok, None]).sum(axis=1)
    return np.bincount(ranks, minlength=state.structure.nmems + 1)


def crps(state: EnsembleState, obs, time_weighting: str = "linear",
         fair: bool = False):
    """Observation-space continuous ranked probability score: per ob, the
    exact ensemble CRPS ``mean_j |ye_ij - y_i| - 0.5 c mean_jk |ye_ij -
    ye_ik|`` (Gneiting & Raftery 2007, eq. 21), ``c = 1``, or ``M / (M -
    1)`` for the fair score (Ferro et al. 2008).  QC-failing obs are
    skipped.  Returns ``(per_ob, mean)``: a length-``nobs`` array (NaN
    where QC failed) and the mean over the QC-passing obs."""
    batch = ObservationBatch.coerce(obs)
    ye, ok = _obs_space(state, batch, time_weighting)
    m = ye.shape[1]
    if fair and m < 2:
        raise ValueError("fair CRPS needs at least 2 members")
    mae = np.mean(np.abs(ye - batch.values[:, None]), axis=1)
    # mean_jk |x_j - x_k| = (2 / M^2) sum_j (2j + 1 - M) x_(j)
    srt = np.sort(ye, axis=1)
    w = 2.0 * np.arange(m) + 1.0 - m
    spread_term = 2.0 * (srt @ w) / (m * m)
    c = m / (m - 1.0) if fair else 1.0
    per_ob = np.where(ok, mae - 0.5 * c * spread_term, np.nan)
    return per_ob, float(np.mean(per_ob[ok]))


def innovation_consistency(batch: ObservationBatch) -> Dict[str, float]:
    """After a filter run: ``mean(d^2)`` against ``mean(prior_var + R)``
    over the assimilated obs; a ratio above 1 signals an under-dispersive
    prior."""
    if batch.prior_mean is None:
        raise ValueError("Run the filter first (no prior_mean diagnostics)")
    batch.materialize_diagnostics()
    ok = (np.ones(batch.nobs, dtype=bool) if batch.assimilated is None
          else np.asarray(batch.assimilated))
    d2 = (batch.values[ok] - batch.prior_mean[ok]) ** 2
    expected = batch.prior_var[ok] + batch.errors[ok]
    return {
        "mean_innov_sq": float(np.mean(d2)),
        "mean_expected": float(np.mean(expected)),
        "consistency_ratio": float(np.mean(d2) / np.mean(expected)),
        "nobs": int(ok.sum()),
    }
