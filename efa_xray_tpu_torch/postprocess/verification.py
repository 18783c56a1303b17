"""Ensemble verification statistics in observation space.

Counterpart of ``efa_xray_tpu/postprocess/verification.py``:
``field_verification`` :28, ``rank_histogram`` :67, ``crps`` :84,
``innovation_consistency`` :128 and ``desroziers_diagnostics`` :149.
The obs-space ensemble estimates come from the port's forward-operator
taps, gathered on the state's device; the statistics over them are NumPy
float64 on the host, as in the JAX package.  ``field_verification``
reduces the state on its device (float64), so that a large state never
crosses to the host; ``desroziers_diagnostics`` reads the per-ob table of
``obs_assimilation_statistics`` (pandas).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pandas as pd
import torch

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


def field_verification(state: EnsembleState, truth) -> pd.DataFrame:
    """Per-variable, per-validtime RMSE, bias, spread and ensemble CRPS
    against a truth field ``[nvars, ntimes, ny, nx]`` (or ``[ntimes, ny,
    nx, nvars]``, transposed), a NumPy array or a tensor."""
    s = state.structure
    tr = torch.as_tensor(truth if isinstance(truth, torch.Tensor)
                         else np.asarray(truth))
    if tuple(tr.shape) == (s.ntimes, s.ny, s.nx, s.nvars):
        tr = tr.permute(3, 0, 1, 2)
    if tuple(tr.shape) != (s.nvars, s.ntimes, s.ny, s.nx):
        raise ValueError(f"truth shape {tuple(tr.shape)} does not match "
                         f"state {s.shape[:-1]}")
    tr = tr.to(device=state.device, dtype=torch.float64)
    mean = state.ensemble_mean().double()
    spread = state.ensemble_spread()
    m = s.nmems
    w = 2.0 * torch.arange(m, dtype=torch.float64,
                           device=state.device) + 1.0 - m
    rows = []
    for vi, name in enumerate(s.var_names):
        for ti, t in enumerate(s.times64()):
            err = mean[vi, ti] - tr[vi, ti]
            ens = state.data[vi, ti].double().reshape(-1, m)
            mae = torch.mean(torch.abs(ens - tr[vi, ti].reshape(-1, 1)))
            pair = 2.0 * torch.mean(torch.sort(ens, dim=1).values @ w) / (
                m * m)
            rows.append({
                "variable": name,
                "validtime": t,
                "rmse": float(torch.sqrt(torch.mean(err ** 2))),
                "bias": float(torch.mean(err)),
                "spread": float(torch.mean(spread[vi, ti])),
                "crps": float(mae - 0.5 * pair),
            })
    return pd.DataFrame(rows)


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


def desroziers_diagnostics(stats: pd.DataFrame,
                           group_by: Optional[str] = "obtype"
                           ) -> pd.DataFrame:
    """Desroziers et al. (2005) consistency diagnostics from the per-ob
    table of ``obs_assimilation_statistics``: with ``d_b = y - H(x_b)``
    and ``d_a = y - H(x_a)``, ``E[d_a d_b] = R``, ``E[(d_b - d_a) d_b] =
    HBH^T`` and ``E[d_b^2] = HBH^T + R`` for a filter with correct R and
    HBH^T.  One row per ``group_by`` group (or one "all" row)."""
    df = stats[stats["assimilated"].astype(bool)]
    if len(df) == 0:
        raise ValueError("No assimilated observations in the table")

    def one(g: pd.DataFrame) -> Dict[str, float]:
        d_b = np.asarray(g["value"] - g["prior mean"], dtype=np.float64)
        d_a = np.asarray(g["value"] - g["post mean"], dtype=np.float64)
        r_assigned = float(np.mean(g["ob error"]))
        r_est = float(np.mean(d_a * d_b))
        hbht_est = float(np.mean((d_b - d_a) * d_b))
        total = float(np.mean(d_b * d_b))
        prior_var = float(np.mean(g["prior variance"]))
        return {
            "nobs": int(len(g)),
            "R_assigned": r_assigned,
            "R_estimated": r_est,
            "R_ratio": r_est / r_assigned if r_assigned > 0 else np.nan,
            "HBHT_estimated": hbht_est,
            "prior_var_ensemble": prior_var,
            "innov_var": total,
            "innov_var_expected": prior_var + r_assigned,
            "innov_consistency": (total / (prior_var + r_assigned)
                                  if prior_var + r_assigned > 0 else np.nan),
        }

    if group_by is None:
        rows = {"all": one(df)}
    else:
        rows = {k: one(g) for k, g in df.groupby(group_by)}
    out = pd.DataFrame.from_dict(rows, orient="index")
    out.index.name = group_by or "group"
    return out
