"""Observation-space verification statistics.

Counterpart of ``efa_xray_tpu/postprocess/postprocess.py``
(``obs_assimilation_statistics`` :19): a per-observation pandas DataFrame
of prior and posterior obs-space means and variances plus metadata, with
the forward operator re-applied to prior and posterior in one gather each.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from efa_xray_tpu_torch.observation import forward as _fwd
from efa_xray_tpu_torch.observation.observation import ObservationBatch
from efa_xray_tpu_torch.state.ensemble import EnsembleState
from efa_xray_tpu_torch.utils import timeutil


def obs_assimilation_statistics(prior: EnsembleState, post: EnsembleState,
                                obs, time_weighting: str = "linear"
                                ) -> pd.DataFrame:
    """Per-ob statistics table (columns match the reference's)."""
    if not (isinstance(prior, EnsembleState) and isinstance(post, EnsembleState)):
        raise TypeError("prior and post must be EnsembleState")
    batch = ObservationBatch.coerce(obs)
    taps = _fwd.build_taps_cached(
        prior.structure, batch.lats, batch.lons, batch.times_s,
        batch.var_indices(prior.structure), time_weighting=time_weighting,
        device=prior.device)
    prior_ye = _fwd.apply_taps_obj(prior.to_vect(), taps).double().cpu().numpy()
    post_ye = _fwd.apply_taps_obj(post.to_vect(), taps).double().cpu().numpy()

    batch.materialize_diagnostics()
    assimilated = batch.assimilated
    if assimilated is None:
        assimilated = np.zeros(batch.nobs, dtype=bool)
    lead = timeutil.lead_hours(batch.times_s, prior.structure.times_s[0])
    df = pd.DataFrame({
        "validtime": timeutil.to_datetime64(batch.times_s),
        "flead": lead,
        "lat": batch.lats,
        "lon": batch.lons,
        "obtype": batch.obtypes,
        "description": batch.descriptions,
        "ob error": batch.errors,
        "value": batch.values,
        "assimilated": np.asarray(assimilated, dtype=bool),
        "prior mean": prior_ye.mean(axis=1),
        "post mean": post_ye.mean(axis=1),
        "prior variance": prior_ye.var(axis=1),
        "post variance": post_ye.var(axis=1),
    })
    if batch.qc_outlier is not None:
        df["outlier"] = np.asarray(batch.qc_outlier, dtype=bool)
    return df
