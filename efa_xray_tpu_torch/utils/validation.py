"""Input validation at the framework boundary.

NumPy only; a copy of ``efa_xray_tpu/utils/validation.py:1-68``.

The reference's only error handling is a silent try/except around an
inflation file open (``adaptive_inflation.py:24-28``) and a printed
``None`` for out-of-range interpolation (``ensemble.py:205-208``) — bad
inputs surface as cryptic NumPy errors deep in the update loop.  Here the
host-side boundary validates once, before anything is traced, so failures
are immediate and named.  (QC of individually-bad observations remains a
mask, not an exception — see ``ObsTaps.qc_ok``.)
"""

from __future__ import annotations

import numpy as np


class ValidationError(ValueError):
    pass


def validate_state(state) -> None:
    s = state.structure
    if s.nmems < 2:
        raise ValidationError(
            f"Ensemble needs >= 2 members for covariances; got {s.nmems}"
        )
    if state.data.shape != s.shape:
        raise ValidationError(
            f"State data shape {state.data.shape} != structure {s.shape}"
        )
    if not np.all(np.diff(s.times_s) > 0):
        raise ValidationError("validtime must be strictly increasing")
    if np.any(np.abs(s.lat) > 90.0):
        raise ValidationError("latitudes must be within [-90, 90]")


def validate_obs(batch, structure) -> None:
    n = batch.nobs
    for name, arr in (
        ("values", batch.values),
        ("errors", batch.errors),
        ("lats", batch.lats),
        ("lons", batch.lons),
    ):
        a = np.asarray(arr)
        if a.shape != (n,):
            raise ValidationError(f"obs.{name} has shape {a.shape}, want ({n},)")
        if not np.isfinite(a).all():
            bad = np.flatnonzero(~np.isfinite(a))[:5]
            raise ValidationError(f"obs.{name} non-finite at indices {bad.tolist()}")
    if np.any(np.asarray(batch.errors) <= 0):
        bad = np.flatnonzero(np.asarray(batch.errors) <= 0)[:5]
        raise ValidationError(
            f"observation error variances must be > 0 (indices {bad.tolist()})"
        )
    if np.any(np.abs(np.asarray(batch.lats)) > 90.0):
        raise ValidationError("observation latitudes must be within [-90, 90]")
    radii = np.asarray(batch.localize_radius)
    if np.any(radii <= 0):
        raise ValidationError("localize_radius must be positive (or None/inf)")
    custom = np.asarray(batch.custom_operator)
    for i, t in enumerate(batch.obtypes):
        if custom[i]:
            continue  # custom forward operators define their own obtype
        if t not in structure.var_names:
            raise KeyError(
                f"Variable {t!r} not in state (has {structure.var_names})"
            )
