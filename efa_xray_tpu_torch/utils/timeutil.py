"""Datetime <-> integer-seconds conversions.

NumPy only; a copy of ``efa_xray_tpu/utils/timeutil.py:1-64``.

The reference keeps ``validtime`` as ``np.datetime64`` inside the xarray
Dataset and does interpolation arithmetic in ``np.timedelta64`` seconds
(``efa_xray/state/ensemble.py:201-224``).  On device we need plain numbers,
so the canonical representation here is **int64 seconds since the Unix
epoch**, converted at the host boundary.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

_EPOCH = np.datetime64("1970-01-01T00:00:00", "s")


def to_epoch_seconds(times) -> np.ndarray:
    """Convert datetimes (datetime64 array / list of datetime / scalars /
    already-numeric seconds) to an int64 epoch-seconds array."""
    arr = np.asarray(times)
    if np.issubdtype(arr.dtype, np.datetime64):
        return (arr.astype("datetime64[s]") - _EPOCH).astype(np.int64)
    if arr.dtype == object:
        out = np.empty(arr.shape, dtype=np.int64)
        flat = arr.ravel()
        oflat = out.ravel()
        for i, t in enumerate(flat):
            oflat[i] = _scalar_to_seconds(t)
        return out
    # Already numeric: interpret as seconds.
    return arr.astype(np.int64)


def _scalar_to_seconds(t) -> int:
    if isinstance(t, np.datetime64):
        return int((t.astype("datetime64[s]") - _EPOCH).astype(np.int64))
    if isinstance(t, _dt.datetime):
        if t.tzinfo is not None:
            return int(t.timestamp())
        return int((t - _dt.datetime(1970, 1, 1)).total_seconds())
    if isinstance(t, (int, float, np.integer, np.floating)):
        return int(t)
    # pandas.Timestamp and friends expose .to_datetime64()
    if hasattr(t, "to_datetime64"):
        return _scalar_to_seconds(t.to_datetime64())
    raise TypeError(f"Cannot interpret {type(t)!r} as a time")


def to_datetime64(seconds) -> np.ndarray:
    """Convert int64 epoch seconds back to a datetime64[s] array."""
    return _EPOCH + np.asarray(seconds, dtype=np.int64).astype("timedelta64[s]")


def lead_hours(valid_seconds, init_seconds) -> np.ndarray:
    """Forecast lead time in hours (float) relative to an initialization time.

    Mirrors the lead-time computation in the reference postprocess layer
    (``efa_xray/postprocess/postprocess.py:22``).
    """
    return (
        np.asarray(valid_seconds, dtype=np.float64) - np.float64(init_seconds)
    ) / 3600.0
