"""Observation records and the struct-of-arrays batch.

Counterpart of ``efa_xray_tpu/observation/observation.py``:
``Observation`` :26 with ``estimate``, ``distance_to_state`` and
``localize`` :75-108, ``map_localization`` :111-190 (matplotlib, taken
lazily; the coastlines of the port's copy of ``utils/coastlines.py``) and
``ObservationBatch`` :201 with ``coerce``
:283, ``take`` :288, ``spatial_sort`` :307, ``var_indices`` :327,
``writeback`` :363, ``to_observations`` :381, ``to_dataframe`` :411 and
``from_dataframe`` :441.  All per-ob arrays are host NumPy; the filter
moves them to its device at the assimilation boundary and writes its
diagnostics back as NumPy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from efa_xray_tpu_torch.observation import localization as _loc
from efa_xray_tpu_torch.observation.localization import hilbert3d_np
from efa_xray_tpu_torch.utils import timeutil


class Observation:
    """One point observation (reference parity:
    ``efa_xray/observation/observation.py:17-36``)."""

    def __init__(
        self,
        value=None,
        obtype=None,
        time=None,
        error=None,
        lat=None,
        lon=None,
        vert=None,
        prior_mean=None,
        post_mean=None,
        prior_var=None,
        post_var=None,
        assimilate_this=False,
        description=None,
        localize_radius=None,
        vert_localize_radius=None,
        forward_operator=None,
    ):
        self.value = value
        self.obtype = obtype
        self.time = time
        self.error = error  # observation error VARIANCE (R)
        self.lat = lat
        self.lon = lon
        self.vert = vert
        self.prior_mean = prior_mean
        self.post_mean = post_mean
        self.prior_var = prior_var
        self.post_var = post_var
        self.assimilate_this = assimilate_this
        self.assimilated = False
        # Set True by the filter when FilterConfig.outlier_threshold
        # rejects this ob (innovation-based gross-error QC).
        self.outlier = False
        self.description = description
        self.localize_radius = localize_radius
        # Vertical GC halfwidth in the same units as ``vert`` (extension;
        # the reference stores ``vert`` but never localizes on it).
        self.vert_localize_radius = vert_localize_radius
        # Optional custom H: a callable ``state -> ye[nmems]`` — the
        # pluggable-operator hook the reference's docstring promises but
        # never implements (``observation/observation.py:44-46``); the
        # filter evaluates it in ``Assimilation.compute_ob_priors``.
        self.forward_operator = forward_operator

    def estimate(self, state):
        """Ensemble estimate of this ob, H(x) for every member (reference
        ``efa_xray/observation/observation.py:40-50``): the custom
        ``forward_operator`` when set, else the state's space/time
        interpolation of the matching variable."""
        if self.forward_operator is not None:
            return self.forward_operator(state)
        return state.interpolate(self.obtype, self.time, self.lat, self.lon)

    def distance_to_state(self, state):
        """Great-circle km from this ob to every grid point of ``state``
        (a tensor ``[ny, nx]`` on the state's device)."""
        return state.distance_to_point(self.lat, self.lon)

    def localize(self, state, type="GC", full_state=False):
        """Localization weights (NumPy float64) from this ob to a state's
        grid or to a list of observations (reference
        ``efa_xray/observation/observation.py:59-87``);
        ``localize_radius=None`` gives ones."""
        halfwidth = self.localize_radius
        if isinstance(state, (list, tuple)):
            f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64))
            distances = _loc.haversine(
                (f64(self.lat), f64(self.lon)),
                (f64([ob.lat for ob in state]), f64([ob.lon for ob in state])))
        else:
            distances = state.distance_to_point(self.lat, self.lon)
        distances = np.asarray(distances.detach().cpu().numpy(), np.float64)
        if halfwidth is None:
            return np.ones(distances.shape)
        if type == "GC":
            return _loc.gaspari_cohn_np(distances, halfwidth)
        raise ValueError(f"Unknown localization type {type!r}")

    def map_localization(self, state, projection=None, type="GC", ax=None,
                         coastlines="auto"):
        """Plot the localization footprint (reference:
        ``efa_xray/observation/observation.py:94-115``, which needed
        Basemap; here plain matplotlib / any callable projection).

        ``coastlines``: draw coastline outlines (the reference's
        ``drawcoastlines``/``drawcountries``, ``observation.py:109-111``).
        A geo toolkit is used when importable — cartopy preferred,
        Basemap as fallback; when neither is installed, ``"auto"`` /
        ``True`` fall back to the built-in orientation-grade world outline
        (:mod:`efa_xray_tpu_torch.utils.coastlines`).  A path or ``(N, 2)``
        lon/lat array draws those user-supplied NaN-separated polylines
        instead (see :func:`utils.coastlines.load_segments` for the
        formats).  ``False`` disables."""
        import matplotlib.pyplot as plt

        localization = np.asarray(self.localize(state, type=type))
        if projection is not None:
            gx, gy = state.project_coordinates(projection)
        else:
            gx, gy = np.asarray(state.structure.lon), np.asarray(state.structure.lat)
        coast_auto = coastlines is True or (
            isinstance(coastlines, str) and coastlines == "auto"
        )
        if ax is None:
            if coast_auto and projection is None:
                try:  # lat/lon axes: a cartopy GeoAxes gives real outlines
                    import cartopy.crs as ccrs

                    _, ax = plt.subplots(
                        figsize=(10, 8),
                        subplot_kw={"projection": ccrs.PlateCarree()},
                    )
                except ImportError:
                    _, ax = plt.subplots(figsize=(10, 8))
            else:
                _, ax = plt.subplots(figsize=(10, 8))
        pm = ax.pcolormesh(gx, gy, localization.reshape(gx.shape), vmin=0.0, vmax=1.0)
        if coastlines is not False and coastlines is not None:
            from efa_xray_tpu_torch.utils import coastlines as _coast

            segments = None  # builtin coarse world outline
            drew = False
            if coast_auto:
                if hasattr(ax, "coastlines"):  # cartopy GeoAxes
                    try:
                        import cartopy.feature as cfeature

                        ax.coastlines()
                        ax.add_feature(cfeature.BORDERS, linewidth=0.5)
                        drew = True
                    except Exception:
                        pass
                if not drew and projection is not None and hasattr(
                    projection, "drawcoastlines"
                ):  # a Basemap instance doubles as the projection callable
                    try:
                        projection.drawcoastlines(ax=ax)
                        projection.drawcountries(ax=ax)
                        drew = True
                    except Exception:
                        pass
            else:  # a path or an (N, 2) lon/lat array of polylines
                segments = coastlines
            if not drew:
                lon360 = projection is None and np.nanmax(gx) > 180.0
                _coast.draw_coastlines(
                    ax, segments=segments, projection=projection,
                    lon360=lon360,
                )
                if projection is None:
                    # keep the view on the data, not the world outline
                    ax.set_xlim(float(np.nanmin(gx)), float(np.nanmax(gx)))
                    ax.set_ylim(float(np.nanmin(gy)), float(np.nanmax(gy)))
        plt.colorbar(pm, ax=ax)
        ax.set_title(
            "Localization Weights for {:s} ({:5.3f},{:5.3f})".format(
                str(self.description), self.lat, self.lon
            )
        )
        return ax

    def __repr__(self):
        return (
            f"Observation({self.obtype!r}, value={self.value}, "
            f"lat={self.lat}, lon={self.lon}, time={self.time})"
        )


@dataclasses.dataclass
class ObservationBatch:
    """Struct-of-arrays view of N observations (all host NumPy; converted
    to device arrays at the assimilation boundary)."""

    values: np.ndarray  # float64 [N]
    errors: np.ndarray  # float64 [N], observation error variance R
    lats: np.ndarray  # float64 [N]
    lons: np.ndarray  # float64 [N]
    times_s: np.ndarray  # int64 [N] epoch seconds
    obtypes: List[str]  # length N variable names
    localize_radius: np.ndarray  # float64 [N]; np.inf == no localization
    assimilate_flags: np.ndarray  # bool [N]
    verts: np.ndarray  # float64 [N] vertical coordinate (NaN when absent)
    descriptions: List[Optional[str]]
    vert_radius: np.ndarray = None  # float64 [N] vertical halfwidth; inf = off
    # True where the ob carries a custom forward_operator (its obtype need
    # not name a state variable and it bypasses interpolation QC).
    custom_operator: np.ndarray = None

    # Result slots (filled by the filter)
    prior_mean: Optional[np.ndarray] = None
    prior_var: Optional[np.ndarray] = None
    post_mean: Optional[np.ndarray] = None
    post_var: Optional[np.ndarray] = None
    assimilated: Optional[np.ndarray] = None
    # True where FilterConfig.outlier_threshold rejected an otherwise-
    # assimilable ob (innovation-based gross-error QC / background check).
    qc_outlier: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.vert_radius is None:
            self.vert_radius = np.full(len(self.values), np.inf, dtype=np.float64)
        if self.custom_operator is None:
            self.custom_operator = np.zeros(len(self.values), dtype=bool)

    def __len__(self) -> int:
        return len(self.values)

    @property
    def nobs(self) -> int:
        return len(self.values)

    @classmethod
    def from_observations(cls, obs: Sequence[Observation]) -> "ObservationBatch":
        n = len(obs)
        radius = np.full(n, np.inf, dtype=np.float64)
        vert_radius = np.full(n, np.inf, dtype=np.float64)
        for i, ob in enumerate(obs):
            if ob.localize_radius is not None:
                radius[i] = float(ob.localize_radius)
            if getattr(ob, "vert_localize_radius", None) is not None:
                vert_radius[i] = float(ob.vert_localize_radius)
        return cls(
            values=np.asarray([ob.value for ob in obs], dtype=np.float64),
            errors=np.asarray([ob.error for ob in obs], dtype=np.float64),
            lats=np.asarray([ob.lat for ob in obs], dtype=np.float64),
            lons=np.asarray([ob.lon for ob in obs], dtype=np.float64),
            times_s=timeutil.to_epoch_seconds([ob.time for ob in obs]),
            obtypes=[ob.obtype for ob in obs],
            localize_radius=radius,
            assimilate_flags=np.asarray(
                [bool(ob.assimilate_this) for ob in obs], dtype=bool
            ),
            verts=np.asarray(
                [np.nan if ob.vert is None else float(ob.vert) for ob in obs],
                dtype=np.float64,
            ),
            descriptions=[ob.description for ob in obs],
            vert_radius=vert_radius,
            custom_operator=np.asarray(
                [getattr(ob, "forward_operator", None) is not None for ob in obs],
                dtype=bool,
            ),
            # carry result slots already present on the objects (the
            # reference postprocess reads ob.assimilated, postprocess.py:29)
            assimilated=np.asarray(
                [bool(getattr(ob, "assimilated", False)) for ob in obs], dtype=bool
            ),
        )

    @classmethod
    def coerce(cls, obs) -> "ObservationBatch":
        if isinstance(obs, ObservationBatch):
            return obs
        return cls.from_observations(list(obs))

    def take(self, order) -> "ObservationBatch":
        """Reordered copy: every per-ob array/list (including any filled
        result slots) permuted by ``order``.  Device-resident result
        slots stay device arrays (the gather happens on device — no host
        sync)."""
        order = np.asarray(order)

        def perm(v):
            if v is None:
                return None
            if isinstance(v, list):
                return [v[i] for i in order]
            return v[order]  # np stays np, a tensor stays a tensor

        return dataclasses.replace(
            self, **{f.name: perm(getattr(self, f.name))
                     for f in dataclasses.fields(self)}
        )

    def spatial_sort(self) -> Tuple["ObservationBatch", np.ndarray]:
        """``(sorted_batch, order)`` with obs in spherical-Hilbert
        spatial-locality order.

        Observation order is the CALLER's choice in a serial filter (the
        analysis is weakly order-dependent; the reference demo shuffles
        it, ``efa_demo.ipynb`` cell 11) — and spatially sorted obs are
        the THROUGHPUT choice: the fused kernels cull (row-tile, obs
        panel) pairs whose localization weights are provably zero, which
        only engages when consecutive obs are spatially compact (measured
        at the 500k-ob capacity point: random order 16.4 s, Hilbert
        order 8.35 s — docs/recipes.md).  Diagnostics
        come back in the sorted order; invert with
        ``batch.take(np.argsort(order))``."""
        order = np.argsort(hilbert3d_np(self.lats, self.lons),
                           kind="stable")
        return self.take(order), order

    def var_indices(self, structure) -> np.ndarray:
        """State-variable index per ob.  Custom-operator obs map to 0: their
        interpolation taps are placeholders that compute_ob_priors
        overrides, so their obtype need not name a state variable."""
        return np.asarray(
            [
                0 if self.custom_operator[i] else structure.var_index(t)
                for i, t in enumerate(self.obtypes)
            ],
            dtype=np.int32,
        )

    def materialize_diagnostics(self) -> None:
        """Convert any tensor result slots to host float64/bool NumPy."""
        for n in ("prior_mean", "prior_var", "post_mean", "post_var",
                  "assimilated", "qc_outlier"):
            v = getattr(self, n)
            if isinstance(v, torch.Tensor):
                dtype = bool if n in ("assimilated", "qc_outlier") else np.float64
                setattr(self, n, v.detach().cpu().numpy().astype(dtype))

    def writeback(self, obs: Sequence[Observation]) -> None:
        """Copy filter diagnostics back onto user Observation objects,
        mirroring the in-place attribute writes of the reference loop
        (``efa_xray/assimilation/ensrf.py:66-70,144-149``)."""
        self.materialize_diagnostics()
        for i, ob in enumerate(obs):
            ob.prior_mean = None if self.prior_mean is None else float(self.prior_mean[i])
            ob.prior_var = None if self.prior_var is None else float(self.prior_var[i])
            ob.outlier = (
                False if self.qc_outlier is None else bool(self.qc_outlier[i])
            )
            if self.assimilated is not None and self.assimilated[i]:
                ob.post_mean = float(self.post_mean[i])
                ob.post_var = float(self.post_var[i])
                ob.assimilated = True
            else:
                ob.assimilated = False

    def to_observations(self) -> List[Observation]:
        """One :class:`Observation` per ob, with the filter's diagnostics
        written back when it has run."""
        out = []
        for i in range(self.nobs):
            out.append(Observation(
                value=float(self.values[i]),
                obtype=self.obtypes[i],
                time=timeutil.to_datetime64(self.times_s[i]),
                error=float(self.errors[i]),
                lat=float(self.lats[i]),
                lon=float(self.lons[i]),
                vert=None if np.isnan(self.verts[i]) else float(self.verts[i]),
                assimilate_this=bool(self.assimilate_flags[i]),
                description=self.descriptions[i],
                localize_radius=(None if np.isinf(self.localize_radius[i])
                                 else float(self.localize_radius[i])),
                vert_localize_radius=(None if np.isinf(self.vert_radius[i])
                                      else float(self.vert_radius[i]))))
        if self.prior_mean is not None:
            self.writeback(out)
        return out

    def to_dataframe(self):
        """Pandas view of the batch (one row per ob), with the result slots
        when the filter has run; inverse of :meth:`from_dataframe`."""
        import pandas as pd

        self.materialize_diagnostics()
        cols = {
            "value": np.asarray(self.values, dtype=np.float64),
            "error": np.asarray(self.errors, dtype=np.float64),
            "lat": np.asarray(self.lats, dtype=np.float64),
            "lon": np.asarray(self.lons, dtype=np.float64),
            "time": timeutil.to_datetime64(self.times_s),
            "obtype": list(self.obtypes),
            "localize_radius": np.asarray(self.localize_radius,
                                          dtype=np.float64),
            "assimilate_this": np.asarray(self.assimilate_flags, dtype=bool),
            "vert": np.asarray(self.verts, dtype=np.float64),
            "vert_radius": np.asarray(self.vert_radius, dtype=np.float64),
            "description": list(self.descriptions),
        }
        for name in ("prior_mean", "prior_var", "post_mean", "post_var",
                     "assimilated", "qc_outlier"):
            val = getattr(self, name)
            if val is not None:
                cols[name] = np.asarray(val)
        return pd.DataFrame(cols)

    @classmethod
    def from_dataframe(cls, df) -> "ObservationBatch":
        """A batch from a DataFrame with (at least) the columns ``value,
        error, lat, lon, time, obtype``; optional ``localize_radius``
        (default inf), ``assimilate_this`` (True), ``vert`` (NaN),
        ``vert_radius`` (inf) and ``description`` (None)."""
        n = len(df)

        def col(name, default, dtype=np.float64):
            if name in df.columns:
                return np.asarray(df[name], dtype=dtype)
            return np.full(n, default, dtype=dtype)

        descriptions = (
            [None if (d is None or (isinstance(d, float) and np.isnan(d)))
             else str(d) for d in df["description"]]
            if "description" in df.columns else [None] * n)
        return cls(
            values=np.asarray(df["value"], dtype=np.float64),
            errors=np.asarray(df["error"], dtype=np.float64),
            lats=np.asarray(df["lat"], dtype=np.float64),
            lons=np.asarray(df["lon"], dtype=np.float64),
            times_s=timeutil.to_epoch_seconds(
                np.asarray(df["time"], dtype="datetime64[s]")),
            obtypes=[str(t) for t in df["obtype"]],
            localize_radius=col("localize_radius", np.inf),
            assimilate_flags=col("assimilate_this", True, dtype=bool),
            verts=col("vert", np.nan),
            descriptions=descriptions,
            vert_radius=col("vert_radius", np.inf),
        )
