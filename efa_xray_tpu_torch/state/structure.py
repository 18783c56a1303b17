"""Static description of an ensemble state's geometry and labels.

Counterpart of ``efa_xray_tpu/state/structure.py``: ``StateMeta`` :45,
``StateStructure`` :78 with ``build`` :113, the size accessors :136-179,
``flat_index`` :257, ``row_latlon`` :262, ``row_vert`` :274 and
``row_latlon_device`` :202 and ``spatial_order_device`` :227, which here
cache per device (and dtype), ``with_nmems`` :285 and ``subset`` :288.

Canonical dense layout: ``data[var, time, y, x, member]``; the flattened
state vector is C-order over ``(var, time, y, x)`` with members last (the
reference's ``to_vect``, ``efa_xray/state/ensemble.py:110-114``).  1-D
location grids are represented with ``nx == 1``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from efa_xray_tpu_torch.utils import timeutil


@dataclasses.dataclass
class StateMeta:
    """Carried metadata: global attrs, per-variable attrs, and extra
    (non-canonical) coordinate variables.

    The reference's state IS an ``xarray.Dataset``
    (``efa_xray/state/ensemble.py:15``), so arbitrary attributes and extra
    coordinates ride along for free there; here they live on the
    structure, flow untouched through every update (``from_vect`` reuses
    the prior's structure).  Never consumed by any computation.
    """

    # Global dataset attributes, e.g. {"title": ..., "history": ...}.
    attrs: dict = dataclasses.field(default_factory=dict)
    # Per-state-variable attributes, e.g. {"T2M": {"units": "K"}}.
    var_attrs: dict = dataclasses.field(default_factory=dict)
    # Extra coordinate variables: {name: (dims tuple, ndarray, attrs dict)}.
    coords: dict = dataclasses.field(default_factory=dict)

    def copy(self) -> "StateMeta":
        return StateMeta(
            attrs=dict(self.attrs),
            var_attrs={k: dict(v) for k, v in self.var_attrs.items()},
            coords={k: (tuple(d), np.asarray(a), dict(at))
                    for k, (d, a, at) in self.coords.items()},
        )

    def __bool__(self) -> bool:
        return bool(self.attrs or self.var_attrs or self.coords)


@dataclasses.dataclass(frozen=True)
class StateStructure:
    """Immutable geometry + labels for an ensemble state."""

    var_names: Tuple[str, ...]
    times_s: np.ndarray  # int64 epoch seconds, shape [T], ascending
    lat: np.ndarray  # float64, shape [Y, X]
    lon: np.ndarray  # float64, shape [Y, X]
    grid_is_2d: bool  # False when built from a 1-D location list
    nmems: int
    # Optional vertical coordinate per VARIABLE (e.g. pressure level in hPa
    # for level-stacked variables like T_500/T_850); enables vertical
    # localization.  None when the state has no vertical structure.
    var_verts: tuple = None
    # Carried metadata (attrs / var attrs / extra coords); deliberately
    # EXCLUDED from __eq__/__hash__ — it never enters computation, so it
    # must not fragment jit caches keyed on the structure.
    meta: "StateMeta" = None

    def __post_init__(self):
        object.__setattr__(self, "var_names", tuple(self.var_names))
        times = timeutil.to_epoch_seconds(self.times_s)
        if times.ndim != 1:
            raise ValueError("times must be 1-D")
        lat = np.asarray(self.lat, dtype=np.float64)
        lon = np.asarray(self.lon, dtype=np.float64)
        if lat.ndim == 1:
            lat = lat[:, None]
            lon = lon[:, None]
        if lat.shape != lon.shape or lat.ndim != 2:
            raise ValueError(f"lat/lon shape mismatch: {lat.shape} vs {lon.shape}")
        for arr, name in ((times, "times_s"), (lat, "lat"), (lon, "lon")):
            arr.setflags(write=False)
            object.__setattr__(self, name, arr)

    @classmethod
    def build(
        cls,
        var_names: Sequence[str],
        times,
        lat,
        lon,
        nmems: int,
        var_verts=None,
        meta: "StateMeta" = None,
    ) -> "StateStructure":
        lat_arr = np.asarray(lat, dtype=np.float64)
        return cls(
            var_names=tuple(var_names),
            times_s=timeutil.to_epoch_seconds(times),
            lat=lat_arr,
            lon=np.asarray(lon, dtype=np.float64),
            grid_is_2d=lat_arr.ndim == 2,
            nmems=int(nmems),
            var_verts=None if var_verts is None else tuple(float(v) for v in var_verts),
            meta=meta,
        )

    # --- size accessors (reference: efa_xray/state/ensemble.py:40-56) ---
    @property
    def nvars(self) -> int:
        return len(self.var_names)

    @property
    def ntimes(self) -> int:
        return len(self.times_s)

    @property
    def ny(self) -> int:
        return self.lat.shape[0]

    @property
    def nx(self) -> int:
        return self.lat.shape[1]

    @property
    def ngrid(self) -> int:
        return self.ny * self.nx

    @property
    def nstate(self) -> int:
        """Total flattened state length: nvars * ntimes * ny * nx
        (reference: ``efa_xray/state/ensemble.py:52-53``)."""
        return self.nvars * self.ntimes * self.ngrid

    @property
    def shape(self) -> Tuple[int, int, int, int, int]:
        """Dense array shape ``(nvars, ntimes, ny, nx, nmems)``."""
        return (self.nvars, self.ntimes, self.ny, self.nx, self.nmems)

    def var_index(self, name: str) -> int:
        try:
            return self.var_names.index(name)
        except ValueError:
            raise KeyError(
                f"Variable {name!r} not in state (has {self.var_names})"
            ) from None

    def times64(self) -> np.ndarray:
        """Valid times as datetime64[s] (reference ``ensemble_times``,
        ``efa_xray/state/ensemble.py:133-135``)."""
        return timeutil.to_datetime64(self.times_s)

    def grid_latlon_device(self, dtype, device):
        """Flat grid ``(lat, lon)`` tensors on ``device``, cached on the
        (frozen) structure per dtype and device."""
        key = (str(dtype), str(torch.device(device)))
        cache = self.__dict__.get("_latlon_dev_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_latlon_dev_cache", cache)
        if key not in cache:
            cache[key] = (
                torch.tensor(self.lat.ravel(), dtype=dtype, device=device),
                torch.tensor(self.lon.ravel(), dtype=dtype, device=device),
            )
        return cache[key]

    def row_latlon_device(self, dtype, device):
        """:meth:`row_latlon` as tensors on ``device``, cached per dtype
        and device: the grid uploads once and the var*time tiling happens
        on the device."""
        key = (str(dtype), str(torch.device(device)))
        cache = self.__dict__.get("_row_latlon_dev_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_row_latlon_dev_cache", cache)
        if key not in cache:
            glat, glon = self.grid_latlon_device(dtype, device)
            reps = self.nvars * self.ntimes
            cache[key] = ((glat, glon) if reps == 1
                          else (glat.repeat(reps), glon.repeat(reps)))
        return cache[key]

    def spatial_order_device(self, device):
        """``(order, inverse)`` int64 tensors on ``device``: the permutation
        sorting the state rows into spherical Hilbert order (from float32
        row coordinates, as the JAX package builds it) and its inverse.
        Pure geometry, cached on the structure per device."""
        key = str(torch.device(device))
        cache = self.__dict__.get("_spatial_order_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_spatial_order_cache", cache)
        if key not in cache:
            from efa_xray_tpu_torch.observation.localization import (
                spatial_sort_order,
            )

            lat, lon = self.row_latlon_device(torch.float32, device)
            order = spatial_sort_order(lat, lon)
            inv = torch.empty_like(order)
            inv[order] = torch.arange(order.shape[0], device=order.device)
            cache[key] = (order, inv)
        return cache[key]

    # --- flattened-row geometry -----------------------------------------
    def flat_index(self, v, t, y, x) -> np.ndarray:
        """Row index in the flattened state for (var, time, y, x)."""
        return ((np.asarray(v) * self.ntimes + np.asarray(t)) * self.ny
                + np.asarray(y)) * self.nx + np.asarray(x)

    def row_latlon(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-state-row (lat, lon), each shape ``[nstate]``: the grid
        coordinates tiled over vars and times.  Used to broadcast
        localization weights across the whole state vector, the moral
        equivalent of the reference's ``dum_localize`` expansion
        (``efa_xray/assimilation/ensrf.py:35-38,108-111``)."""
        reps = self.nvars * self.ntimes
        return (
            np.tile(self.lat.ravel(), reps),
            np.tile(self.lon.ravel(), reps),
        )

    def row_vert(self) -> np.ndarray:
        """Per-state-row vertical coordinate ``[nstate]`` from per-variable
        verticals (each variable's level repeated over times and grid).
        Requires ``var_verts``."""
        if self.var_verts is None:
            raise ValueError("StateStructure has no var_verts")
        assert len(self.var_verts) == self.nvars
        return np.repeat(
            np.asarray(self.var_verts, dtype=np.float64), self.ntimes * self.ngrid
        )

    def with_nmems(self, nmems: int) -> "StateStructure":
        return dataclasses.replace(self, nmems=int(nmems))

    def subset(self, v_idx, t_idx, y_idx, x_idx, m_idx) -> "StateStructure":
        """Structure of a sub-selection along (var, time, y, x, mem), each
        a 1-D integer array or None (keep all).  Per-variable attrs keep
        the kept variables; extra coordinates are subset along their dims
        named ``validtime``/``y``/``x``/``mem``/``location`` (the y axis
        of a location-list grid).  Backs ``EnsembleState.isel``/``sel``."""
        v_idx = np.arange(self.nvars) if v_idx is None else np.asarray(v_idx)
        t_idx = np.arange(self.ntimes) if t_idx is None else np.asarray(t_idx)
        y_idx = np.arange(self.ny) if y_idx is None else np.asarray(y_idx)
        x_idx = np.arange(self.nx) if x_idx is None else np.asarray(x_idx)
        m_idx = np.arange(self.nmems) if m_idx is None else np.asarray(m_idx)
        names = tuple(self.var_names[i] for i in v_idx)
        verts = (None if self.var_verts is None
                 else tuple(self.var_verts[i] for i in v_idx))
        meta = None
        if self.meta is not None and self.meta:
            axis_idx = {"validtime": t_idx, "y": y_idx, "x": x_idx,
                        "mem": m_idx, "location": y_idx}
            coords = {}
            for cname, (cdims, carr, cattrs) in self.meta.coords.items():
                arr = np.asarray(carr)
                for ax, dim in enumerate(cdims):
                    if dim in axis_idx:
                        arr = np.take(arr, axis_idx[dim], axis=ax)
                coords[cname] = (tuple(cdims), arr, dict(cattrs))
            meta = StateMeta(
                attrs=dict(self.meta.attrs),
                var_attrs={k: dict(v) for k, v in self.meta.var_attrs.items()
                           if k in names},
                coords=coords)
        return StateStructure(
            var_names=names,
            times_s=self.times_s[t_idx],
            lat=self.lat[np.ix_(y_idx, x_idx)],
            lon=self.lon[np.ix_(y_idx, x_idx)],
            grid_is_2d=self.grid_is_2d,
            nmems=len(m_idx),
            var_verts=verts,
            meta=meta,
        )

    # Structures containing identical metadata compare equal, so they can
    # gate cached jit closures at the Python level.
    def __eq__(self, other):
        if not isinstance(other, StateStructure):
            return NotImplemented
        return (
            self.var_names == other.var_names
            and self.var_verts == other.var_verts
            and self.nmems == other.nmems
            and self.grid_is_2d == other.grid_is_2d
            and np.array_equal(self.times_s, other.times_s)
            and np.array_equal(self.lat, other.lat)
            and np.array_equal(self.lon, other.lon)
        )

    def __hash__(self):
        # Memoized: hashing the raw coordinate bytes of a large grid costs
        # tens of ms, and hash() is on the hot path of the module-level
        # forward-operator taps cache (observation/forward.py).
        h = self.__dict__.get("_hash_cache")
        if h is None:
            h = hash(
                (
                    self.var_names,
                    self.nmems,
                    self.grid_is_2d,
                    self.times_s.tobytes(),
                    self.lat.tobytes(),
                    self.lon.tobytes(),
                )
            )
            object.__setattr__(self, "_hash_cache", h)
        return h
