"""EnsembleState: the ensemble as one dense torch tensor plus its structure.

Counterpart of ``efa_xray_tpu/state/ensemble.py``: ``from_vardict`` :59,
``from_vect`` :152, the size accessors :159-181, the carried metadata
``attrs`` / ``var_attrs`` / ``extra_coords`` :188-205, ``to_vect`` :208
(row order (var, time, y, x), members last), ``ensemble_mean`` :218,
``ensemble_perts`` :223, ``ensemble_spread`` :233, ``nearest_points``
:238, ``interpolate`` :250, ``haversine`` / ``distance_to_point``
:271-279, ``project_coordinates`` :281, ``isel`` / ``sel`` with
``_as_index`` :292-469, the arithmetic with ``_check_compatible``
:472-542, ``where`` :544, ``__neg__`` / ``__abs__`` :561-565 and
``astype`` :596 and ``save_to_disk`` / ``from_netcdf`` :579-590 (through
the port's copy of ``utils/ncio.py``), and ``shard`` :568.

The data lives in ONE tensor ``[nvars, ntimes, ny, nx, nmems]`` on one
device, the card unless the caller asks for another;
:class:`~efa_xray_tpu_torch.state.structure.StateStructure` holds the host
metadata.
"""

from __future__ import annotations

import operator
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from efa_xray_tpu_torch.observation import localization as _loc
from efa_xray_tpu_torch.state.structure import StateMeta, StateStructure
from efa_xray_tpu_torch.utils import timeutil
from efa_xray_tpu_torch.utils.logging import logger

_COORD_NAMES = ("validtime", "lat", "lon", "mem", "x", "y", "location")


def default_device(device=None) -> torch.device:
    """``device``, or the card when it is None.  Without a card a missing
    ``device`` raises: the CPU is used only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def _unwrap(v):
    """xarray-style ``(dims, array)`` tuples -> the array."""
    if isinstance(v, tuple) and len(v) == 2 and isinstance(
            v[0], (str, tuple, list)):
        return v[1]
    return v


class EnsembleState:
    """Dense ensemble state: ``data[var, time, y, x, member]`` + structure."""

    def __init__(self, data: torch.Tensor, structure: StateStructure):
        self.data = data
        self.structure = structure

    @classmethod
    def from_vardict(cls, vardict: Dict, coorddict: Dict, dtype=None,
                     device=None, attrs: Optional[Dict] = None,
                     var_attrs: Optional[Dict] = None) -> "EnsembleState":
        """Build from xarray-style variable/coordinate dicts (reference
        ``efa_xray/state/ensemble.py:25-36``).

        ``vardict``: ``{name: array}`` (or ``(dims, array)``) with shape
        ``(ntimes, ny, nx, nmems)`` or ``(ntimes, nloc, nmems)``; arrays
        may be NumPy arrays or tensors.  ``coorddict`` holds ``validtime``,
        ``lat``, ``lon`` and optionally ``mem``; other entries are kept as
        extra coordinates.  ``dtype`` defaults to float32 (a string such
        as ``"float64"`` or a torch dtype).  ``device`` defaults to the
        card, for NumPy arrays and tensors alike; without a card it must
        be given (``device="cpu"``).
        """
        times = _unwrap(coorddict["validtime"])
        lat = np.asarray(_unwrap(coorddict["lat"]))
        lon = np.asarray(_unwrap(coorddict["lon"]))
        mems = coorddict.get("mem")

        names = [k for k in vardict if k not in _COORD_NAMES]
        if not names:
            raise ValueError("vardict contains no state variables")
        fields = []
        for name in names:
            arr = _unwrap(vardict[name])
            if not isinstance(arr, torch.Tensor):
                arr = torch.from_numpy(np.array(arr))
            if arr.ndim == 3:  # (T, nloc, M) -> (T, nloc, 1, M)
                arr = arr[:, :, None, :]
            if arr.ndim != 4:
                raise ValueError(
                    f"Variable {name!r} must be (time, y, x, mem) or "
                    f"(time, loc, mem); got shape {tuple(arr.shape)}")
            fields.append(arr)
        nmems = fields[0].shape[-1] if mems is None else len(mems)

        extra = {}
        for cname, cval in coorddict.items():
            if cname in _COORD_NAMES:
                continue
            if isinstance(cval, tuple) and len(cval) == 2 and isinstance(
                    cval[0], (str, tuple, list)):
                cdims = (cval[0],) if isinstance(cval[0], str) else tuple(cval[0])
                carr = np.asarray(cval[1])
            else:
                carr = np.asarray(cval)
                cdims = tuple(f"{cname}_dim{i}" for i in range(carr.ndim))
            extra[cname] = (cdims, carr, {})
        meta = None
        if attrs or var_attrs or extra:
            meta = StateMeta(
                attrs=dict(attrs or {}),
                var_attrs={k: dict(v) for k, v in (var_attrs or {}).items()},
                coords=extra)
        structure = StateStructure.build(names, times, lat, lon, nmems,
                                         meta=meta)
        device = default_device(device)
        dtype = _torch_dtype(dtype or "float32")
        data = torch.stack([f.to(device=device, dtype=dtype) for f in fields])
        if tuple(data.shape) != structure.shape:
            raise ValueError(
                f"Variable shapes {tuple(data.shape[1:])} inconsistent with "
                f"coords {structure.shape[1:]}")
        return cls(data, structure)

    @classmethod
    def from_vect(cls, vect, structure: StateStructure) -> "EnsembleState":
        """Inverse of :meth:`to_vect`: ``[nstate, nmems]`` -> state."""
        return cls(vect.reshape(structure.shape), structure)

    # --- reference-compatible size accessors (methods, not properties) ----
    def nmems(self) -> int:
        return self.structure.nmems

    def ny(self) -> int:
        return self.structure.ny

    def nx(self) -> int:
        return self.structure.nx

    def ntimes(self) -> int:
        return self.structure.ntimes

    def vars(self) -> list:
        return list(self.structure.var_names)

    def nvars(self) -> int:
        return self.structure.nvars

    def nstate(self) -> int:
        return self.structure.nstate

    def shape(self) -> Tuple[int, ...]:
        return self.structure.shape

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __getitem__(self, name: str):
        """One variable's dense block ``[time, y, x, mem]``."""
        return self.data[self.structure.var_index(name)]

    # --- carried metadata (the reference's xarray attrs and coords) ------
    @property
    def attrs(self) -> Dict:
        """Global attributes (empty when none were attached)."""
        m = self.structure.meta
        return {} if m is None else m.attrs

    @property
    def var_attrs(self) -> Dict:
        """Per-variable attributes, ``{var: {key: val}}``."""
        m = self.structure.meta
        return {} if m is None else m.var_attrs

    @property
    def extra_coords(self) -> Dict:
        """Extra coordinate variables, ``{name: (dims, array, attrs)}``."""
        m = self.structure.meta
        return {} if m is None else m.coords

    def to_vect(self) -> torch.Tensor:
        """``[nstate, nmems]`` in (var, time, y, x) row order (a view)."""
        s = self.structure
        return self.data.reshape(s.nstate, s.nmems)

    def update_from_vect(self, vect) -> "EnsembleState":
        return EnsembleState.from_vect(vect, self.structure)

    def ensemble_mean(self) -> torch.Tensor:
        """Mean over members -> ``[nvars, ntimes, ny, nx]``."""
        return self.data.mean(dim=-1)

    def ensemble_perts(self) -> "EnsembleState":
        """Perturbations from the ensemble mean, same shape as the state."""
        return EnsembleState(self.data - self.ensemble_mean()[..., None],
                             self.structure)

    def ensemble_times(self) -> np.ndarray:
        return self.structure.times64()

    def ensemble_spread(self) -> torch.Tensor:
        """Member standard deviation ``[nvars, ntimes, ny, nx]`` (ddof 0)."""
        return self.data.std(dim=-1, unbiased=False)

    # --- geometry and interpolation -------------------------------------
    def nearest_points(self, lat, lon, npt: int = 1):
        """The ``npt`` grid points nearest to ``(lat, lon)`` by great-circle
        distance, as a ``(y_idx, x_idx)`` pair of NumPy arrays."""
        from efa_xray_tpu_torch.observation import forward as _fwd

        return _fwd.nearest_points(self.structure.lat, self.structure.lon,
                                   lat, lon, npt, device=self.device)

    def interpolate(self, var: str, time, lat, lon):
        """Ensemble estimate (a tensor of ``nmems``) of ``var`` at a point
        and time: 4-point inverse-distance in space, linear in time
        (reference ``efa_xray/state/ensemble.py:170-239``); None, with a
        warning, when ``time`` is outside the state's times."""
        from efa_xray_tpu_torch.observation import forward as _fwd

        taps = _fwd.build_taps(
            self.structure, np.asarray([lat], dtype=np.float64),
            np.asarray([lon], dtype=np.float64),
            timeutil.to_epoch_seconds([time]),
            np.asarray([self.structure.var_index(var)], dtype=np.int32),
            device=self.device)
        if not bool(taps.qc_ok[0]):
            logger.warning("Interpolation is outside of time range in state!")
            return None
        return _fwd.apply_taps_obj(self.to_vect(), taps)[0]

    def haversine(self, loc1, loc2):
        return _loc.haversine(loc1, loc2)

    def distance_to_point(self, lat, lon) -> torch.Tensor:
        """Great-circle km from ``(lat, lon)`` to every grid point, ``[ny,
        nx]`` float64 on the state's device."""
        glat, glon = (torch.tensor(a, dtype=torch.float64,
                                   device=self.device)
                      for a in (self.structure.lat, self.structure.lon))
        return _loc.distance_to_point(glat, glon, lat, lon)

    def project_coordinates(self, m):
        """Grid coordinates through a projection ``m(lons, lats) -> (gx,
        gy)``, longitudes wrapped to +-180 first."""
        lons = np.array(self.structure.lon, copy=True)
        lons[lons > 180] = lons[lons > 180] - 360
        return m(lons, np.asarray(self.structure.lat))

    # --- subsetting (xarray's isel / sel) -------------------------------
    @staticmethod
    def _as_index(sel, n, name: str) -> Optional[np.ndarray]:
        """An isel-style selection (int, slice, sequence, bool mask or
        None) as a 1-D int64 array (None keeps all)."""
        if sel is None:
            return None
        if isinstance(sel, slice):
            out = np.arange(n)[sel]
            if out.size == 0:
                raise IndexError(f"empty selection along {name}")
            return out
        arr = np.asarray(sel)
        if arr.dtype == bool:
            if arr.shape != (n,):
                raise IndexError(f"boolean mask for {name} has shape "
                                 f"{arr.shape}, want ({n},)")
            out = np.flatnonzero(arr)
            if out.size == 0:
                raise IndexError(f"empty selection along {name}")
            return out
        arr = np.atleast_1d(arr).astype(np.int64)
        if arr.size == 0:
            raise IndexError(f"empty selection along {name}")
        if (arr < -n).any() or (arr >= n).any():
            raise IndexError(f"{name} index out of range [0, {n})")
        return arr % n

    def isel(self, vars=None, validtime=None, y=None, x=None,
             mem=None) -> "EnsembleState":
        """Integer-position subsetting (xarray's ``isel``): each argument
        an int, slice, integer sequence or boolean mask (``vars`` also
        names).  Scalar selections keep their axis at size 1; metadata is
        subset to match."""
        s = self.structure
        if vars is not None and not isinstance(vars, (int, np.integer,
                                                      slice)):
            seq = [vars] if isinstance(vars, str) else list(vars)
            if all(isinstance(v, str) for v in seq):
                vars = [s.var_index(v) for v in seq]
        idx = (self._as_index(vars, s.nvars, "vars"),
               self._as_index(validtime, s.ntimes, "validtime"),
               self._as_index(y, s.ny, "y"),
               self._as_index(x, s.nx, "x"),
               self._as_index(mem, s.nmems, "mem"))
        data = self.data
        for axis, ix in enumerate(idx):
            if ix is not None:
                data = torch.index_select(
                    data, axis, torch.as_tensor(ix, device=data.device))
        return EnsembleState(data, s.subset(*idx))

    def sel(self, vars=None, validtime=None, lat=None, lon=None, mem=None,
            method: str = "nearest") -> "EnsembleState":
        """Label-based subsetting (xarray's ``sel``): ``vars`` by name;
        ``validtime`` a datetime (nearest, or ``method="exact"``) or a
        slice of datetimes (inclusive); ``lat``/``lon`` a slice (inclusive
        bounds; a ``lon`` slice with ``lo > hi`` wraps through 0) or a
        scalar (the nearest grid row or column); ``mem`` positional."""
        s = self.structure
        v_idx = None
        if vars is not None:
            seq = [vars] if isinstance(vars, str) else list(vars)
            v_idx = [s.var_index(v) for v in seq]
        t_idx = None
        if validtime is not None:
            times = s.times_s
            if isinstance(validtime, slice):
                lo = (-np.inf if validtime.start is None
                      else timeutil.to_epoch_seconds([validtime.start])[0])
                hi = (np.inf if validtime.stop is None
                      else timeutil.to_epoch_seconds([validtime.stop])[0])
                t_idx = np.flatnonzero((times >= lo) & (times <= hi))
                if t_idx.size == 0:
                    raise KeyError(f"no validtimes inside [{validtime.start}, "
                                   f"{validtime.stop}]")
            else:
                want = timeutil.to_epoch_seconds([validtime])[0]
                i = int(np.abs(times - want).argmin())
                if method == "exact" and times[i] != want:
                    raise KeyError(f"validtime {validtime!r} not in state")
                t_idx = np.asarray([i])
        y_idx = x_idx = None
        if lat is not None or lon is not None:
            glat, glon = s.lat, s.lon
            mask = np.ones(glat.shape, dtype=bool)
            if isinstance(lat, slice):
                lo = -90.0 if lat.start is None else float(lat.start)
                hi = 90.0 if lat.stop is None else float(lat.stop)
                mask &= (glat >= lo) & (glat <= hi)
            elif lat is not None:
                iy = np.unravel_index(np.abs(glat - float(lat)).argmin(),
                                      glat.shape)[0]
                row = np.zeros(glat.shape, dtype=bool)
                row[iy, :] = True
                mask &= row
            glon360 = np.mod(glon, 360.0)
            if isinstance(lon, slice):
                start, stop = lon.start, lon.stop
                if not (start is not None and stop is not None
                        and abs(float(stop) - float(start)) >= 360.0):
                    lo = 0.0 if start is None else float(start) % 360.0
                    hi = 360.0 if stop is None else float(stop) % 360.0
                    if (start is not None and stop is not None and lo >= hi
                            and float(stop) != float(start)):
                        mask &= (glon360 >= lo) | (glon360 <= hi)
                    else:
                        mask &= (glon360 >= lo) & (glon360 <= hi)
            elif lon is not None:
                d = np.abs(np.mod(glon360 - float(lon) % 360.0 + 180.0,
                                  360.0) - 180.0)
                jx = np.unravel_index(d.argmin(), glon.shape)[1]
                col = np.zeros(glon.shape, dtype=bool)
                col[:, jx] = True
                mask &= col
            if not mask.any():
                raise KeyError("lat/lon selection matches no grid points")
            y_idx = np.flatnonzero(mask.any(axis=1))
            x_idx = np.flatnonzero(mask.any(axis=0))
        return self.isel(vars=v_idx, validtime=t_idx, y=y_idx, x=x_idx,
                         mem=mem)

    # --- arithmetic (xarray Dataset arithmetic, without alignment) -------
    def _operand(self, other, what: str):
        if isinstance(other, EnsembleState):
            self._check_compatible(other, what)
            return other.data
        if isinstance(other, np.ndarray):
            return torch.tensor(other, device=self.device)
        return other

    def _binop(self, other, op) -> "EnsembleState":
        """Elementwise ``op`` with another state (same shape, variables,
        times and grid; the left structure is carried), a scalar or
        anything broadcastable against ``[V, T, Y, X, M]``."""
        return EnsembleState(op(self.data, self._operand(other,
                                                         "arithmetic")),
                             self.structure)

    def _check_compatible(self, other: "EnsembleState", what: str):
        """State-state operations must agree on shape, variables, valid
        times and grid: no xarray-style alignment is done."""
        s, o = self.structure, other.structure
        if s is o:
            return
        if s.shape != o.shape or s.var_names != o.var_names:
            raise ValueError(
                f"EnsembleState {what} shape/vars mismatch: "
                f"{s.var_names}{s.shape} vs {o.var_names}{o.shape}")
        if not (np.array_equal(s.times_s, o.times_s)
                and np.allclose(s.lat, o.lat) and np.allclose(s.lon, o.lon)):
            raise ValueError(
                f"EnsembleState {what} coordinate mismatch (same shape but "
                "different validtimes or lat/lon grid); no xarray-style "
                "alignment is performed: subset both states to a common "
                "grid first")

    def __add__(self, other):
        return self._binop(other, operator.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, operator.sub)

    def __rsub__(self, other):
        return self._binop(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._binop(other, operator.mul)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, operator.truediv)

    def __rtruediv__(self, other):
        return self._binop(other, lambda a, b: b / a)

    def __pow__(self, other):
        return self._binop(other, operator.pow)

    def __rpow__(self, other):
        return self._binop(other, lambda a, b: b ** a)

    # NumPy defers to the reflected operators above (else ``array * state``
    # would build an object array of states).
    __array_ufunc__ = None

    def where(self, cond, other=float("nan")) -> "EnsembleState":
        """Keep elements where ``cond`` holds, ``other`` elsewhere (NaN by
        default); ``cond`` and ``other`` may be states, arrays or
        scalars."""
        cond = torch.as_tensor(self._operand(cond, "where(cond)"),
                               device=self.device).to(torch.bool)
        other = self._operand(other, "where(other)")
        if not isinstance(other, torch.Tensor):
            other = torch.as_tensor(other, dtype=self.data.dtype,
                                    device=self.device)
        return EnsembleState(torch.where(cond, self.data, other),
                             self.structure)

    def __neg__(self):
        return EnsembleState(-self.data, self.structure)

    def __abs__(self):
        return EnsembleState(torch.abs(self.data), self.structure)

    def astype(self, dtype) -> "EnsembleState":
        return EnsembleState(self.data.to(_torch_dtype(dtype)),
                             self.structure)

    def shard(self, mesh, axis_name: str = "state") -> "EnsembleState":
        """The state placed for ``mesh`` (a
        :class:`~efa_xray_tpu_torch.parallel.mesh.Mesh`): whole, on
        ``mesh.devices[0]``.  The JAX package places its one array
        sharded over the mesh, a placement convenience by its own
        docstring; here the state is one tensor, which cannot span
        devices, and the sharded drivers split the flat rows themselves
        either way (``parallel.mesh.shard_state_array`` gives the JAX
        rule's per-device chunks)."""
        if not getattr(mesh, "devices", None):
            raise TypeError(f"shard takes a parallel.mesh.Mesh, not "
                            f"{type(mesh).__name__}")
        return self.to(mesh.devices[0])

    # --- I/O --------------------------------------------------------------
    def save_to_disk(self, filename: str = "ens_state.nc"):
        """Checkpoint to a netCDF4(HDF5)-compatible file (reference
        ``efa_xray/state/ensemble.py:269-273``) that the JAX package reads
        too."""
        from efa_xray_tpu_torch.utils import ncio

        ncio.write_state(filename, self)

    @classmethod
    def from_netcdf(cls, filename: str, dtype=None,
                    device=None) -> "EnsembleState":
        """A state file (this package's or the JAX package's) on ``device``,
        the card when None, in ``dtype`` (float32 when None)."""
        from efa_xray_tpu_torch.utils import ncio

        return ncio.read_state(filename, dtype=dtype, device=device)

    def replace_data(self, data) -> "EnsembleState":
        return EnsembleState(data, self.structure)

    def to(self, device=None, dtype=None) -> "EnsembleState":
        return EnsembleState(self.data.to(device=device, dtype=dtype),
                             self.structure)

    def __repr__(self):
        s = self.structure
        return (f"EnsembleState(vars={list(s.var_names)}, ntimes={s.ntimes}, "
                f"grid={s.ny}x{s.nx}, nmems={s.nmems}, dtype={self.data.dtype}, "
                f"device={self.data.device})")


def _torch_dtype(dtype) -> torch.dtype:
    """``"float32"`` / ``np.float64`` / ``torch.float32`` -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)
