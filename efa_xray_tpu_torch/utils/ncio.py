"""Minimal netCDF4-compatible I/O built on h5py.

Copy of ``efa_xray_tpu/utils/ncio.py`` (``NcDataset`` :34,
``write_dataset`` :54, ``read_dataset`` :112, ``write_state`` :174,
``read_state`` :248, ``write_obs`` :306, ``read_obs`` :357), pointed at the
port's classes: :func:`write_state` takes the data to the host through
``interop.to_host`` (``np.asarray`` refuses a CUDA tensor), and
:func:`read_state` builds the state on ``device``, the card unless the
caller names another.  Files written by either package read back in the
other.  The rest of this docstring is the JAX module's.

The reference checkpoints state and inflation fields via
``xarray.Dataset.to_netcdf`` (``efa_xray/state/ensemble.py:269-273``,
``efa_xray/assimilation/adaptive_inflation.py:76-80``) and consumes
inflation files via ``xarray.open_dataset``
(``efa_xray/assimilation/assimilation.py:74``).  This environment ships
neither xarray nor netCDF4, but netCDF-4 files ARE HDF5 files with a small
set of conventions (named dimensions as HDF5 *dimension scales*, attached
to variables).  This module implements exactly that subset, so files written
here open cleanly in netCDF4/xarray and vice versa for the common case.

``NcDataset`` is the in-memory form: named dimensions, variables as
``(dims, ndarray)``, plus attrs — the structural equivalent of the
xarray.Dataset the reference passes around.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

try:
    import h5py

    _HAS_H5PY = True
except ImportError:  # the netCDF functions raise; importing still works
    _HAS_H5PY = False


@dataclasses.dataclass
class NcDataset:
    dims: Dict[str, int]
    variables: Dict[str, Tuple[Tuple[str, ...], np.ndarray]]
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)
    # Per-variable attributes: {var_name: {attr: value}}.
    var_attrs: Dict[str, Dict[str, object]] = dataclasses.field(
        default_factory=dict
    )

    def __getitem__(self, name: str) -> np.ndarray:
        return self.variables[name][1]

    def var_dims(self, name: str) -> Tuple[str, ...]:
        return self.variables[name][0]

    @property
    def data_vars(self):
        return {k: v for k, v in self.variables.items()}


def write_dataset(filename: str, ds: NcDataset) -> None:
    if not _HAS_H5PY:
        raise RuntimeError("h5py is required for netCDF I/O")
    with h5py.File(filename, "w") as f:
        # Create dimension-scale datasets for dims that have no variable.
        for dim, size in ds.dims.items():
            if dim not in ds.variables:
                d = f.create_dataset(dim, data=np.zeros(size, dtype=np.float32))
                d.make_scale(dim)
                d.attrs["NAME"] = np.bytes_(
                    f"This is a netCDF dimension but not a netCDF variable.{size:>10}"
                )
        # Coordinate variables (name == one of their dims) become scales.
        for name, (dims, arr) in ds.variables.items():
            arr = np.asarray(arr)
            if arr.dtype.kind == "M":  # datetime64 -> int64 seconds + units
                arr = arr.astype("datetime64[s]").astype(np.int64)
                v = f.create_dataset(name, data=arr)
                v.attrs["units"] = np.bytes_("seconds since 1970-01-01 00:00:00")
                v.attrs["calendar"] = np.bytes_("standard")
            elif arr.dtype == object or arr.dtype.kind == "U":
                v = f.create_dataset(
                    name, data=np.asarray([str(x).encode() for x in arr.ravel()])
                )
            else:
                v = f.create_dataset(name, data=arr)
            v.attrs["_dims"] = np.bytes_(",".join(dims))
            for ak, av in ds.var_attrs.get(name, {}).items():
                v.attrs[ak] = av
            if name in dims:
                v.make_scale(name)
        # Attach dimension scales (netCDF4 convention).
        for name, (dims, _) in ds.variables.items():
            v = f[name]
            if name in dims:
                continue
            for axis, dim in enumerate(dims):
                if dim in f and f[dim].attrs.get("CLASS", b"") == b"DIMENSION_SCALE":
                    v.dims[axis].attach_scale(f[dim])
        for k, val in ds.attrs.items():
            f.attrs[k] = val


# HDF5/netCDF4 bookkeeping attrs that are not user metadata.
_INTERNAL_VAR_ATTRS = frozenset(
    {"_dims", "CLASS", "NAME", "DIMENSION_LIST", "REFERENCE_LIST",
     "_Netcdf4Dimid", "_Netcdf4Coordinates", "_FillValue"}
)


def _decode_attr(val):
    if isinstance(val, bytes):
        return val.decode()
    if isinstance(val, np.ndarray) and val.dtype.kind == "S":
        return np.asarray([x.decode() for x in val])
    return val


def read_dataset(filename: str) -> NcDataset:
    if not _HAS_H5PY:
        raise RuntimeError("h5py is required for netCDF I/O")
    dims: Dict[str, int] = {}
    variables: Dict[str, Tuple[Tuple[str, ...], np.ndarray]] = {}
    attrs: Dict[str, object] = {}
    var_attrs: Dict[str, Dict[str, object]] = {}
    with h5py.File(filename, "r") as f:
        for name in f:
            obj = f[name]
            if not isinstance(obj, h5py.Dataset):
                continue
            is_pure_dim = (
                obj.attrs.get("CLASS", b"") == b"DIMENSION_SCALE"
                and b"not a netCDF variable" in obj.attrs.get("NAME", b"")
            )
            if is_pure_dim:
                dims[name] = obj.shape[0]
                continue
            if "_dims" in obj.attrs:
                vdims = tuple(
                    d for d in obj.attrs["_dims"].decode().split(",") if d
                )
            else:
                # Fall back to attached dimension scales (files written by
                # real netCDF4), else synthetic names.
                vdims = []
                for axis in range(obj.ndim):
                    scales = obj.dims[axis].items() if obj.dims else []
                    vdims.append(
                        scales[0][1].name.lstrip("/") if scales else f"dim_{axis}"
                    )
                vdims = tuple(vdims)
            arr = obj[()]
            units = obj.attrs.get("units", b"")
            is_epoch_time = (
                isinstance(units, bytes)
                and units.startswith(b"seconds since 1970")
            )
            if is_epoch_time:
                arr = np.asarray(arr, dtype=np.int64).astype("datetime64[s]")
            variables[name] = (vdims, arr)
            va = {}
            for ak in obj.attrs:
                if ak in _INTERNAL_VAR_ATTRS:
                    continue
                if is_epoch_time and ak in ("units", "calendar"):
                    continue  # consumed by the datetime64 decoding above
                va[ak] = _decode_attr(obj.attrs[ak])
            if va:
                var_attrs[name] = va
            for d, size in zip(vdims, np.shape(arr)):
                dims.setdefault(d, size)
        for k in f.attrs:
            attrs[k] = _decode_attr(f.attrs[k])
    return NcDataset(dims=dims, variables=variables, attrs=attrs,
                     var_attrs=var_attrs)


# --- EnsembleState round-trip -------------------------------------------------


def write_state(filename: str, state) -> None:
    """Checkpoint an EnsembleState (reference ``save_to_disk``,
    ``efa_xray/state/ensemble.py:269-273``).

    Metadata-faithful: global attrs, per-variable attrs and extra
    coordinate variables carried on the state (``state.attrs`` /
    ``state.var_attrs`` / ``state.extra_coords`` — free on the reference's
    xarray.Dataset, ``efa_xray/state/ensemble.py:15``) are written and
    recovered by :func:`read_state`.  1-D location-list grids are written
    with a ``location`` dimension instead of a fake 2-D raster."""
    from efa_xray_tpu_torch.interop import to_host

    s = state.structure
    data = to_host(state.data)
    if s.grid_is_2d:
        dims = {"validtime": s.ntimes, "y": s.ny, "x": s.nx, "mem": s.nmems}
        grid_dims = ("y", "x")
        var_dims = ("validtime", "y", "x", "mem")
        lat, lon = np.asarray(s.lat), np.asarray(s.lon)
        var_data = {name: data[vi] for vi, name in enumerate(s.var_names)}
    else:
        # 1-D location grid: structure stores it as [nloc, 1]; persist the
        # honest 1-D form (the reference's 1-D branch is its broken path,
        # efa_xray/state/ensemble.py:186-188 — SURVEY.md §2.1).
        dims = {"validtime": s.ntimes, "location": s.ngrid, "mem": s.nmems}
        grid_dims = ("location",)
        var_dims = ("validtime", "location", "mem")
        lat = np.asarray(s.lat).reshape(-1)
        lon = np.asarray(s.lon).reshape(-1)
        var_data = {
            name: data[vi].reshape(s.ntimes, s.ngrid, s.nmems)
            for vi, name in enumerate(s.var_names)
        }
    variables: Dict[str, Tuple[Tuple[str, ...], np.ndarray]] = {
        "validtime": (("validtime",), s.times64()),
        "lat": (grid_dims, lat),
        "lon": (grid_dims, lon),
        "mem": (("mem",), np.arange(s.nmems, dtype=np.int32)),
    }
    for name, arr in var_data.items():
        variables[name] = (var_dims, arr)

    attrs = {
        "grid_is_2d": np.int8(s.grid_is_2d),
        "var_order": ",".join(s.var_names),
    }
    var_attrs: Dict[str, Dict[str, object]] = {}
    meta = s.meta
    extra_coord_names = []
    if meta is not None:
        # User attrs must not clobber the bookkeeping attrs read_state
        # parses (it strips _STATE_INTERNAL_ATTRS on read, so a colliding
        # key would round-trip wrong values anyway).
        attrs.update({k: v for k, v in meta.attrs.items()
                      if k not in _STATE_INTERNAL_ATTRS})
        var_attrs.update({k: dict(v) for k, v in meta.var_attrs.items()})
        for cname, (cdims, carr, cattrs) in meta.coords.items():
            carr = np.asarray(carr)
            variables[cname] = (tuple(cdims), carr)
            if cattrs:
                var_attrs[cname] = dict(cattrs)
            extra_coord_names.append(cname)
            for d, size in zip(cdims, carr.shape):
                dims.setdefault(d, size)
    attrs["extra_coords"] = ",".join(extra_coord_names)
    write_dataset(
        filename,
        NcDataset(dims=dims, variables=variables, attrs=attrs,
                  var_attrs=var_attrs),
    )


# write_state bookkeeping attrs, not user metadata.
_STATE_INTERNAL_ATTRS = ("grid_is_2d", "var_order", "extra_coords")


def read_state(filename: str, dtype=None, device=None):
    """Inverse of :func:`write_state`: the state on ``device`` (the card
    when None; without a card it must be given) in ``dtype`` (float32 when
    None)."""
    from efa_xray_tpu_torch.state.ensemble import EnsembleState

    ds = read_dataset(filename)
    coord_names = {"validtime", "lat", "lon", "mem", "x", "y", "location"}
    order = ds.attrs.get("var_order")
    extra = ds.attrs.get("extra_coords")
    extra_names = [v for v in str(extra).split(",") if v] \
        if extra is not None else []
    if order is not None:
        if isinstance(order, bytes):
            order = order.decode()
        var_names = [v for v in str(order).split(",") if v]
    else:
        var_names = [k for k in ds.variables
                     if k not in coord_names and k not in extra_names]
    vardict = {k: ds[k] for k in var_names}
    lat = ds["lat"]
    grid_is_2d = bool(ds.attrs.get("grid_is_2d", lat.ndim == 2))
    if not grid_is_2d:
        lat = lat.reshape(-1)
        lon = ds["lon"].reshape(-1)
        vardict = {k: v.reshape(v.shape[0], -1, v.shape[-1]) for k, v in vardict.items()}
    else:
        lon = ds["lon"]
    coorddict = {
        "validtime": ds["validtime"],
        "lat": lat,
        "lon": lon,
        "mem": ds["mem"],
    }
    for cname in extra_names:
        coorddict[cname] = (ds.var_dims(cname), ds[cname])
    attrs = {k: v for k, v in ds.attrs.items()
             if k not in _STATE_INTERNAL_ATTRS}
    var_attrs = {k: v for k, v in ds.var_attrs.items() if k in var_names}
    state = EnsembleState.from_vardict(vardict, coorddict, dtype=dtype,
                                       device=device, attrs=attrs,
                                       var_attrs=var_attrs)
    # Extra-coord attrs ride on the coord entries themselves.
    if state.structure.meta is not None:
        for cname in extra_names:
            if cname in ds.var_attrs and cname in state.structure.meta.coords:
                cdims, carr, _ = state.structure.meta.coords[cname]
                state.structure.meta.coords[cname] = (
                    cdims, carr, dict(ds.var_attrs[cname])
                )
    return state


# --- ObservationBatch round-trip ----------------------------------------------

_OBS_FLOAT_FIELDS = (
    "values", "errors", "lats", "lons", "localize_radius", "verts",
    "vert_radius",
)
_OBS_RESULT_FIELDS = ("prior_mean", "prior_var", "post_mean", "post_var")


def write_obs(filename: str, batch) -> None:
    """Persist an ObservationBatch as a netCDF4-compatible HDF5 file.

    One ``obs`` dimension; float fields as f64 variables (inf/NaN preserved),
    flags as int8, times as epoch-second int64 with CF units, obtypes and
    descriptions as variable-length strings.  Filter result slots
    (prior/post mean/var, assimilated) are written when present, so a
    post-assimilation batch round-trips with its diagnostics — the file
    form of the reference's per-ob result attributes
    (``efa_xray/observation/observation.py:27-36``).
    """
    n = batch.nobs
    dims = {"obs": n}
    variables: Dict[str, Tuple[Tuple[str, ...], np.ndarray]] = {}
    for name in _OBS_FLOAT_FIELDS:
        variables[name] = (
            ("obs",), np.asarray(getattr(batch, name), dtype=np.float64)
        )
    variables["time"] = (
        ("obs",),
        np.asarray(batch.times_s, dtype=np.int64).astype("datetime64[s]"),
    )
    variables["assimilate_this"] = (
        ("obs",), np.asarray(batch.assimilate_flags, dtype=np.int8)
    )
    variables["custom_operator"] = (
        ("obs",), np.asarray(batch.custom_operator, dtype=np.int8)
    )
    variables["obtype"] = (("obs",), np.asarray(batch.obtypes, dtype=object))
    variables["description"] = (
        ("obs",),
        np.asarray(
            ["" if d is None else str(d) for d in batch.descriptions],
            dtype=object,
        ),
    )
    for name in _OBS_RESULT_FIELDS:
        val = getattr(batch, name)
        if val is not None:
            variables[name] = (("obs",), np.asarray(val, dtype=np.float64))
    if batch.assimilated is not None:
        variables["assimilated"] = (
            ("obs",), np.asarray(batch.assimilated, dtype=np.int8)
        )
    if batch.qc_outlier is not None:
        variables["qc_outlier"] = (
            ("obs",), np.asarray(batch.qc_outlier, dtype=np.int8)
        )
    write_dataset(filename, NcDataset(dims=dims, variables=variables))


def read_obs(filename: str):
    """Inverse of :func:`write_obs`."""
    from efa_xray_tpu_torch.observation.observation import ObservationBatch

    ds = read_dataset(filename)

    def dec(arr):
        return [x.decode() if isinstance(x, bytes) else str(x) for x in arr]

    descriptions = [d or None for d in dec(ds["description"])]
    kwargs = dict(
        values=np.asarray(ds["values"], dtype=np.float64),
        errors=np.asarray(ds["errors"], dtype=np.float64),
        lats=np.asarray(ds["lats"], dtype=np.float64),
        lons=np.asarray(ds["lons"], dtype=np.float64),
        times_s=np.asarray(ds["time"]).astype("datetime64[s]").astype(np.int64),
        obtypes=dec(ds["obtype"]),
        localize_radius=np.asarray(ds["localize_radius"], dtype=np.float64),
        assimilate_flags=np.asarray(ds["assimilate_this"], dtype=bool),
        verts=np.asarray(ds["verts"], dtype=np.float64),
        descriptions=descriptions,
        vert_radius=np.asarray(ds["vert_radius"], dtype=np.float64),
        custom_operator=np.asarray(ds["custom_operator"], dtype=bool),
    )
    for name in _OBS_RESULT_FIELDS:
        if name in ds.variables:
            kwargs[name] = np.asarray(ds[name], dtype=np.float64)
    if "assimilated" in ds.variables:
        kwargs["assimilated"] = np.asarray(ds["assimilated"], dtype=bool)
    if "qc_outlier" in ds.variables:
        kwargs["qc_outlier"] = np.asarray(ds["qc_outlier"], dtype=bool)
    return ObservationBatch(**kwargs)
