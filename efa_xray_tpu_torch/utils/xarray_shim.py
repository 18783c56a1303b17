"""Optional xarray interop.

Copy of ``efa_xray_tpu/utils/xarray_shim.py`` (``from_xarray`` :34,
``to_xarray`` :80), pointed at the port's ``EnsembleState``:
``from_xarray`` builds the state on ``device`` (the card when None) and
``to_xarray`` takes the data to the host through ``interop.to_host``.
The rest of this docstring is the JAX module's.

The reference's state IS an ``xarray.Dataset`` subclass; users migrating
from it will want to move Datasets in and out.  xarray is not installed in
every deployment, so these shims import it
lazily and raise a clear error when absent.  The core framework never
depends on xarray (the thin-shim requirement of BASELINE.json).

Metadata-faithful: global attrs, per-variable attrs and extra
(non-canonical) coordinate variables survive the round-trip in both
directions — parity with the reference, where the state is the Dataset
itself (``efa_xray/state/ensemble.py:15``) and metadata rides for free.
"""

from __future__ import annotations

import numpy as np

from efa_xray_tpu_torch.state.ensemble import _COORD_NAMES, EnsembleState


def _require_xarray():
    try:
        import xarray  # noqa: F401

        return xarray
    except ImportError as e:
        raise ImportError(
            "xarray is not installed; install it to use the xarray shims "
            "(the core framework does not need it)"
        ) from e


def from_xarray(ds, dtype=None, device=None) -> EnsembleState:
    """Build an EnsembleState from an xarray.Dataset shaped like the
    reference's (dims ``validtime, y, x, mem`` or ``validtime, location,
    mem``; coords ``lat``/``lon``).  Dataset attrs, per-variable attrs and
    any extra coordinate variables are carried on the state."""
    _require_xarray()
    var_names = [v for v in ds.data_vars if v not in _COORD_NAMES]
    vardict = {}
    var_attrs = {}
    for v in var_names:
        da = ds[v]
        dims = tuple(da.dims)
        if dims[-1] != "mem":
            da = da.transpose(..., "mem")
        vardict[v] = np.asarray(da.values)
        if dict(da.attrs):
            var_attrs[v] = dict(da.attrs)
    coorddict = {
        "validtime": np.asarray(ds["validtime"].values),
        "lat": np.asarray(ds["lat"].values),
        "lon": np.asarray(ds["lon"].values),
        "mem": np.asarray(ds["mem"].values),
    }
    for cname in ds.coords:
        if cname in _COORD_NAMES or cname in coorddict:
            continue
        ca = ds.coords[cname]
        coorddict[cname] = (tuple(ca.dims), np.asarray(ca.values))
    state = EnsembleState.from_vardict(
        vardict, coorddict, dtype=dtype, device=device,
        attrs=dict(ds.attrs), var_attrs=var_attrs,
    )
    # Attach extra-coord attrs (from_vardict stores bare arrays).
    meta = state.structure.meta
    if meta is not None:
        for cname in list(meta.coords):
            if cname in ds.coords and dict(ds.coords[cname].attrs):
                cdims, carr, _ = meta.coords[cname]
                meta.coords[cname] = (
                    cdims, carr, dict(ds.coords[cname].attrs)
                )
    return state


def to_xarray(state: EnsembleState):
    """Convert an EnsembleState back to an xarray.Dataset with the
    reference's dimension conventions, restoring carried metadata."""
    from efa_xray_tpu_torch.interop import to_host

    xr = _require_xarray()
    s = state.structure
    data = to_host(state.data)
    if s.grid_is_2d:
        grid_dims = ("y", "x")
        var_dims = ("validtime", "y", "x", "mem")
        lat, lon = np.asarray(s.lat), np.asarray(s.lon)
        var_data = {name: data[vi] for vi, name in enumerate(s.var_names)}
    else:
        grid_dims = ("location",)
        var_dims = ("validtime", "location", "mem")
        lat = np.asarray(s.lat).reshape(-1)
        lon = np.asarray(s.lon).reshape(-1)
        var_data = {
            name: data[vi].reshape(s.ntimes, s.ngrid, s.nmems)
            for vi, name in enumerate(s.var_names)
        }
    coords = {
        "validtime": ("validtime", s.times64()),
        "lat": (grid_dims, lat),
        "lon": (grid_dims, lon),
        "mem": ("mem", np.arange(s.nmems)),
    }
    data_vars = {
        name: (var_dims, var_data[name], state.var_attrs.get(name, {}))
        for name in s.var_names
    }
    for cname, (cdims, carr, cattrs) in state.extra_coords.items():
        coords[cname] = (tuple(cdims), np.asarray(carr), dict(cattrs))
    return xr.Dataset(data_vars, coords=coords, attrs=dict(state.attrs))
