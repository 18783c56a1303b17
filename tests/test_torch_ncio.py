"""The port's netCDF I/O (``utils/ncio.py``, ``EnsembleState.save_to_disk``
/ ``from_netcdf``) against the JAX package's: states with and without
metadata, a 1-D location grid and observation batches written by either
package and read by either, bit for bit; the two writers' files hold the
same dataset.  Mirrors ``test_obsio.py`` and ``test_metadata.py``'s
round trips."""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu.state.ensemble import EnsembleState as JState
from efa_xray_tpu.utils import ncio as jncio
from efa_xray_tpu_torch import EnSRF, EnsembleState, FilterConfig, interop
from efa_xray_tpu_torch.observation.observation import ObservationBatch
from efa_xray_tpu_torch.utils import ncio

_OBS_FIELDS = ("values", "errors", "lats", "lons", "times_s", "obtypes",
               "localize_radius", "assimilate_flags", "verts",
               "descriptions", "vert_radius", "custom_operator")


def _grid_case(dtype):
    """(vardict, coorddict, attrs, var_attrs) of a state with metadata:
    two variables, extra coords along validtime and of rank 0."""
    rng = np.random.default_rng(0)
    lon, lat = np.meshgrid(np.linspace(230, 245, 8), np.linspace(40, 50, 6))
    times = (np.datetime64("2026-08-01T00")
             + np.arange(2) * np.timedelta64(6, "h"))
    vardict = {v: rng.normal(280, 2, (2, 6, 8, 5)).astype(dtype)
               for v in ("T2M", "PS")}
    coords = {"validtime": times, "lat": lat, "lon": lon,
              "mem": np.arange(5), "fhour": (("validtime",), [0.0, 6.0]),
              "level": ((), np.float64(2.0))}
    return (vardict, coords, {"title": "GEFS-like demo", "run": np.int32(3)},
            {"T2M": {"units": "K", "long_name": "2-m temperature"}})


def _points_case(dtype):
    """A 1-D location grid with an extra coord along ``location``."""
    rng = np.random.default_rng(3)
    times = (np.datetime64("2026-08-01T00")
             + np.arange(3) * np.timedelta64(6, "h"))
    coords = {"validtime": times, "lat": np.linspace(40, 50, 7),
              "lon": np.linspace(230, 240, 7), "mem": np.arange(4),
              "station_elev": (("location",), np.linspace(0, 700, 7))}
    return ({"T2M": rng.normal(280, 2, (3, 7, 4)).astype(dtype)}, coords,
            {"network": "mesonet"}, {"T2M": {"units": "K"}})


def _plain_case(dtype):
    st = make_demo_state(ny=5, nx=5, ntimes=2, nmems=6)
    s = st.structure
    data = np.asarray(st.data).astype(dtype)
    return ({n: data[i] for i, n in enumerate(s.var_names)},
            {"validtime": s.times64(), "lat": s.lat, "lon": s.lon,
             "mem": np.arange(s.nmems)}, None, None)


_CASES = {"grid with metadata": _grid_case, "location grid": _points_case,
          "plain": _plain_case}


def _states(case, dtype):
    vardict, coords, attrs, var_attrs = _CASES[case](dtype)
    j = JState.from_vardict(vardict, coords, dtype=dtype, attrs=attrs,
                            var_attrs=var_attrs)
    t = EnsembleState.from_vardict(vardict, coords, dtype=dtype,
                                   device="cpu", attrs=attrs,
                                   var_attrs=var_attrs)
    return j, t


def _same_meta(a, b):
    assert a.attrs.keys() == b.attrs.keys()
    for k in a.attrs:
        np.testing.assert_array_equal(a.attrs[k], b.attrs[k])
    assert a.var_attrs == b.var_attrs
    assert a.extra_coords.keys() == b.extra_coords.keys()
    for k, (dims, arr, cattrs) in a.extra_coords.items():
        bdims, barr, bcattrs = b.extra_coords[k]
        assert tuple(dims) == tuple(bdims) and cattrs == bcattrs
        np.testing.assert_array_equal(np.asarray(arr), np.asarray(barr))


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_state_files_cross_read(case, dtype, writer, tmp_path):
    """A state file written by either package reads back in both, bit for
    bit, with its metadata and grid form."""
    j, t = _states(case, dtype)
    path = str(tmp_path / "state.nc")
    (j if writer == "jax" else t).save_to_disk(path)
    jb = JState.from_netcdf(path, dtype=dtype)
    tb = EnsembleState.from_netcdf(path, dtype=dtype, device="cpu")
    assert tb.data.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(tb.data.numpy(), t.data.numpy())
    np.testing.assert_array_equal(np.asarray(jb.data), t.data.numpy())
    assert tb.structure == t.structure
    assert tb.structure.grid_is_2d == (case != "location grid")
    np.testing.assert_array_equal(tb.structure.lat, jb.structure.lat)
    np.testing.assert_array_equal(tb.structure.times_s, jb.structure.times_s)
    _same_meta(tb, t)
    _same_meta(tb, jb)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_both_writers_write_the_same_dataset(case, tmp_path):
    j, t = _states(case, "float64")
    j.save_to_disk(str(tmp_path / "j.nc"))
    t.save_to_disk(str(tmp_path / "t.nc"))
    a = ncio.read_dataset(str(tmp_path / "j.nc"))
    b = jncio.read_dataset(str(tmp_path / "t.nc"))
    assert a.dims == b.dims and list(a.variables) == list(b.variables)
    for k in a.variables:
        assert a.var_dims(k) == b.var_dims(k)
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])
    assert a.attrs.keys() == b.attrs.keys() and a.var_attrs == b.var_attrs
    if case == "location grid":
        assert a.var_dims("T2M") == ("validtime", "location", "mem")


def test_read_state_builds_on_the_device_and_dtype(tmp_path):
    j, _ = _states("grid with metadata", "float64")
    path = str(tmp_path / "state.nc")
    j.save_to_disk(path)
    st = ncio.read_state(path, device="cpu")
    assert st.data.dtype == torch.float32 and st.device.type == "cpu"
    np.testing.assert_array_equal(
        st.data.numpy(), np.asarray(j.data).astype(np.float32))
    st64 = ncio.read_state(path, dtype="float64", device=torch.device("cpu"))
    np.testing.assert_array_equal(st64.data.numpy(), np.asarray(j.data))


def test_reserved_bookkeeping_attrs_not_clobbered(tmp_path):
    """User attrs named like the writer's bookkeeping attrs do not corrupt
    the read-back."""
    _, t = _states("grid with metadata", "float64")
    t.structure.meta.attrs.update(var_order="BOGUS,NAMES",
                                  grid_is_2d=np.int8(0), extra_coords="nope")
    path = str(tmp_path / "collide.nc")
    t.save_to_disk(path)
    back = EnsembleState.from_netcdf(path, dtype="float64", device="cpu")
    assert back.structure.var_names == t.structure.var_names
    assert back.structure.grid_is_2d
    assert "fhour" in back.extra_coords
    np.testing.assert_array_equal(back.data.numpy(), t.data.numpy())


def test_posterior_carries_metadata_to_disk(tmp_path):
    """An update's posterior keeps the prior's metadata through a file."""
    _, t = _states("grid with metadata", "float64")
    s = t.structure
    batch = ObservationBatch(
        values=np.array([281.0, 279.5]), errors=np.ones(2),
        lats=s.lat[2:4, 3], lons=s.lon[2:4, 3],
        times_s=s.times_s[:2].copy(), obtypes=["T2M", "PS"],
        localize_radius=np.full(2, 800.0), assimilate_flags=np.ones(2, bool),
        verts=np.full(2, np.nan), descriptions=[None, None])
    post, _ = EnSRF(t, batch, config=FilterConfig(dtype="float64"),
                    verbose=False).update()
    path = str(tmp_path / "post.nc")
    post.save_to_disk(path)
    back = EnsembleState.from_netcdf(path, dtype="float64", device="cpu")
    _same_meta(back, t)
    np.testing.assert_array_equal(back.data.numpy(), post.data.numpy())


# --- observation batches ----------------------------------------------------


@pytest.fixture
def batches():
    """The same batch as JAX and port objects, its optional fields set."""
    state = make_demo_state(nmems=10, seed=1)
    jb = JBatch.coerce(make_demo_obs(state, nobs=13, seed=2, radius=900.0))
    jb.localize_radius[3] = np.inf
    jb.assimilate_flags[4] = False
    jb.verts[5] = 850.0
    jb.vert_radius[5] = 200.0
    jb.descriptions[6] = "buoy 46042"
    tb = interop.obs_batch_from_numpy(
        {k: getattr(jb, k) for k in _OBS_FIELDS if k != "custom_operator"})
    return state, jb, tb


def _same_batch(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
        elif isinstance(x, list):
            assert list(x) == list(y), f.name
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f.name)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_obs_files_cross_read(writer, batches, tmp_path):
    _, jb, tb = batches
    path = str(tmp_path / "obs.nc")
    (jncio if writer == "jax" else ncio).write_obs(
        path, jb if writer == "jax" else tb)
    back = ncio.read_obs(path)
    assert isinstance(back, ObservationBatch)
    _same_batch(back, jncio.read_obs(path))
    for k in _OBS_FIELDS:
        want = getattr(tb, k)
        got = getattr(back, k)
        if isinstance(want, list):
            assert got == want, k
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    assert back.prior_mean is None


def test_obs_file_with_results_cross_reads(batches, tmp_path):
    """A posterior batch (diagnostics, assimilated, outlier flags) written
    by the port reads back in both packages."""
    state, _, tb = batches
    s = state.structure
    data = np.asarray(state.data)
    tstate = interop.state_from_numpy(
        {n: data[i] for i, n in enumerate(s.var_names)},
        {"validtime": s.times64(), "lat": s.lat, "lon": s.lon},
        dtype="float64", device="cpu")
    cfg = FilterConfig(dtype="float64", outlier_threshold=1.0)
    _, out = EnSRF(tstate, tb, config=cfg, verbose=False).update()
    assert out.qc_outlier.any() and out.assimilated.any()
    path = str(tmp_path / "obs_post.nc")
    ncio.write_obs(path, out)
    _same_batch(ncio.read_obs(path), out)
    _same_batch(jncio.read_obs(path), out)
