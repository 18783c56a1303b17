"""The state surface of the port against the JAX package's.

The same states (``conftest.make_demo_state``, a metadata-rich one as in
``tests/test_metadata.py``, a dateline grid) in both packages, through the
methods the port adds: ``isel`` / ``sel``, the arithmetic and ``where``,
``astype``, ``ensemble_spread``, ``nearest_points``, ``interpolate``,
``distance_to_point``, ``haversine``, ``project_coordinates``, the
carried ``attrs`` / ``var_attrs`` / ``extra_coords``, and
``StateStructure.subset`` / ``with_nmems``.  The cases of
``tests/test_state.py`` and ``tests/test_metadata.py`` that these serve,
each held against the JAX package's result (data at 1e-12, structure and
metadata equal), float64 on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation.ensrf import EnSRF as JEnSRF
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.state.ensemble import EnsembleState as JState
from efa_xray_tpu_torch import EnSRF, EnsembleState, FilterConfig
from efa_xray_tpu_torch.observation.observation import Observation

TOL = 1e-12


def _port(jstate, **kw):
    """The port's copy of a JAX state (metadata included)."""
    s = jstate.structure
    data = np.asarray(jstate.data)
    coords = {"validtime": s.times64(), "lat": s.lat, "lon": s.lon}
    for name, (dims, arr, _) in jstate.extra_coords.items():
        coords[name] = (dims, np.asarray(arr))
    return EnsembleState.from_vardict(
        {n: data[i] for i, n in enumerate(s.var_names)}, coords,
        dtype=kw.pop("dtype", "float64"), device="cpu",
        attrs=jstate.attrs or None, var_attrs=jstate.var_attrs or None)


def _rich_jstate(ny=6, nx=8, ntimes=3, nmems=5, seed=3):
    rng = np.random.default_rng(seed)
    lon, lat = np.meshgrid(np.linspace(230.0, 244.0, nx),
                           np.linspace(42.0, 50.0, ny))
    times = (np.datetime64("2026-08-01T00")
             + np.arange(ntimes) * np.timedelta64(6, "h"))
    return JState.from_vardict(
        {"T2m": rng.normal(280, 5, (ntimes, ny, nx, nmems)),
         "PSFC": rng.normal(1000, 5, (ntimes, ny, nx, nmems))},
        {"validtime": times, "lat": lat, "lon": lon, "mem": np.arange(nmems),
         "orog": (("y", "x"), rng.normal(500, 100, (ny, nx))),
         "fhour": (("validtime",), np.arange(ntimes) * 6.0)},
        dtype="float64", attrs={"title": "subset"},
        var_attrs={"T2m": {"units": "K"}, "PSFC": {"units": "hPa"}})


def _dateline_jstate():
    lon, lat = np.meshgrid(np.arange(0, 360, 30.0), np.linspace(-30, 30, 4))
    times = np.datetime64("2026-08-01T00") + np.arange(1)
    return JState.from_vardict(
        {"T2m": np.random.default_rng(0).normal(280, 5, (1, 4, 12, 5))},
        {"validtime": times, "lat": lat, "lon": lon}, dtype="float64")


def _assert_same_state(got, want):
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               rtol=TOL, atol=TOL)
    g, w = got.structure, want.structure
    assert g.var_names == w.var_names and g.nmems == w.nmems
    np.testing.assert_array_equal(g.times_s, w.times_s)
    np.testing.assert_array_equal(g.lat, w.lat)
    np.testing.assert_array_equal(g.lon, w.lon)
    assert got.attrs == want.attrs and got.var_attrs == want.var_attrs
    assert sorted(got.extra_coords) == sorted(want.extra_coords)
    for k, (dims, arr, at) in want.extra_coords.items():
        gd, ga, gat = got.extra_coords[k]
        assert tuple(gd) == tuple(dims) and gat == at
        np.testing.assert_array_equal(ga, np.asarray(arr))


def _times(st):
    return st.ensemble_times()


SELECTIONS = {
    "isel positions": lambda st: st.isel(
        vars=1, validtime=slice(1, 3), y=[0, 2, 4], x=np.arange(4),
        mem=slice(0, 5)),
    "isel vars by name": lambda st: st.isel(vars=["PSFC", "T2m"]),
    "isel bool mask": lambda st: st.isel(vars=np.array([False, True])),
    "isel scalar keeps dims": lambda st: st.isel(validtime=1, y=-1),
    "sel time nearest": lambda st: st.sel(
        validtime=_times(st)[1] + np.timedelta64(1, "h")),
    "sel time exact": lambda st: st.sel(validtime=_times(st)[2],
                                        method="exact"),
    "sel time window": lambda st: st.sel(
        validtime=slice(_times(st)[1], _times(st)[2])),
    "sel open end, vars, lat box": lambda st: st.sel(
        vars="T2m", validtime=slice(_times(st)[1], None),
        lat=slice(44.0, 48.0)),
    "sel lat/lon box": lambda st: st.sel(lat=slice(44.0, 48.0),
                                         lon=slice(233.0, 240.0)),
    "sel scalar lat": lambda st: st.sel(lat=45.7),
    "sel scalar lon": lambda st: st.sel(lon=236.9, mem=[0, 3]),
}


@pytest.mark.parametrize("case", list(SELECTIONS))
def test_selection_matches_jax(case):
    jstate = _rich_jstate()
    got = SELECTIONS[case](_port(jstate))
    want = SELECTIONS[case](jstate)
    _assert_same_state(got, want)
    assert got.shape() == want.shape()


def test_sel_lon_wraps_dateline():
    jstate = _dateline_jstate()
    got = _port(jstate).sel(lon=slice(300.0, 60.0))
    _assert_same_state(got, jstate.sel(lon=slice(300.0, 60.0)))
    assert set(np.mod(got.structure.lon[0], 360.0).tolist()) == {
        300.0, 330.0, 0.0, 30.0, 60.0}
    full = _port(jstate).sel(lon=slice(0.0, 360.0))
    assert full.structure.nx == 12


@pytest.mark.parametrize("call,exc", [
    (lambda st: st.isel(validtime=7), IndexError),
    (lambda st: st.isel(y=np.array([], dtype=int)), IndexError),
    (lambda st: st.isel(vars=np.array([True])), IndexError),
    (lambda st: st.sel(validtime=_times(st)[1] + np.timedelta64(1, "h"),
                       method="exact"), KeyError),
    (lambda st: st.sel(validtime=slice(_times(st)[-1]
                                       + np.timedelta64(1, "D"), None)),
     KeyError),
    (lambda st: st.sel(lat=slice(80.0, 85.0)), KeyError),
    (lambda st: st.sel(vars="nope"), KeyError),
])
def test_selection_refusals(call, exc):
    with pytest.raises(exc):
        call(_port(_rich_jstate()))


def test_structure_subset_and_with_nmems_match_jax():
    js = _rich_jstate().structure
    ts = _port(_rich_jstate()).structure
    idx = (np.array([1]), np.array([0, 2]), np.array([1, 3]), None,
           np.array([0, 1, 4]))
    got, want = ts.subset(*idx), js.subset(*idx)
    assert got.shape == want.shape and got.var_names == want.var_names
    np.testing.assert_array_equal(got.lat, want.lat)
    assert got.meta.var_attrs == want.meta.var_attrs
    for k in want.meta.coords:
        np.testing.assert_array_equal(got.meta.coords[k][1],
                                      want.meta.coords[k][1])
    assert ts.with_nmems(9).nmems == js.with_nmems(9).nmems == 9
    assert ts.with_nmems(9).var_names == ts.var_names


def _w():
    return np.linspace(0.5, 1.5, 5)


ARITHMETIC = {
    "b - a": lambda a, b, lib: b - a,
    "a + b": lambda a, b, lib: a + b,
    "a * 2": lambda a, b, lib: a * 2.0,
    "3 * a": lambda a, b, lib: 3.0 * a,
    "1 + a": lambda a, b, lib: 1.0 + a,
    "2 - a": lambda a, b, lib: 2.0 - a,
    "1 / (a + 10)": lambda a, b, lib: 1.0 / (a + 10.0),
    "(a + 10) / 2": lambda a, b, lib: (a + 10.0) / 2.0,
    "(a + 10) ** 2": lambda a, b, lib: (a + 10.0) ** 2,
    "2 ** ((a - a) + 1.5)": lambda a, b, lib: 2.0 ** ((a - a) + 1.5),
    "-a": lambda a, b, lib: -a,
    "abs(a)": lambda a, b, lib: abs(a),
    "a * w (per member)": lambda a, b, lib: a * _w(),
    "w * a (NumPy on the left)": lambda a, b, lib: _w() * a,
    "w - a": lambda a, b, lib: _w() - a,
    "where(cond)": lambda a, b, lib: a.where(
        np.asarray(lib(a.data)) > np.asarray(lib(a.data)).mean()),
    "where(cond, -1)": lambda a, b, lib: a.where(
        np.asarray(lib(a.data)) > 280.0, -1.0),
    "where(state, state)": lambda a, b, lib: a.where(b - a, b),
    "astype float32": lambda a, b, lib: a.astype("float32"),
}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("case", list(ARITHMETIC))
def test_arithmetic_matches_jax(case):
    ja = make_demo_state(nvars=2, ntimes=2, ny=3, nx=4, nmems=5, seed=0)
    jb = make_demo_state(nvars=2, ntimes=2, ny=3, nx=4, nmems=5, seed=1)
    got = ARITHMETIC[case](_port(ja), _port(jb), _np)
    want = ARITHMETIC[case](ja, jb, _np)
    assert isinstance(got, EnsembleState)
    g, w = got.data.numpy(), np.asarray(want.data)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g[~np.isnan(g)], w[~np.isnan(w)], rtol=1e-6
                               if case.startswith("astype") else TOL)
    assert got.data.dtype == getattr(torch, str(w.dtype))


def test_arithmetic_refuses_mismatches():
    a = _port(make_demo_state(nvars=1, ntimes=2, ny=3, nx=4, nmems=5))
    small = _port(make_demo_state(nvars=1, ntimes=2, ny=3, nx=4, nmems=3))
    with pytest.raises(ValueError, match="mismatch"):
        _ = a + small
    shifted = EnsembleState(a.data, dataclasses.replace(
        a.structure, times_s=a.structure.times_s + 3600))
    _ = a + _port(make_demo_state(nvars=1, ntimes=2, ny=3, nx=4, nmems=5,
                                  seed=1))
    with pytest.raises(ValueError, match="coordinate mismatch"):
        _ = a + shifted
    with pytest.raises(ValueError, match="coordinate mismatch"):
        _ = a.where(a.data > 0, shifted)


def test_geometry_and_statistics_match_jax():
    jstate = make_demo_state(ny=10, nx=12, ntimes=2)
    tstate = _port(jstate)
    s = jstate.structure
    np.testing.assert_allclose(tstate.ensemble_spread().numpy(),
                               np.asarray(jstate.ensemble_spread()),
                               rtol=TOL, atol=TOL)
    d = tstate.distance_to_point(45.0, 235.0)
    assert d.shape == (10, 12) and float(d.min()) >= 0
    np.testing.assert_allclose(
        d.numpy(), np.asarray(jstate.distance_to_point(45.0, 235.0)),
        rtol=TOL)
    y0, x0 = 4, 7
    for npt in (1, 4):
        got = tstate.nearest_points(float(s.lat[y0, x0]) + 0.01,
                                    float(s.lon[y0, x0]) - 0.02, npt=npt)
        want = jstate.nearest_points(float(s.lat[y0, x0]) + 0.01,
                                     float(s.lon[y0, x0]) - 0.02, npt=npt)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert (int(got[0][0]), int(got[1][0])) == (y0, x0)
    t = s.times64()[0] + np.timedelta64(2, "h")
    np.testing.assert_allclose(
        tstate.interpolate("T2m", t, 45.3, 237.1).numpy(),
        np.asarray(jstate.interpolate("T2m", t, 45.3, 237.1)), rtol=TOL)
    assert tstate.interpolate("T2m", s.times64()[-1]
                              + np.timedelta64(5, "D"), 45.0, 237.0) is None
    np.testing.assert_allclose(
        float(tstate.haversine((0.0, 179.5), (0.0, -179.5))),
        float(jstate.haversine((0.0, 179.5), (0.0, -179.5))), rtol=TOL)
    proj = lambda lo, la: (lo * 2.0, la + 1.0)
    for a, b in zip(tstate.project_coordinates(proj),
                    jstate.project_coordinates(proj)):
        np.testing.assert_array_equal(a, b)


def test_1d_location_grid_nearest_points_and_interpolate():
    rng = np.random.default_rng(2)
    lats, lons = rng.uniform(30, 50, 25), rng.uniform(230, 250, 25)
    times = np.datetime64("2026-08-01T00") + np.arange(2) * np.timedelta64(
        6, "h")
    jstate = JState.from_vardict(
        {"T2m": (("validtime", "location", "mem"),
                 rng.normal(280, 2, (2, 25, 6)))},
        {"validtime": times, "lat": ("location", lats),
         "lon": ("location", lons)}, dtype="float64")
    tstate = _port(jstate)
    for a, b in zip(tstate.nearest_points(40.0, 240.0, npt=3),
                    jstate.nearest_points(40.0, 240.0, npt=3)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(
        tstate.interpolate("T2m", times[0], 40.0, 240.0).numpy(),
        np.asarray(jstate.interpolate("T2m", times[0], 40.0, 240.0)),
        rtol=TOL)


def test_metadata_carried_and_survives_update():
    """``tests/test_metadata.py``: attrs, var attrs and extra coordinates
    ride on the state and through an update."""
    jstate = _rich_jstate()
    tstate = _port(jstate)
    assert tstate.attrs == {"title": "subset"}
    assert tstate.var_attrs["T2m"]["units"] == "K"
    dims, arr, _ = tstate.extra_coords["fhour"]
    assert dims == ("validtime",)
    np.testing.assert_allclose(arr, [0.0, 6.0, 12.0])
    obs = [Observation(value=281.0, obtype="T2m", time=_times(tstate)[0],
                       error=1.0, lat=46.0, lon=237.0, assimilate_this=True,
                       localize_radius=1500.0)]
    post, _ = EnSRF(tstate, obs, config=FilterConfig(dtype="float64"),
                    verbose=False).update()
    assert post.attrs == tstate.attrs and post.var_attrs == tstate.var_attrs
    assert sorted(post.extra_coords) == ["fhour", "orog"]


def test_sel_subset_assimilates_like_jax():
    """A subset is a whole state: the same update in both packages
    (``tests/test_state.py:324``)."""
    jstate = make_demo_state(ny=6, nx=8, nmems=12)
    jsub = jstate.sel(validtime=slice(jstate.ensemble_times()[1], None))
    tsub = _port(jstate).sel(validtime=slice(jstate.ensemble_times()[1],
                                             None))
    obs = make_demo_obs(jsub, nobs=4, radius=1500.0)
    tobs = [Observation(value=o.value, obtype=o.obtype, time=o.time,
                        error=o.error, lat=o.lat, lon=o.lon,
                        assimilate_this=True, localize_radius=1500.0)
            for o in obs]
    jpost, _ = JEnSRF(jsub, list(obs), config=JConfig(
        localization="GC", dtype="float64"), verbose=False).update()
    tpost, tbatch = EnSRF(tsub, tobs, config=FilterConfig(
        localization="GC", dtype="float64"), verbose=False).update()
    np.testing.assert_allclose(tpost.data.numpy(), np.asarray(jpost.data),
                               rtol=1e-9, atol=1e-9)
    assert tbatch.assimilated.all() and all(o.assimilated for o in tobs)


@pytest.mark.parametrize("call,item", [
    (lambda st: st.shard(None), "parallel.mesh.Mesh"),
])
def test_unported_io_and_sharding_raise(call, item):
    """Sharding is ported (``tests/test_torch_sharded.py``), as is the
    netCDF I/O (``tests/test_torch_ncio.py``): ``shard`` without a mesh
    raises, naming what it takes."""
    with pytest.raises(TypeError, match=item):
        call(_port(make_demo_state(ny=3, nx=4)))


def test_where_with_jax_style_state_mask():
    """``where`` takes a state as the mask, as ``a.replace_data(cond)``
    builds it in ``tests/test_state.py:397``."""
    ja = make_demo_state(nvars=1, ntimes=2, ny=3, nx=4, nmems=5, seed=0)
    jb = make_demo_state(nvars=1, ntimes=2, ny=3, nx=4, nmems=5, seed=1)
    a, b = _port(ja), _port(jb)
    cond = a.data.numpy() > a.data.numpy().mean()
    got = a.where(a.replace_data(torch.as_tensor(cond)), b)
    want = ja.where(ja.replace_data(jnp.asarray(cond)), jb)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               rtol=TOL)
