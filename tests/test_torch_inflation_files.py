"""The inflation file forms in the port against the JAX package (float64,
CPU, 1e-9): the str inflation spec (a per-variable factor field read from
a netCDF file) through ``inflate_state`` and ``EnSRF.update()``, and
``AdaptiveInflation``'s ``save_to_disk`` / load, with files written by
either package read by both.  Mirrors ``test_inflation.py``'s file cases.

One fault of the reference is pinned, not copied: the JAX constructor
catches every exception of ``_load`` and quietly builds fresh fields, so
an existing inflation file of other variables restarts the learned
inflation, and ``_load`` checks no shape, so a file of another grid gives
fields of the wrong shape; the port raises on both."""

import numpy as np
import pytest

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation.adaptive_inflation import (
    AdaptiveInflation as JAdaptive,
)
from efa_xray_tpu.assimilation.assimilation import inflate_state as j_inflate
from efa_xray_tpu.assimilation.ensrf import EnSRF as JEnSRF
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu.utils import ncio as jncio
from efa_xray_tpu_torch import AdaptiveInflation, EnSRF, FilterConfig, interop
from efa_xray_tpu_torch.assimilation.assimilation import inflate_state
from efa_xray_tpu_torch.utils import ncio

TOL = 1e-9
_BATCH_FIELDS = ("values", "errors", "lats", "lons", "times_s", "obtypes",
                 "localize_radius", "assimilate_flags", "verts",
                 "descriptions", "vert_radius")


def _state(**kw):
    j = make_demo_state(**kw)
    s = j.structure
    data = np.asarray(j.data)
    t = interop.state_from_numpy(
        {n: data[i] for i, n in enumerate(s.var_names)},
        {"validtime": s.times64(), "lat": s.lat, "lon": s.lon},
        dtype="float64", device="cpu")
    return j, t


def _factor_file(path, s):
    """Factors for the first variable as a full [ntimes, ny, nx] field,
    for the second as a [ny, nx] field broadcast over time; the third
    variable is not in the file (factor 1)."""
    rng = np.random.default_rng(9)
    ncio.write_dataset(path, ncio.NcDataset(
        dims={"validtime": s.ntimes, "y": s.ny, "x": s.nx},
        variables={
            s.var_names[0]: (("validtime", "y", "x"),
                             rng.uniform(1.0, 1.6, (s.ntimes, s.ny, s.nx))),
            s.var_names[1]: (("y", "x"), rng.uniform(0.8, 1.3, (s.ny, s.nx))),
        }))


def test_file_inflation_matches_jax(tmp_path):
    j, t = _state(nvars=3, ntimes=2, ny=4, nx=5, nmems=8)
    path = str(tmp_path / "inflation.nc")
    _factor_file(path, t.structure)
    got = inflate_state(t, path)
    want = j_inflate(j, path)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               rtol=TOL, atol=TOL)
    spread = interop.to_host(t.ensemble_spread())
    np.testing.assert_allclose(interop.to_host(got.ensemble_spread())[2],
                               spread[2], rtol=1e-12)
    np.testing.assert_allclose(interop.to_host(got.ensemble_mean()),
                               interop.to_host(t.ensemble_mean()), rtol=1e-12)


def test_update_with_an_inflation_file_matches_jax(tmp_path):
    j, t = _state(nvars=2, ntimes=2, ny=6, nx=8, nmems=12, seed=3)
    s = t.structure
    path = str(tmp_path / "inflation.nc")
    rng = np.random.default_rng(2)
    ncio.write_dataset(path, ncio.NcDataset(
        dims={"validtime": s.ntimes, "y": s.ny, "x": s.nx},
        variables={v: (("validtime", "y", "x"),
                       rng.uniform(1.0, 1.5, (s.ntimes, s.ny, s.nx)))
                   for v in s.var_names}))
    jb = JBatch.coerce(make_demo_obs(j, nobs=9, seed=4, radius=900.0))
    tb = interop.obs_batch_from_numpy({k: getattr(jb, k)
                                       for k in _BATCH_FIELDS})
    jpost, jobs = JEnSRF(j, jb, inflation=path, verbose=False,
                         config=JConfig(dtype="float64")).update()
    tpost, tobs = EnSRF(t, tb, inflation=path, verbose=False,
                        config=FilterConfig(dtype="float64")).update()
    np.testing.assert_allclose(tpost.data.numpy(), np.asarray(jpost.data),
                               rtol=TOL, atol=TOL)
    jobs.materialize_diagnostics()
    np.testing.assert_allclose(tobs.prior_var, np.asarray(jobs.prior_var),
                               rtol=TOL, atol=TOL)


def _learned(adapt, s, seed=1):
    """Make an inflation's fields nonuniform."""
    rng = np.random.default_rng(seed)
    for v in s.var_names:
        adapt.mean[v] = rng.uniform(1.0, 1.8, adapt.mean[v].shape)
        adapt.std[v] = rng.uniform(0.1, 0.6, adapt.std[v].shape)
    return adapt


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_adaptive_inflation_files_cross_read(writer, tmp_path):
    j, t = _state(nvars=2, ntimes=2, ny=5, nx=6, nmems=8)
    s = t.structure
    path = str(tmp_path / "prior_inflation.nc")
    src = (JAdaptive(j, ("adaptive", None, (1.0, 0.6))) if writer == "jax"
           else AdaptiveInflation(t, ("adaptive", None, (1.0, 0.6))))
    _learned(src, s).save_to_disk(path)
    got = AdaptiveInflation(t, ("adaptive", path, (9.9, 9.9)))
    want = JAdaptive(j, ("adaptive", path, (9.9, 9.9)))
    for v in s.var_names:
        np.testing.assert_array_equal(got.mean[v], src.mean[v])
        np.testing.assert_array_equal(got.std[v], src.std[v])
        np.testing.assert_array_equal(np.asarray(want.mean[v]), src.mean[v])
        np.testing.assert_array_equal(np.asarray(want.std[v]), src.std[v])
    np.testing.assert_allclose(got.inflate_state(t).data.numpy(),
                               np.asarray(want.inflate_state(j).data),
                               rtol=TOL, atol=TOL)


def test_both_writers_write_the_same_inflation_file(tmp_path):
    j, t = _state(nvars=2, ntimes=3, ny=4, nx=5, nmems=8)
    s = t.structure
    _learned(JAdaptive(j, ("adaptive", None, (1.0, 0.6))), s).save_to_disk(
        str(tmp_path / "j.nc"))
    _learned(AdaptiveInflation(t, ("adaptive", None, (1.0, 0.6))),
             s).save_to_disk(str(tmp_path / "t.nc"))
    a = jncio.read_dataset(str(tmp_path / "j.nc"))
    b = ncio.read_dataset(str(tmp_path / "t.nc"))
    assert a.dims == b.dims and list(a.variables) == list(b.variables)
    for k in a.variables:
        assert a.var_dims(k) == b.var_dims(k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_missing_file_builds_fresh_fields(tmp_path):
    _, t = _state(nmems=8)
    adapt = AdaptiveInflation(
        t, ("adaptive", str(tmp_path / "none.nc"), (1.2, 0.3)))
    v = t.structure.var_names[0]
    np.testing.assert_array_equal(adapt.mean[v], 1.2)
    np.testing.assert_array_equal(adapt.std[v], 0.3)
    fresh = AdaptiveInflation(t, ("adaptive", None, (1.1, 0.2)))
    np.testing.assert_array_equal(fresh.mean[v], 1.1)


@pytest.mark.parametrize("fault", ["other variables", "other grid"])
def test_unreadable_existing_file_raises(fault, tmp_path):
    """An existing inflation file that does not fit the state raises in
    the port.  The JAX package raises nothing: a file of other variables
    quietly restarts from the initial values (its constructor's ``except
    Exception``), and a file of another grid is taken as it is, fields of
    the wrong shape."""
    shape = dict(nvars=2, ntimes=2, ny=5, nx=6, nmems=8)
    j, t = _state(**shape)
    other = _state(**{**shape, **({"ny": 4} if fault == "other grid" else
                                  {"var_names": ["U", "V"]})})[1]
    path = str(tmp_path / "prior_inflation.nc")
    AdaptiveInflation(other, ("adaptive", None, (1.5, 0.4))).save_to_disk(
        path)
    with pytest.raises(ValueError, match="inflation file"):
        AdaptiveInflation(t, ("adaptive", path, (1.0, 0.6)))
    ref = JAdaptive(j, ("adaptive", path, (1.0, 0.6)))
    for v in j.structure.var_names:
        if fault == "other grid":
            assert np.asarray(ref.mean[v]).shape == (2, 4, 6)
            np.testing.assert_array_equal(np.asarray(ref.mean[v]), 1.5)
        else:
            np.testing.assert_array_equal(np.asarray(ref.mean[v]), 1.0)
            np.testing.assert_array_equal(np.asarray(ref.std[v]), 0.6)
