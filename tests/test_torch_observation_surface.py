"""The observation surface of the port against the JAX package's.

``Observation.estimate`` / ``distance_to_state`` / ``localize``, the
DataFrame round trip (``from_dataframe`` / ``to_dataframe`` /
``to_observations``), custom forward operators through
``EnSRF.update()`` (``compute_ob_priors``), the module-level ``update``,
the localization helpers (``distance_to_point``, ``pairwise_distance``,
``localization_weights``, ``gaspari_cohn_np``), ``forward.nearest_points``,
and the verification tables ``field_verification`` and
``desroziers_diagnostics``: the cases of ``tests/test_forward.py``,
``tests/test_edge_cases.py`` and ``tests/test_postprocess.py`` that these
serve, each held against the JAX package (1e-9, float64, CPU).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

import efa_xray_tpu
import efa_xray_tpu_torch
from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import assimilation as jassim
from efa_xray_tpu.assimilation.ensrf import EnSRF as JEnSRF
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.observation import forward as jfwd
from efa_xray_tpu.observation import localization as jloc
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu.postprocess import postprocess as jpost
from efa_xray_tpu.postprocess import verification as jver
from efa_xray_tpu_torch import (
    EnKF,
    EnSRF,
    FilterConfig,
    Observation,
    ObservationBatch,
    interop,
    update,
)
from efa_xray_tpu_torch.observation import forward as tfwd
from efa_xray_tpu_torch.observation import localization as tloc
from efa_xray_tpu_torch.postprocess import (
    desroziers_diagnostics,
    field_verification,
    obs_assimilation_statistics,
)

TOL = 1e-9


def _port_state(jstate):
    s = jstate.structure
    data = np.asarray(jstate.data)
    return interop.state_from_numpy(
        {n: data[i] for i, n in enumerate(s.var_names)},
        {"validtime": s.times64(), "lat": s.lat, "lon": s.lon},
        dtype="float64", device="cpu")


def _port_obs(jobs, **extra):
    """The port's copies of JAX ``Observation`` objects."""
    keys = ("value", "obtype", "time", "error", "lat", "lon", "vert",
            "assimilate_this", "description", "localize_radius",
            "vert_localize_radius")
    return [Observation(**{k: getattr(o, k) for k in keys}, **extra)
            for o in jobs]


def test_package_all_equals_jax():
    assert efa_xray_tpu_torch.__all__ == efa_xray_tpu.__all__
    for name in efa_xray_tpu_torch.__all__:
        assert getattr(efa_xray_tpu_torch, name) is not None


def test_observation_estimate_distance_and_localize_match_jax():
    jstate = make_demo_state(ny=6, nx=8, ntimes=2)
    tstate = _port_state(jstate)
    jobs = make_demo_obs(jstate, nobs=3, radius=600.0)
    tobs = _port_obs(jobs)
    for j, t in zip(jobs, tobs):
        np.testing.assert_allclose(t.estimate(tstate).numpy(),
                                   np.asarray(j.estimate(jstate)), rtol=TOL)
        np.testing.assert_allclose(t.distance_to_state(tstate).numpy(),
                                   np.asarray(j.distance_to_state(jstate)),
                                   rtol=TOL)
        np.testing.assert_allclose(t.localize(tstate), j.localize(jstate),
                                   rtol=TOL, atol=1e-15)
        np.testing.assert_allclose(t.localize(tobs), j.localize(jobs),
                                   rtol=TOL, atol=1e-15)
    tobs[0].localize_radius = None
    assert (tobs[0].localize(tstate) == 1.0).all()
    with pytest.raises(ValueError):
        tobs[1].localize(tstate, type="boxcar")
    # a custom operator's estimate is the operator's
    h = lambda st: st.data[0, 0].mean(dim=(0, 1))
    ob = Observation(value=1.0, obtype="X", forward_operator=h)
    assert torch.equal(ob.estimate(tstate), h(tstate))


def _df(jstate, n=12, seed=4):
    rng = np.random.default_rng(seed)
    s = jstate.structure
    return pd.DataFrame({
        "value": rng.normal(280, 2, n), "error": rng.uniform(0.5, 2, n),
        "lat": rng.uniform(43, 49, n), "lon": rng.uniform(232, 242, n),
        "time": np.repeat(s.times64()[0], n),
        "obtype": s.var_names[0],
        "localize_radius": np.where(rng.random(n) < 0.2, np.inf, 800.0),
        "assimilate_this": rng.random(n) > 0.1,
        "vert": np.where(rng.random(n) < 0.5, 500.0, np.nan),
        "description": [None if i % 3 else f"ob{i}" for i in range(n)],
    })


def test_dataframe_round_trip_matches_jax():
    jstate = make_demo_state(ny=6, nx=8, ntimes=2, nmems=10)
    df = _df(jstate)
    tb, jb = ObservationBatch.from_dataframe(df), JBatch.from_dataframe(df)
    for k in ("values", "errors", "lats", "lons", "times_s",
              "localize_radius", "assimilate_flags", "verts", "vert_radius"):
        np.testing.assert_array_equal(getattr(tb, k), getattr(jb, k), k)
    assert tb.obtypes == jb.obtypes and tb.descriptions == jb.descriptions
    # minimal columns take the defaults
    small = ObservationBatch.from_dataframe(df[["value", "error", "lat", "lon",
                                                "time", "obtype"]])
    assert np.isinf(small.localize_radius).all()
    assert small.assimilate_flags.all() and small.descriptions[0] is None
    # before and after a filter run, in both packages
    pd.testing.assert_frame_equal(tb.to_dataframe(), jb.to_dataframe())
    cfg = dict(localization="GC", dtype="float64")
    _, tout = EnSRF(_port_state(jstate), tb, config=FilterConfig(**cfg),
                    verbose=False).update()
    _, jout = JEnSRF(jstate, jb, config=JConfig(**cfg),
                     verbose=False).update()
    tdf, jdf = tout.to_dataframe(), jout.to_dataframe()
    assert list(tdf.columns) == list(jdf.columns)
    pd.testing.assert_frame_equal(tdf, jdf, rtol=TOL, atol=TOL)
    back = ObservationBatch.from_dataframe(tdf)
    np.testing.assert_array_equal(back.values, tb.values)
    np.testing.assert_array_equal(back.localize_radius, tb.localize_radius)
    tobs, jobs = tout.to_observations(), jout.to_observations()
    assert len(tobs) == len(jobs) == len(df)
    for t, j in zip(tobs, jobs):
        for k in ("value", "obtype", "error", "lat", "lon", "vert",
                  "assimilate_this", "description", "localize_radius",
                  "assimilated", "prior_mean", "post_mean"):
            a, b = getattr(t, k), getattr(j, k)
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=TOL, abs=TOL), k
            else:
                assert a == b, k
        assert t.time == j.time


def _custom_case(jstate):
    """``tests/test_forward.py``'s pluggable operators: a domain mean as a
    state-variable ob, and one with a non-state obtype and a time outside
    the window."""
    s = jstate.structure
    t_mean = lambda st: st.data[0, 0].mean(axis=(0, 1))
    t_all = lambda st: st.data[0].mean(axis=(0, 1, 2))
    j_mean = lambda st: jnp.mean(st.data[0, 0], axis=(0, 1))
    j_all = lambda st: jnp.mean(st.data[0], axis=(0, 1, 2))
    ye0 = np.asarray(j_mean(jstate), np.float64)
    ye1 = np.asarray(j_all(jstate), np.float64)
    specs = [
        dict(value=float(ye0.mean() + 0.5), obtype=s.var_names[0],
             time=s.times64()[0], error=0.5, lat=46.0, lon=237.0,
             assimilate_this=True, localize_radius=None),
        dict(value=float(ye1.mean() + 1.0), obtype="satellite_radiance_ch4",
             time=s.times64()[-1] + np.timedelta64(5, "D"), error=0.5,
             lat=45.0, lon=236.0, assimilate_this=True, localize_radius=None),
    ]
    plain = make_demo_obs(jstate, nobs=4, radius=900.0)
    from efa_xray_tpu.observation.observation import Observation as JObs

    jlist = ([JObs(**specs[0], forward_operator=j_mean)] + plain
             + [JObs(**specs[1], forward_operator=j_all)])
    tlist = ([Observation(**specs[0], forward_operator=t_mean)]
             + _port_obs(plain)
             + [Observation(**specs[1], forward_operator=t_all)])
    return jlist, tlist, (ye0.mean(), ye1.mean())


def test_custom_forward_operators_through_update_match_jax():
    jstate = make_demo_state(nmems=12, ntimes=2)
    jlist, tlist, (m0, m1) = _custom_case(jstate)
    cfg = dict(localization="GC", dtype="float64")
    jp, jb = JEnSRF(jstate, jlist, config=JConfig(**cfg),
                    verbose=False).update()
    tp, tb = EnSRF(_port_state(jstate), tlist, config=FilterConfig(**cfg),
                   verbose=False).update()
    np.testing.assert_allclose(tp.data.numpy(), np.asarray(jp.data),
                               rtol=TOL, atol=TOL)
    jb.materialize_diagnostics()
    np.testing.assert_allclose(tb.prior_mean, jb.prior_mean, rtol=TOL)
    # the first ob's recorded prior is its operator's (the later ones see
    # the tail after the obs before them)
    assert tb.prior_mean[0] == pytest.approx(m0, abs=1e-9)
    assert tb.assimilated.all() and all(o.assimilated for o in tlist)
    # the filter's compute_ob_priors is what the update used
    filt = EnSRF(_port_state(jstate), tlist, config=FilterConfig(**cfg),
                 verbose=False)
    means, perts = filt.compute_ob_priors()
    jm, jpe = JEnSRF(jstate, jlist, config=JConfig(**cfg),
                     verbose=False).compute_ob_priors()
    np.testing.assert_allclose(means.numpy(), np.asarray(jm), rtol=TOL)
    np.testing.assert_allclose(perts.numpy(), np.asarray(jpe), rtol=TOL,
                               atol=TOL)
    assert float(means[-1]) == pytest.approx(m1, abs=1e-9)


def test_custom_operator_rows_follow_the_hilbert_sort():
    """With ``obs_order="hilbert"`` each custom row goes where its ob sits
    in the sorted batch: the obs-space prior there is its own
    operator's."""
    jstate = make_demo_state(nmems=12, ntimes=2)
    _, tlist, (m0, m1) = _custom_case(jstate)
    filt = EnSRF(_port_state(jstate), tlist, config=FilterConfig(
        localization="GC", dtype="float64", obs_order="hilbert"),
        verbose=False)
    pos = filt._obs_unsort
    assert (pos[0], pos[-1]) != (0, len(tlist) - 1)  # the sort moved them
    means, _ = filt.compute_ob_priors()
    assert float(means[pos[0]]) == pytest.approx(m0, abs=1e-9)
    assert float(means[pos[-1]]) == pytest.approx(m1, abs=1e-9)
    _, tb = filt.update()
    assert tb.assimilated.all()


@pytest.mark.parametrize("solver", ["ensrf", "letkf", "enkf"])
def test_module_update_matches_the_solver_class(solver):
    """``update(state, obs, solver=...)`` is the solver's class update;
    for the EnSRF and the LETKF also the JAX package's ``update``."""
    jstate = make_demo_state(nmems=12, ntimes=1)
    jobs = make_demo_obs(jstate, nobs=6, radius=1200.0)
    tstate = _port_state(jstate)
    cfg = dict(localization="GC", dtype="float64")
    tp, tb = update(tstate, _port_obs(jobs), inflate=1.05, solver=solver,
                    config=FilterConfig(**cfg))
    if solver == "enkf":
        wp, _ = EnKF(tstate, _port_obs(jobs), inflation=1.05,
                     config=FilterConfig(**cfg), verbose=False).update()
        np.testing.assert_array_equal(tp.data.numpy(), wp.data.numpy())
    else:
        jp, _ = jassim.update(jstate, list(jobs), inflate=1.05,
                              solver=solver, config=JConfig(**cfg))
        np.testing.assert_allclose(tp.data.numpy(), np.asarray(jp.data),
                                   rtol=TOL, atol=TOL)
    assert tb.assimilated.all()


def test_module_update_refusals():
    tstate = _port_state(make_demo_state(ny=3, nx=4))
    with pytest.raises(ValueError, match="unknown solver"):
        update(tstate, [], solver="3dvar")


@pytest.mark.parametrize("solver", ["ensrf", "letkf", "enkf"])
def test_module_update_passes_mesh(solver):
    """``update(..., mesh=)`` hands the mesh to the solver: the posterior
    equals the single-device one and, for the EnSRF and the LETKF, the
    JAX package's ``update`` on its 8 CPU devices, at 1e-10."""
    from efa_xray_tpu.parallel import make_mesh as jmake_mesh
    from efa_xray_tpu_torch.parallel import make_mesh

    jstate = make_demo_state(ny=6, nx=8, nmems=10, seed=4)
    jobs = make_demo_obs(jstate, nobs=5, seed=5, radius=1500.0)
    tstate = _port_state(jstate)
    cfg = dict(localization="GC", dtype="float64")
    single, _ = update(tstate, _port_obs(jobs), solver=solver,
                       config=FilterConfig(**cfg))
    meshed, _ = update(tstate, _port_obs(jobs), solver=solver,
                       config=FilterConfig(**cfg),
                       mesh=make_mesh(["cpu"] * 8))
    np.testing.assert_allclose(meshed.data.numpy(), single.data.numpy(),
                               rtol=1e-10, atol=1e-10)
    assert not torch.equal(meshed.data, tstate.data)
    if solver != "enkf":
        jp, _ = jassim.update(jstate, list(jobs), solver=solver,
                              config=JConfig(**cfg), mesh=jmake_mesh())
        np.testing.assert_allclose(meshed.data.numpy(), np.asarray(jp.data),
                                   rtol=1e-10, atol=1e-10)


def test_localization_helpers_match_jax():
    rng = np.random.default_rng(8)
    glat, glon = rng.uniform(-89, 89, (5, 7)), rng.uniform(0, 360, (5, 7))
    la, lo = rng.uniform(-80, 80, 9), rng.uniform(-180, 360, 9)
    np.testing.assert_allclose(
        tloc.distance_to_point(glat, glon, 45.0, 200.0).numpy(),
        np.asarray(jloc.distance_to_point(glat, glon, 45.0, 200.0)),
        rtol=TOL)
    np.testing.assert_allclose(
        tloc.pairwise_distance(la, lo, glat.ravel(), glon.ravel()).numpy(),
        np.asarray(jloc.pairwise_distance(la, lo, glat.ravel(),
                                          glon.ravel())), rtol=TOL)
    for hw in (3000.0, np.inf):
        np.testing.assert_allclose(
            tloc.localization_weights(glat, glon, 10.0, 20.0, hw).numpy(),
            np.asarray(jloc.localization_weights(glat, glon, 10.0, 20.0,
                                                 hw)), rtol=TOL, atol=1e-15)
    d = rng.uniform(0, 5000, 50)
    np.testing.assert_array_equal(tloc.gaspari_cohn_np(d, 1200.0),
                                  jloc.gaspari_cohn_np(d, 1200.0))
    # the pole and the dateline (tests/test_edge_cases.py:71)
    assert float(tloc.haversine((90.0, 0.0), (90.0, 179.0))) == \
        pytest.approx(0.0, abs=1e-6)
    d_dl = float(tloc.haversine((0.0, 179.5), (0.0, -179.5)))
    assert d_dl == pytest.approx(111.2, abs=1.0)
    assert 0.9 < float(tloc.gaspari_cohn(torch.tensor([d_dl]), 500.0)) <= 1


def test_forward_nearest_points_matches_jax():
    rng = np.random.default_rng(3)
    glat, glon = rng.uniform(-60, 60, (9, 11)), rng.uniform(0, 360, (9, 11))
    for npt in (1, 4, 200):
        got = tfwd.nearest_points(glat, glon, 12.3, 45.6, npt)
        want = jfwd.nearest_points(glat, glon, 12.3, 45.6, npt)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    got = tfwd.nearest_points(glat[:, 0], glon[:, 0], 0.0, 10.0, 3)
    want = jfwd.nearest_points(glat[:, 0], glon[:, 0], 0.0, 10.0, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_verification_tables_match_jax():
    """``field_verification`` against a truth field and
    ``desroziers_diagnostics`` of an update's per-ob table, in both
    packages (``tests/test_postprocess.py``)."""
    jstate = make_demo_state(nvars=2, ntimes=2, ny=6, nx=8, nmems=10)
    tstate = _port_state(jstate)
    truth = np.asarray(jstate.data).mean(axis=-1) + 0.3
    for tr in (truth, np.transpose(truth, (1, 2, 3, 0))):
        pd.testing.assert_frame_equal(field_verification(tstate, tr),
                                      jver.field_verification(jstate, tr),
                                      rtol=TOL, atol=TOL)
    pd.testing.assert_frame_equal(
        field_verification(tstate, torch.as_tensor(truth)),
        jver.field_verification(jstate, truth), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        field_verification(tstate, truth[:, :1])
    jobs = make_demo_obs(jstate, nobs=12, radius=900.0)
    cfg = dict(localization="GC", dtype="float64")
    tp, tb = EnSRF(tstate, _port_obs(jobs), config=FilterConfig(**cfg),
                   verbose=False).update()
    jp, jb = JEnSRF(jstate, list(jobs), config=JConfig(**cfg),
                    verbose=False).update()
    tstats = obs_assimilation_statistics(tstate, tp, tb)
    jstats = jpost.obs_assimilation_statistics(jstate, jp, jb)
    for group_by in ("obtype", None):
        pd.testing.assert_frame_equal(
            desroziers_diagnostics(tstats, group_by=group_by),
            jver.desroziers_diagnostics(jstats, group_by=group_by),
            rtol=TOL, atol=TOL)
    none = tstats.assign(assimilated=False)
    with pytest.raises(ValueError):
        desroziers_diagnostics(none)


def test_taps_for_obs_on_grid_points_match_jax_without_a_full_search(
        monkeypatch):
    """Obs exactly at grid points (``examples/obs_pipeline.py``'s recipe)
    tie the separable search's first window often; its wider window gives
    the JAX package's taps (whose full-grid search serves every such ob)
    without the port's full-grid search."""
    from efa_xray_tpu.state.structure import StateStructure as JStructure
    from efa_xray_tpu_torch.state.structure import StateStructure

    ny = nx = 256
    lon, lat = np.meshgrid(np.arange(0, 360, 360 / nx),
                           np.linspace(-88, 88, ny))
    times = np.array([np.datetime64("2026-08-01")])
    rng = np.random.default_rng(0)
    iy, ix = rng.integers(1, ny - 1, 400), rng.integers(1, nx - 1, 400)
    la, lo = lat[iy, ix], lon[iy, ix]
    axes = tfwd.separable_grid_axes(lat, lon)
    _, cert = tfwd._nearest_separable(axes[0], axes[1], la, lo, 4)
    assert (~cert).sum() > 10  # the first window leaves many uncertified
    calls = []
    real = tfwd._host_full_search
    monkeypatch.setattr(tfwd, "_host_full_search",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    args = (la, lo, np.full(400, 0), np.zeros(400, np.int32))
    tst = StateStructure.build(["T"], times, lat, lon, 4)
    jst = JStructure.build(["T"], times, lat, lon, 4)
    got = tfwd.build_taps(tst, la, lo, tst.times_s[args[2]], args[3])
    want = jfwd.build_taps(jst, la, lo, jst.times_s[args[2]], args[3])
    assert not calls
    np.testing.assert_array_equal(got.rows, np.asarray(want.rows))
    np.testing.assert_allclose(got.weights, np.asarray(want.weights),
                               rtol=TOL, atol=1e-15)
