"""The 13 cases of the JAX package's multi-device dry run
(``__graft_entry__.dryrun_multichip``, recorded in ``MULTICHIP_r05.json``)
through the port's ``parallel/``.

Each case runs the port on a mesh of ``[cpu] * 8`` and of ``[cpu]``, and
the JAX package on its 8 virtual CPU devices, on the same NumPy inputs in
float64: the 8-shard result equals the one-shard result and the JAX
package's at 1e-10 (the JAX dry run's own bound, here for the fused-kernel
case too: float64 instead of its float32).  The toy has 131 rows, not a
multiple of 8, and the LETKF a patch of 3, so every padding path runs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efa_xray_tpu.assimilation import enkf as jenkf
from efa_xray_tpu.assimilation import ensrf_core as jcore
from efa_xray_tpu.parallel import make_mesh as jmake_mesh
from efa_xray_tpu.parallel import sharded as jsharded
from efa_xray_tpu_torch import interop
from efa_xray_tpu_torch.parallel import make_mesh, sharded
from test_torch_adaptive_inflation import jax_stable_root  # noqa: F401
from test_torch_sharded import NDEV, close

TOL = 1e-10


def _toy(nstate=16 * NDEV + 3, nmems=8, nobs=6, seed=0):
    """``__graft_entry__._toy_arrays`` in float64 NumPy: ``(rows, obs)``,
    rows ``(bm, bp, tm, tp, lat, lon)``."""
    rng = np.random.default_rng(seed)
    prior = rng.normal(280.0, 3.0, (nstate, nmems))
    lat = rng.uniform(-60, 60, nstate)
    lon = rng.uniform(0, 360, nstate)
    rows = rng.integers(0, nstate, nobs)
    ye = prior[rows]
    obs = dict(values=ye.mean(1) + rng.normal(0, 1, nobs),
               errors=np.ones(nobs), lats=lat[rows], lons=lon[rows],
               radii=np.full(nobs, 2000.0), assim=np.ones(nobs, bool))
    return ((prior.mean(1), prior - prior.mean(1, keepdims=True), ye.mean(1),
             ye - ye.mean(1, keepdims=True), lat, lon), obs)


def _inputs(pkg, rows, obs, extra):
    """Rows, obs and the case's array keywords as ``pkg``'s arrays."""
    if pkg == "jax":
        arr, ob = jnp.asarray, jcore.ObsArrays(
            **{k: jnp.asarray(v) for k, v in obs.items()})
    else:
        arr = torch.from_numpy
        ob = interop.obs_arrays_from_numpy(**obs, dtype="float64",
                                           device="cpu")
    conv = {k: arr(np.array(v)) if isinstance(v, np.ndarray) else v
            for k, v in extra.items()}
    return [arr(np.array(r)) for r in rows], ob, conv


def _vertical(obs):
    n = obs["values"].shape[0]
    return dict(obs, verts=np.full(n, 500.0), vert_radii=np.full(n, 300.0))


def _driver_case(fn_name, make_kw, nstate=16 * NDEV + 3, nobs=6, seed=0,
                 obs_edit=None):
    def run(pkg, mesh, tmp_path):
        rows, obs = _toy(nstate=nstate, nobs=nobs, seed=seed)
        if obs_edit is not None:
            obs = obs_edit(obs)
        ns, no = rows[0].shape[0], rows[2].shape[0]
        kw = make_kw(ns, no, pkg)
        r, ob, kw = _inputs(pkg, rows, obs, kw)
        mod = jsharded if pkg == "jax" else sharded
        if fn_name == "enkf_update_sharded":
            eps = np.array(jenkf.draw_ob_perturbations(
                jax.random.PRNGKey(0), jnp.asarray(obs["errors"]),
                rows[1].shape[1]))
            r = r + [ob, jnp.asarray(eps) if pkg == "jax"
                     else torch.from_numpy(eps)]
            out = getattr(mod, fn_name)(*r, mesh=mesh, **kw)
        else:
            out = getattr(mod, fn_name)(*r, ob, mesh=mesh, **kw)
        return [np.asarray(x) for x in out[:4]]
    return run


def _ensrf(**kw):
    return lambda ns, no, pkg: dict(dict(localize=True, block_size=4), **kw)


def _ensrf_fastgeo_vertical(ns, no, pkg):
    """Chordal and vertical: the port's B2 route (its plain version here)
    against the JAX fused kernel it ports (interpret mode)."""
    kw = dict(localize=True, block_size=4, method="blocked",
              fast_geometry=True, vertical=True,
              body_vert=np.linspace(100.0, 1000.0, ns))
    if pkg == "jax":
        kw.update(use_pallas=True, interpret=True, tile=64)
    return kw


def _ensrf_hybrid(ns, no, pkg):
    return dict(localize=True, block_size=4, hybrid_alpha=0.5,
                body_sigma=np.full(ns, 1.5), tail_sigma=np.full(no, 1.5),
                static_length=800.0)


def _ensrf_varloc(ns, no, pkg):
    return dict(localize=True, block_size=4,
                varloc=np.array([[1.0, 0.3], [0.3, 1.0]]),
                row_var=np.arange(ns) % 2, ob_var=np.arange(no) % 2)


def _letkf(varloc):
    def make(ns, no, pkg):
        kw = dict(ngrid=ns, patch_size=3, k_obs=4, chunk=8)
        if varloc:
            kw.update(varloc=np.array([[1.0, 0.4], [0.4, 1.0]]),
                      ob_var=np.arange(no) % 2, group_var=np.zeros(1, int))
        return kw
    return make


def _fused(ns, no, pkg):
    kw = dict(localize=True, method="blocked", block_size=8,
              fast_geometry=True, donate=True)
    if pkg == "jax":
        kw.update(use_pallas=True, interpret=True, tile=64)
    return kw


def _api_state(pkg):
    """Two variables x two times on a 7 x 9 global grid (252 rows), 8
    members, 12 obs: the JAX dry run's public-API case at demo size."""
    from efa_xray_tpu.observation.observation import ObservationBatch
    from efa_xray_tpu.state.ensemble import EnsembleState
    from efa_xray_tpu.utils import timeutil

    rng = np.random.default_rng(11)
    ny, nx, nmems, nobs = 7, 9, 8, 12
    lon, lat = np.meshgrid(np.arange(0, 360, 360.0 / nx),
                           np.linspace(-80, 80, ny))
    times = (np.datetime64("2026-08-01T00")
             + np.arange(2) * np.timedelta64(6, "h"))
    vardict = {"T2m": rng.normal(280, 5, (2, ny, nx, nmems)),
               "PSFC": rng.normal(1000, 4, (2, ny, nx, nmems))}
    coords = {"validtime": times, "lat": lat, "lon": lon,
              "mem": np.arange(nmems)}
    fields = dict(
        values=rng.normal(280, 5, nobs), errors=np.ones(nobs),
        lats=rng.uniform(-70, 70, nobs), lons=rng.uniform(0, 360, nobs),
        times_s=timeutil.to_epoch_seconds(np.repeat(times[0], nobs)),
        obtypes=["T2m"] * nobs, localize_radius=np.full(nobs, 3000.0),
        assimilate_flags=np.ones(nobs, bool), verts=np.full(nobs, np.nan),
        descriptions=[None] * nobs)
    if pkg == "jax":
        return (EnsembleState.from_vardict(vardict, coords, dtype="float64"),
                ObservationBatch(**fields))
    return (interop.state_from_numpy(vardict, coords, dtype="float64",
                                     device="cpu"),
            interop.obs_batch_from_numpy(fields))


def _classes(pkg):
    if pkg == "jax":
        from efa_xray_tpu.assimilation.adaptive_inflation import (
            AdaptiveInflation,
        )
        from efa_xray_tpu.assimilation.ensrf import EnSRF
        from efa_xray_tpu.config import FilterConfig
    else:
        from efa_xray_tpu_torch import AdaptiveInflation, EnSRF, FilterConfig
    return EnSRF, FilterConfig, AdaptiveInflation


def _public_api(pkg, mesh, tmp_path):
    EnSRF, FilterConfig, _ = _classes(pkg)
    state, batch = _api_state(pkg)
    post, _ = EnSRF(state, batch, verbose=False, mesh=mesh,
                    config=FilterConfig(localization="GC",
                                        dtype="float64")).update()
    return [np.asarray(post.data)]


def _obs_chunked(pkg, mesh, tmp_path):
    """Chunks of 5 obs on one device against the one-shot mesh update; a
    mesh with ``obs_chunk`` refuses."""
    EnSRF, FilterConfig, _ = _classes(pkg)
    state, batch = _api_state(pkg)
    cfg = FilterConfig(localization="GC", dtype="float64", obs_chunk=5)
    with pytest.raises(ValueError, match="single-device"):
        EnSRF(state, batch, config=cfg, verbose=False, mesh=mesh).update()
    chunked, _ = EnSRF(state, batch, config=cfg, verbose=False).update()
    one, _ = EnSRF(state, batch, verbose=False, mesh=mesh,
                   config=FilterConfig(localization="GC",
                                       dtype="float64")).update()
    np.testing.assert_allclose(np.asarray(chunked.data),
                               np.asarray(one.data), rtol=0, atol=TOL)
    return [np.asarray(one.data)]


def _adaptive_inflation(pkg, mesh, tmp_path):
    """Two cycles with the Anderson update (evolved std, damping, cap)
    driving cycle 2's prior inflation: the posterior and the fields."""
    EnSRF, FilterConfig, AdaptiveInflation = _classes(pkg)
    state, batch = _api_state(pkg)
    cfg = FilterConfig(localization="GC", dtype="float64",
                       adaptive_sd_evolve=True, adaptive_sd_min=0.15,
                       adaptive_damp=0.8, adaptive_max=2.0)
    adapt = AdaptiveInflation(state, ("adaptive", str(tmp_path / "none.nc"),
                                      (1.0, 0.6)))
    cur = state
    for _ in range(2):
        cur, _ = EnSRF(cur, batch, inflation=adapt, config=cfg,
                       verbose=False, mesh=mesh).update()
    names = sorted(adapt.mean)
    assert any(float(np.max(adapt.mean[v])) > 1.0 + 1e-6 for v in names)
    return ([np.asarray(cur.data)]
            + [np.asarray(adapt.mean[v]) for v in names]
            + [np.asarray(adapt.std[v]) for v in names])


CASES = {
    "ensrf-blocked": _driver_case("ensrf_update_sharded",
                                  _ensrf(method="blocked")),
    "ensrf-serial": _driver_case("ensrf_update_sharded",
                                 _ensrf(method="serial")),
    "ensrf-fastgeo-vertical": _driver_case(
        "ensrf_update_sharded", _ensrf_fastgeo_vertical, obs_edit=_vertical),
    "ensrf-hybrid": _driver_case("ensrf_update_sharded", _ensrf_hybrid),
    "ensrf-varloc": _driver_case("ensrf_update_sharded", _ensrf_varloc),
    "letkf": _driver_case("letkf_update_sharded", _letkf(False)),
    "letkf-varloc": _driver_case("letkf_update_sharded", _letkf(True)),
    "enkf": _driver_case("enkf_update_sharded",
                         lambda ns, no, pkg: dict(localize=True)),
    "blocked-10243rows": _driver_case(
        "ensrf_update_sharded", _ensrf(method="blocked", block_size=8),
        nstate=10_240 + 3, nobs=16, seed=7),
    "fused-v4": _driver_case("ensrf_update_sharded", _fused, nstate=515,
                             seed=9),
    "public-api-ensrf-mesh": _public_api,
    "obs-chunked-public-api": _obs_chunked,
    "adaptive-inflation-mesh": _adaptive_inflation,
}


@pytest.mark.parametrize("case", list(CASES))
def test_dryrun_case_matches_one_shard_and_jax(case, tmp_path, request):
    run = CASES[case]
    if case == "adaptive-inflation-mesh":
        # the JAX Anderson root without its cancellation at a support
        # edge, as every inflation parity test runs it
        request.getfixturevalue("jax_stable_root")
    eight = run("torch", make_mesh(["cpu"] * NDEV), tmp_path)
    one = run("torch", make_mesh(["cpu"]), tmp_path)
    want = run("jax", jmake_mesh(), tmp_path)
    assert len(eight) == len(one) == len(want)
    for got, ref, jref in zip(eight, one, want):
        assert np.isfinite(got).all()
        close(got, ref, TOL, f"{case}: 8 shards vs 1")
        close(got, jref, TOL, f"{case}: port vs JAX")
