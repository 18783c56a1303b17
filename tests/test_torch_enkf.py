"""The stochastic EnKF in the port against the JAX package.

JAX's threefry draws cannot be reproduced in torch, so parity means: given
the same perturbation table, the same analysis.  The core functions take
the JAX package's ``eps``; at the class level the port's
``draw_ob_perturbations`` is patched to return the JAX table for the same
seed and errors (the only JAX behaviour the port does not carry).  Float64
on the CPU, 1e-9 (the mesh case: 1e-10).  Each case of
``tests/test_enkf.py`` has its counterpart here, plus ``apply_rows``
itself, the refusals and the routing (the EnKF never reaches a body
kernel)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import enkf as jenkf
from efa_xray_tpu.assimilation import ensrf_core as jcore
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu_torch import EnKF, EnsembleState, FilterConfig, interop
from efa_xray_tpu_torch.assimilation import enkf as tenkf
from efa_xray_tpu_torch.assimilation import ensrf_core as tcore
from efa_xray_tpu_torch.models import lorenz96

TOL = 1e-9
_BATCH_FIELDS = ("values", "errors", "lats", "lons", "times_s", "obtypes",
                 "localize_radius", "assimilate_flags", "verts",
                 "descriptions", "vert_radius")


def _toy(nstate=60, nmems=16, nobs=7, seed=0, vertical=False):
    """``tests/test_enkf.py``'s toy as NumPy, and its JAX and port
    inputs: ``(jax_args, port_args)``, each ``(bm, bp, tm, tp, lat, lon,
    obs)`` (plus ``body_vert`` when ``vertical``)."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-60, 60, nstate)
    lon = rng.uniform(0, 360, nstate)
    prior = rng.normal(280, 3, (nstate, nmems))
    rows = rng.integers(0, nstate, nobs)
    ye = prior[rows]
    o = dict(values=ye.mean(1) + rng.normal(0, 1, nobs), errors=np.ones(nobs),
             lats=lat[rows], lons=lon[rows], radii=np.full(nobs, 3000.0),
             assim=rng.random(nobs) > 0.15)
    if vertical:
        o.update(verts=rng.uniform(100, 900, nobs),
                 vert_radii=np.full(nobs, 300.0))
    arrays = [prior.mean(1), prior - prior.mean(1, keepdims=True),
              ye.mean(1), ye - ye.mean(1, keepdims=True), lat, lon]
    bvert = rng.uniform(100, 900, nstate) if vertical else None
    jargs = [jnp.asarray(a) for a in arrays] + [jcore.ObsArrays(
        **{k: jnp.asarray(v) for k, v in o.items()})]
    targs = [torch.from_numpy(a) for a in arrays] + [
        interop.obs_arrays_from_numpy(**o, dtype="float64", device="cpu")]
    if vertical:
        return jargs, targs, bvert
    return jargs, targs


def _jeps(seed, errors, nmems, scale=True):
    return np.array(jenkf.draw_ob_perturbations(
        jax.random.PRNGKey(seed), jnp.asarray(errors), nmems, scale=scale))


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               rtol=tol, atol=tol)


def _same_update(got, want):
    for i in range(4):
        _close(got[i], want[i])
    for f in range(5):
        _close(got[4][f], want[4][f])


@pytest.mark.parametrize("scale", [True, False])
def test_perturbations_centered_and_variance_exact(scale):
    """Centred rows; with ``scale`` each row's ddof=1 variance is exactly
    R; on the device and in the dtype of ``errors``; fixed by the seed."""
    errors = torch.tensor([1.0, 4.0, 0.25], dtype=torch.float64)
    eps = tenkf.draw_ob_perturbations(3, errors, nmems=32, scale=scale)
    assert eps.shape == (3, 32) and eps.dtype == torch.float64
    np.testing.assert_allclose(eps.mean(dim=1).numpy(), 0.0, atol=1e-12)
    var = eps.var(dim=1, correction=1).numpy()
    if scale:
        np.testing.assert_allclose(var, errors.numpy(), rtol=1e-10)
    else:
        assert not np.allclose(var, errors.numpy(), rtol=1e-6)
    assert torch.equal(eps, tenkf.draw_ob_perturbations(3, errors, 32,
                                                        scale=scale))
    assert not torch.equal(eps, tenkf.draw_ob_perturbations(4, errors, 32,
                                                            scale=scale))
    e32 = tenkf.draw_ob_perturbations(3, errors.float(), 32, scale=scale)
    assert e32.dtype == torch.float32


def test_zero_perturbations_single_ob_identities():
    """One ob, eps = 0: the EnKF mean equals the EnSRF mean (same gain) and
    the perturbation increments differ by exactly beta; the port meets the
    JAX package on both."""
    jargs, targs = _toy(nobs=1)
    jargs[6] = jargs[6]._replace(assim=jnp.ones(1, bool))
    targs[6] = targs[6]._replace(assim=torch.ones(1, dtype=torch.bool))
    nmems = targs[1].shape[1]
    got = tenkf.enkf_serial(*targs, torch.zeros((1, nmems),
                                                dtype=torch.float64))
    want = jenkf.enkf_serial(*jargs, jnp.zeros((1, nmems)))
    _same_update(got, want)
    srf = tcore.ensrf_serial(*targs)
    _close(got[0], srf[0].numpy())
    ye = targs[3][0]
    kdenom = float(ye.var(correction=0)) + 1.0
    beta = 1.0 / (1.0 + np.sqrt(1.0 / kdenom))
    bp = targs[1].numpy()
    np.testing.assert_allclose(bp - srf[1].numpy(),
                               beta * (bp - got[1].numpy()), rtol=1e-10,
                               atol=1e-12)
    assert float(got[1].var()) < float(srf[1].var())


def test_monte_carlo_variance_matches_ensrf():
    """Averaged over 160 of the port's draws, the stochastic posterior
    variance is the EnSRF's, row by row."""
    jargs, targs = _toy(nstate=40, nmems=20, nobs=5, seed=4)
    ob = targs[6]._replace(assim=torch.ones(5, dtype=torch.bool),
                           radii=torch.full((5,), float("inf"),
                                            dtype=torch.float64))
    targs[6] = ob
    _, bp_s, *_ = tcore.ensrf_serial(*targs, localize=False)
    var_srf = bp_s.var(dim=1, correction=1).numpy()
    var_mc = np.mean([
        tenkf.enkf_serial(*targs, tenkf.draw_ob_perturbations(
            s, ob.errors, 20), localize=False)[1].var(
                dim=1, correction=1).numpy()
        for s in range(160)], axis=0)
    ratio = var_mc.mean() / var_srf.mean()
    assert 0.9 < ratio < 1.1, ratio
    np.testing.assert_allclose(var_mc, var_srf, rtol=0.35)


@pytest.mark.parametrize("localize,fast_geometry",
                         [(True, False), (True, True), (False, False)])
def test_enkf_blocked_equals_serial(localize, fast_geometry):
    """With the JAX package's draws: the port's serial update meets the
    JAX package's, and the blocked form (tail scan, then the body with
    ``apply_rows = z``) meets the serial one at every block size,
    QC-masked obs included."""
    jargs, targs = _toy(nobs=23, seed=4)
    eps = _jeps(9, np.ones(23), 16)
    kw = dict(localize=localize, fast_geometry=fast_geometry)
    serial = tenkf.enkf_serial(*targs, torch.from_numpy(eps), **kw)
    _same_update(serial, jenkf.enkf_serial(*jargs, jnp.asarray(eps), **kw))
    for bs in (4, 8, 23, 64):
        blocked = tenkf.enkf_blocked(*targs, torch.from_numpy(eps),
                                     block_size=bs, **kw)
        _same_update(blocked, [x.numpy() for x in serial[:4]]
                     + [[d.numpy() for d in serial[4]]])
        if bs == 8:
            _same_update(blocked, jenkf.enkf_blocked(
                *jargs, jnp.asarray(eps), block_size=bs, **kw))


def test_enkf_blocked_equals_serial_vertical():
    jargs, targs, bvert = _toy(nobs=15, seed=6, vertical=True)
    eps = _jeps(3, np.ones(15), 16)
    kw = dict(localize=True, vertical=True)
    serial = tenkf.enkf_serial(*targs, torch.from_numpy(eps),
                               body_vert=torch.from_numpy(bvert), **kw)
    blocked = tenkf.enkf_blocked(*targs, torch.from_numpy(eps),
                                 body_vert=torch.from_numpy(bvert),
                                 block_size=8, **kw)
    want = jenkf.enkf_serial(*jargs, jnp.asarray(eps),
                             body_vert=jnp.asarray(bvert), **kw)
    _same_update(serial, want)
    _same_update(blocked, want)


def test_apply_rows_gram_is_not_symmetric_and_matches_jax():
    """``apply_obs_block(apply_rows=z)``: the correction Gram is ``Z
    Ye^T``; the block meets the JAX package's, and ``apply_rows = ye`` is
    the square-root block."""
    rng = np.random.default_rng(11)
    bp, ye, z = (rng.normal(size=s) for s in ((30, 9), (6, 9), (6, 9)))
    bm, g, sq, w = (rng.normal(size=30), rng.normal(size=6),
                    rng.normal(size=6), rng.random((30, 6)))
    t = [torch.from_numpy(x) for x in (bm, bp, ye, g, sq, w)]
    j = [jnp.asarray(x) for x in (bm, bp, ye, g, sq, w)]
    got = tcore.apply_obs_block(*t, apply_rows=torch.from_numpy(z))
    want = jcore.apply_obs_block(*j, apply_rows=jnp.asarray(z))
    for a, b in zip(got, want):
        _close(a, b)
    plain = tcore.apply_obs_block(*t)
    same = tcore.apply_obs_block(*t, apply_rows=t[2])
    for a, b in zip(plain, same):
        _close(a, b.numpy())
    assert not np.allclose(z @ ye.T, (z @ ye.T).T)


@pytest.mark.parametrize("fn", ["enkf_serial", "enkf_blocked"])
def test_empty_batch_is_identity(fn):
    jargs, targs = _toy(nobs=0)
    eps = torch.zeros((0, 16), dtype=torch.float64)
    got = getattr(tenkf, fn)(*targs, eps)
    for a, b in zip(got[:4], targs[:4]):
        assert torch.equal(a, b)
    assert got[4].prior_mean.shape == (0,)
    tail, z = tenkf.enkf_tail_scan(targs[2], targs[3], targs[6], eps)
    assert tail.ye.shape == z.shape == (0, 16)


def test_apply_rows_refuses_hybrid():
    _, targs = _toy(nobs=4)
    tail = tcore.tail_scan(targs[2], targs[3], targs[6])
    with pytest.raises(ValueError, match="hybrid"):
        tcore.ensrf_blocked_body(
            targs[0], targs[1], targs[4], targs[5], tail, targs[6],
            hybrid=True, body_sigma=1.0, static_length=500.0,
            apply_rows=tail.ye)


def _pair(nmems=14, seed=8, nobs=9, radius=1500.0, **state_kw):
    jstate = make_demo_state(nmems=nmems, seed=seed, **state_kw)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=nobs, seed=seed + 1,
                                         radius=radius))
    s = jstate.structure
    data = np.asarray(jstate.data)
    tstate = interop.state_from_numpy(
        {name: data[i] for i, name in enumerate(s.var_names)},
        {"validtime": s.times64(), "lat": s.lat, "lon": s.lon},
        dtype="float64", device="cpu")
    tbatch = interop.obs_batch_from_numpy(
        {k: getattr(jbatch, k) for k in _BATCH_FIELDS})
    return jstate, jbatch, tstate, tbatch


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's EnKF draws the JAX package's table for its seed."""
    def draw(seed, errors, nmems, scale=True):
        return torch.from_numpy(_jeps(seed, errors.numpy(), nmems, scale))
    monkeypatch.setattr(tenkf, "draw_ob_perturbations", draw)


@pytest.mark.parametrize("method", ["blocked", "serial"])
def test_enkf_class_serial_vs_blocked_method(method, jax_draws):
    """Both methods of the class meet the JAX class (same draws), and so
    each other."""
    jstate, jbatch, tstate, tbatch = _pair()
    kw = dict(localization="GC", dtype="float64", method=method)
    jpost, jobs = jenkf.EnKF(jstate, jbatch, config=JConfig(**kw),
                             verbose=False, seed=21).update()
    tpost, tobs = EnKF(tstate, tbatch, config=FilterConfig(**kw),
                       verbose=False, seed=21).update()
    _close(interop.state_to_numpy(tpost), jpost.data)
    jobs.materialize_diagnostics()
    for name in ("prior_mean", "prior_var", "post_mean", "post_var"):
        _close(getattr(tobs, name), getattr(jobs, name))
    other = "serial" if method == "blocked" else "blocked"
    opost, _ = EnKF(tstate, tbatch, verbose=False, seed=21,
                    config=FilterConfig(localization="GC", dtype="float64",
                                        method=other)).update()
    _close(interop.state_to_numpy(opost), interop.state_to_numpy(tpost))


def test_enkf_class_end_to_end():
    """The port's own draws: the analysis pulls toward the obs, is fixed
    by the seed and changes with it."""
    _, _, tstate, tbatch = _pair(nmems=18, seed=2, nobs=8, radius=1200.0)
    cfg = FilterConfig(localization="GC", dtype="float64")
    post, batch = EnKF(tstate, tbatch, config=cfg, verbose=False,
                       seed=11).update()
    assert post.data.shape == tstate.data.shape
    ok = np.asarray(batch.assimilated, bool)
    assert ok.any()
    assert (np.abs(batch.values - batch.post_mean)[ok].mean()
            < np.abs(batch.values - batch.prior_mean)[ok].mean())
    post2, _ = EnKF(tstate, tbatch, config=cfg, verbose=False,
                    seed=11).update()
    assert torch.equal(post.data, post2.data)
    post3, _ = EnKF(tstate, tbatch, config=cfg, verbose=False,
                    seed=12).update()
    assert not torch.equal(post.data, post3.data)
    assert torch.isfinite(post3.data).all()


@pytest.mark.parametrize("kw", [
    dict(inflation=1.2, config=dict(rtps_alpha=0.5, outlier_threshold=1.5,
                                    obs_order="hilbert")),
    dict(config=dict(rtpp_alpha=0.4, fast_geometry=True, block_size=4,
                     unbiased_variance=True)),
])
def test_enkf_class_options_match_jax(kw, jax_draws):
    """Inflation, RTPS/RTPP, the outlier check, ``obs_order`` (diagnostics
    back in the caller's order), ``fast_geometry`` and ``unbiased`` through
    both classes."""
    jstate, jbatch, tstate, tbatch = _pair(nobs=13, seed=5, radius=900.0)
    ckw = dict(localization="GC", dtype="float64", **kw["config"])
    infl = kw.get("inflation")
    jpost, jobs = jenkf.EnKF(jstate, jbatch, inflation=infl, verbose=False,
                             config=JConfig(**ckw), seed=4).update()
    tpost, tobs = EnKF(tstate, tbatch, inflation=infl, verbose=False,
                       config=FilterConfig(**ckw), seed=4).update()
    _close(interop.state_to_numpy(tpost), jpost.data)
    jobs.materialize_diagnostics()
    for name in ("prior_mean", "post_mean", "post_var"):
        _close(getattr(tobs, name), getattr(jobs, name))
    np.testing.assert_array_equal(tobs.assimilated, jobs.assimilated)


def test_enkf_launches_no_body_kernel(monkeypatch):
    """The EnKF's blocked update takes its kernel route: B1e for every
    panel (the draws ``eps`` handed over), then B2e with
    ``fast_geometry`` or B4e at exact haversine, for the tail's
    out-of-panel apply and the body, each against the departure rows
    ``z``.  On CPU tensors every wrapper runs its plain version: no
    kernel is launched."""
    from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid, tail_solve

    calls = []

    def spy(mod, name, key):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls.append((name, k.get(key) is not None))
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    for mod, name, key in ((ensrf_fused, "fused_body", "apply_rows"),
                           (ensrf_grid, "grid_body", "apply_rows"),
                           (ensrf_grid, "blocked_body", "apply_rows"),
                           (ensrf_grid, "apply_obs_block", "apply_rows"),
                           (tail_solve, "tail_panel_solve", "eps")):
        spy(mod, name, key)
    _, _, tstate, tbatch = _pair(ntimes=2, nvars=2)
    routes = {}
    for label, extra in (("B2", dict(fast_geometry=True)), ("B4", dict())):
        calls.clear()
        EnKF(tstate, tbatch, verbose=False, config=FilterConfig(
            localization="GC", dtype="float32", tail_panel=4,
            **extra)).update()
        routes[label] = sorted(set(calls))
    # 9 obs in panels of 4: three B1e solves, each applied out of panel.
    assert routes["B2"] == [("fused_body", True), ("tail_panel_solve", True)]
    assert routes["B4"] == [("apply_obs_block", True),
                            ("blocked_body", True),
                            ("tail_panel_solve", True)]
    assert (tail_solve.launches == tail_solve.enkf_launches
            == ensrf_fused.launches == ensrf_fused.enkf_launches
            == ensrf_grid.b3_launches == ensrf_grid.b4_launches
            == ensrf_grid.b4e_launches == 0)


@pytest.mark.parametrize("kw,err,match", [
    (dict(config=FilterConfig(dtype="float64", hybrid_alpha=0.5,
                              static_b_sigma=1.0, static_b_length=500.0)),
     ValueError, "EnSRF solver only"),
    (dict(config=FilterConfig(dtype="float64", matmul_precision="high")),
     None, None),
])
def test_enkf_refusals(kw, err, match):
    """Hybrid covariance is refused; ``matmul_precision`` below fp32,
    refused until the product modes were ported, runs (``err`` None): the
    EnKF has no body kernel, so its posterior is the default config's bit
    for bit."""
    _, _, tstate, tbatch = _pair()
    if err is not None:
        with pytest.raises(err, match=match):
            EnKF(tstate, tbatch, verbose=False, **kw).update()
        return
    post, _ = EnKF(tstate, tbatch, verbose=False, seed=3, **kw).update()
    ref, _ = EnKF(tstate, tbatch, verbose=False, seed=3,
                  config=FilterConfig(dtype="float64")).update()
    assert torch.equal(post.data, ref.data)


def test_enkf_cycles_lorenz96_beats_free_run():
    """The EnKF cycling a Lorenz-96 twin through the public API (the JAX
    package's ``CyclingHarness`` case, driven by hand): analyses beat
    their backgrounds and lock on, with no divergence."""
    n, m = 40, 20
    truth, ens = lorenz96.spinup_ensemble(nvars=n, nmems=m, seed=2,
                                          device="cpu", dtype=torch.float64)
    lats, lons = lorenz96.fake_latlon(n)
    rows = np.arange(0, n, 2)
    rng = np.random.default_rng(5)
    times = np.array([np.datetime64("2026-08-01T00")])
    coords = {"validtime": times, "lat": lats[None, :], "lon": lons[None, :]}
    cfg = FilterConfig(localization="GC", dtype="float64")
    rmse, bg = [], []
    for cycle in range(25):
        truth = lorenz96.integrate(truth, nsteps=4)
        ens = lorenz96.integrate(ens, nsteps=4)
        mean = ens.mean(0)
        bg.append(float(torch.sqrt(torch.mean((mean - truth) ** 2))))
        state = EnsembleState.from_vardict(
            {"L96": ens.T.reshape(1, 1, n, m)}, coords, dtype="float64",
            device="cpu")
        obs = interop.obs_batch_from_numpy(dict(
            values=truth.numpy()[rows] + rng.normal(0, 1, rows.size),
            errors=np.ones(rows.size), lats=lats[rows], lons=lons[rows],
            times_s=np.full(rows.size, state.structure.times_s[0]),
            obtypes=["L96"] * rows.size,
            localize_radius=np.full(rows.size, 4000.0)))
        post, _ = EnKF(state, obs, inflation=1.05, config=cfg, verbose=False,
                       seed=3 + cycle).update()
        ens = post.data.reshape(n, m).T.clone()
        rmse.append(float(torch.sqrt(torch.mean((ens.mean(0) - truth) ** 2))))
    rmse, bg = np.asarray(rmse), np.asarray(bg)
    assert np.isfinite(rmse).all()
    assert rmse[5:].mean() < bg[5:].mean()
    assert rmse[-8:].mean() < 1.0


@pytest.mark.parametrize("method", ["blocked", "serial"])
def test_enkf_sharded_matches_single_device(method, jax_draws):
    """The EnKF on a mesh (the body split, the tail and the perturbation
    table replicated): the port's ``[cpu] * 8`` against the JAX package's
    8 CPU devices and the port's single device, same seed, same draws."""
    from test_torch_sharded import assert_mesh_agrees, mesh_runs

    jstate = make_demo_state(ny=8, nx=8, nmems=12, seed=6)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=9, seed=7,
                                         radius=1100.0))
    assert_mesh_agrees(mesh_runs(
        jenkf.EnKF, EnKF, jstate, jbatch,
        dict(localization="GC", dtype="float64", method=method), seed=4))
