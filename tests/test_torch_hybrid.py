"""Hybrid ensemble-static covariance in the port (``hybrid_alpha < 1``):
the serial, plain blocked and B2h routes against the JAX package on the
same NumPy inputs, in float64 on the CPU (where B2h's plain version runs,
held against the JAX B2 kernel's hybrid branch in interpret mode), and on
a mesh of ``[cpu] * 8`` against the JAX package's 8 CPU devices.  Mirrors
``tests/test_hybrid.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import ensrf_core as jcore
from efa_xray_tpu.assimilation.ensrf import EnSRF as JEnSRF
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.observation.localization import gaspari_cohn_np, haversine
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu.observation.thinning import _hilbert3d_np
from efa_xray_tpu.ops import ensrf_pallas_fused as jfused
from efa_xray_tpu_torch import EnSRF, FilterConfig, interop
from efa_xray_tpu_torch.assimilation import ensrf_core as tcore
from efa_xray_tpu_torch.observation.localization import latlon_to_unit
from efa_xray_tpu_torch.ops import ensrf_fused, tail_solve

TOL = 1e-9  # float64, same algebra in another summation order
_BATCH_FIELDS = ("values", "errors", "lats", "lons", "times_s", "obtypes",
                 "localize_radius", "assimilate_flags", "verts",
                 "descriptions", "vert_radius")


def _toy(nstate=50, nmems=12, nobs=4, seed=0):
    """``tests/test_hybrid.py``'s toy problem as NumPy arrays:
    ``(arrays, obs, rows)`` with ``arrays = (bm, bp, tm, tp, lat, lon)``."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-60, 60, nstate)
    lon = rng.uniform(0, 360, nstate)
    prior = rng.normal(280, 3, (nstate, nmems))
    rows = rng.integers(0, nstate, nobs)
    ye = prior[rows]
    obs = dict(values=ye.mean(1) + rng.normal(0, 1, nobs),
               errors=np.ones(nobs), lats=lat[rows], lons=lon[rows],
               radii=np.full(nobs, 3000.0), assim=np.ones(nobs, bool))
    arrays = (prior.mean(1), prior - prior.mean(1, keepdims=True),
              ye.mean(1), ye - ye.mean(1, keepdims=True), lat, lon)
    return arrays, obs, rows


def _sigmas(arrays, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.0, 3.0, arrays[0].shape[0]),
            rng.uniform(1.0, 3.0, arrays[2].shape[0]))


def _jax_obs(obs):
    return jcore.ObsArrays(**{k: None if v is None else jnp.asarray(v)
                              for k, v in obs.items()})


def _run(pkg, fn, arrays, obs, body_sigma=None, tail_sigma=None, **kw):
    """``ensrf_serial``/``ensrf_blocked`` of one package on NumPy inputs;
    returns ``(bm, bp, tm, tp)`` as NumPy arrays."""
    if pkg == "jax":
        sig = {k: None if v is None else jnp.asarray(v)
               for k, v in (("body_sigma", body_sigma),
                            ("tail_sigma", tail_sigma))}
        out = getattr(jcore, fn)(*map(jnp.asarray, arrays), _jax_obs(obs),
                                 **sig, **kw)
    else:
        sig = {k: None if v is None else torch.tensor(v)
               for k, v in (("body_sigma", body_sigma),
                            ("tail_sigma", tail_sigma))}
        out = getattr(tcore, fn)(
            *map(torch.tensor, arrays),
            interop.obs_arrays_from_numpy(**obs, device="cpu"), **sig, **kw)
    return [np.asarray(x) for x in out[:4]]


def _assert_close(got, want, tol=TOL, what=""):
    names = ("body_mean", "body_perts", "tail_mean", "tail_perts")
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                   err_msg=f"{name} {what}")


def test_alpha_one_is_pure_ensemble():
    arrays, obs, _ = _toy()
    ref = _run("torch", "ensrf_serial", arrays, obs, localize=True)
    hyb = _run("torch", "ensrf_serial", arrays, obs, localize=True,
               hybrid_alpha=1.0, body_sigma=np.full(50, 2.0),
               tail_sigma=np.full(4, 2.0), static_length=1000.0)
    for a, b in zip(ref, hyb):
        np.testing.assert_array_equal(a, b)


def test_alpha_zero_is_optimal_interpolation():
    """One ob, alpha = 0: row by row the scalar OI solution
    ``xb + sig sig GC(d, L) / (sig^2 + R) innov``; beyond the support the
    state is untouched."""
    arrays, obs, _ = _toy(nobs=1, seed=3)
    sigma, length, r = 2.5, 1200.0, 1.0
    bm, *_ = _run("torch", "ensrf_serial", arrays, obs, localize=True,
                  hybrid_alpha=0.0, body_sigma=np.full(50, sigma),
                  tail_sigma=np.full(1, sigma), static_length=length)
    innov = obs["values"][0] - arrays[2][0]
    d = np.asarray(haversine((arrays[4], arrays[5]),
                             (obs["lats"][0], obs["lons"][0])))
    expect = arrays[0] + sigma * sigma * gaspari_cohn_np(d, length) / (
        sigma ** 2 + r) * innov
    np.testing.assert_allclose(bm, expect, rtol=TOL, atol=TOL)
    far = d > 2 * length
    assert far.any()
    np.testing.assert_array_equal(bm[far], arrays[0][far])


@pytest.mark.parametrize("alpha", [0.0, 0.5, 0.9])
@pytest.mark.parametrize("localize", [True, False])
def test_hybrid_blocked_equals_serial_and_jax(alpha, localize):
    """The plain blocked update over the block/panel grid of
    ``tests/test_hybrid.py`` equals the serial filter, and both equal the
    JAX package's."""
    arrays, obs, _ = _toy(nstate=120, nobs=23, seed=7)
    bsig, tsig = _sigmas(arrays, 11)
    kw = dict(hybrid_alpha=alpha, body_sigma=bsig, tail_sigma=tsig,
              static_length=1200.0, localize=localize)
    ser = _run("torch", "ensrf_serial", arrays, obs, **kw)
    _assert_close(ser, _run("jax", "ensrf_serial", arrays, obs, **kw),
                  what="serial vs JAX")
    for block_size, tail_panel in ((8, None), (16, 5), (23, None), (128, 7)):
        blk = _run("torch", "ensrf_blocked", arrays, obs,
                   block_size=block_size, tail_panel=tail_panel, **kw)
        what = f"(block={block_size}, panel={tail_panel})"
        _assert_close(blk, ser, what=what + " vs serial")
        _assert_close(blk, _run("jax", "ensrf_blocked", arrays, obs,
                                block_size=block_size, tail_panel=tail_panel,
                                **kw), what=what + " vs JAX")


def test_hybrid_skipped_obs_are_ignored():
    """QC-masked obs add neither ensemble nor static increments, on the
    serial and blocked paths alike."""
    arrays, obs, _ = _toy(nstate=80, nobs=12, seed=9)
    obs["assim"] = np.random.default_rng(1).random(12) > 0.4
    assert not obs["assim"].all()
    kw = dict(localize=True, hybrid_alpha=0.4, body_sigma=np.full(80, 2.0),
              tail_sigma=np.full(12, 2.0), static_length=900.0)
    ser = _run("torch", "ensrf_serial", arrays, obs, **kw)
    blk = _run("torch", "ensrf_blocked", arrays, obs, block_size=5, **kw)
    _assert_close(blk, ser)
    _assert_close(blk, _run("jax", "ensrf_blocked", arrays, obs,
                            block_size=5, **kw), what="vs JAX")
    # Dropping the skipped obs altogether gives the same state.
    keep = {k: v[obs["assim"]] for k, v in obs.items()}
    arr2 = arrays[:2] + (arrays[2][obs["assim"]], arrays[3][obs["assim"]]) \
        + arrays[4:]
    kw2 = dict(kw, tail_sigma=np.full(int(obs["assim"].sum()), 2.0))
    only = _run("torch", "ensrf_serial", arr2, keep, **kw2)
    _assert_close(only[:2], ser[:2], what="skipped obs dropped")


@pytest.mark.parametrize("panel", [4, 7, 40])
@pytest.mark.parametrize("localize", [True, False])
def test_tail_scan_blocked_hybrid_matches_jax(panel, localize):
    arrays, obs, _ = _toy(nstate=60, nobs=23, seed=13)
    _, tsig = _sigmas(arrays, 14)
    tm, tp = arrays[2], arrays[3]
    kw = dict(localize=localize, fast_geometry=True, panel=panel,
              hybrid_alpha=0.6, static_length=1500.0)
    j = jcore.tail_scan_blocked(jnp.asarray(tm), jnp.asarray(tp),
                                _jax_obs(obs), tail_sigma=jnp.asarray(tsig),
                                **kw)
    t = tcore.tail_scan_blocked(
        torch.tensor(tm), torch.tensor(tp),
        interop.obs_arrays_from_numpy(**obs, device="cpu"),
        tail_sigma=torch.tensor(tsig), **kw)
    for name in ("ye", "gain_coef", "sqrt_coef", "tail_mean", "tail_perts",
                 "static_gain", "static_sqrt"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=0,
                                   atol=TOL, err_msg=name)
    for a, b in zip(t.diags, j.diags):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)


def test_kernel_tail_refuses_hybrid(monkeypatch):
    """The kernel tail once refused hybrid mode; B1h now solves its panels
    (the plain hybrid apply stays): equal to the plain tail at 1e-10, with
    B1h launched once per panel."""
    arrays, obs, _ = _toy(nobs=6)
    calls = []
    real = tail_solve.tail_panel_solve
    monkeypatch.setattr(tail_solve, "tail_panel_solve",
                        lambda *a, **k: (calls.append(k.get("alpha")),
                                         real(*a, **k))[1])
    run = lambda kernels: tcore.tail_scan_blocked(
        torch.tensor(arrays[2]), torch.tensor(arrays[3]),
        interop.obs_arrays_from_numpy(**obs, device="cpu"),
        fast_geometry=True, panel=4, kernels=kernels, hybrid_alpha=0.5,
        tail_sigma=torch.linspace(1.0, 2.0, 6), static_length=800.0)
    got, want = run(True), run(False)
    assert calls == [0.5, 0.5]
    for name in ("ye", "gain_coef", "sqrt_coef", "tail_mean", "tail_perts",
                 "static_gain", "static_sqrt"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name).numpy(), rtol=1e-10,
                                   atol=1e-10, err_msg=name)
    for a, b in zip(got.diags, want.diags):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10)


# ---------------------------------------------------------------------------
# B2h: the plain version against the JAX B2 kernel's hybrid branch.
# ---------------------------------------------------------------------------


def _scattered(nstate=301, nmems=10, nobs=21, seed=7, vertical=False):
    """Hilbert-ordered scattered rows and obs, mixed radii (some inf),
    some obs not assimilated, a static std per row (as in
    ``tests/test_torch_ensrf_fused.py``)."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-88, 88, nstate)
    lon = rng.uniform(0, 360, nstate)
    ro = np.argsort(_hilbert3d_np(lat, lon), kind="stable")
    lat, lon = lat[ro], lon[ro]
    prior = rng.normal(280, 3, (nstate, nmems))
    rows = np.sort(rng.integers(0, nstate, nobs))
    ye = prior[rows] + rng.normal(0, 0.5, (nobs, nmems))
    radii = np.where(rng.random(nobs) < 0.1, np.inf,
                     rng.uniform(300, 900, nobs))
    obs = dict(
        values=ye.mean(1) + rng.normal(0, 1, nobs),
        errors=rng.uniform(0.5, 2.0, nobs),
        lats=lat[rows], lons=lon[rows], radii=radii,
        assim=rng.random(nobs) > 0.15,
        verts=rng.uniform(100, 1000, nobs) if vertical else None,
        vert_radii=(rng.choice([300.0, np.inf], nobs) if vertical
                    else None))
    body_vert = rng.uniform(100, 1000, nstate) if vertical else None
    bsig = rng.uniform(1.0, 3.0, nstate)
    return prior, ye, lat, lon, obs, body_vert, bsig, bsig[rows]


def _hybrid_tail(ye, obs, localize, tsig, static_length, alpha=0.5):
    """The JAX hybrid tail, and the same solution as the port's object."""
    tm = ye.mean(1)
    tp = ye - tm[:, None]
    jt = jcore.tail_scan(jnp.asarray(tm), jnp.asarray(tp), _jax_obs(obs),
                         localize=localize, fast_geometry=True,
                         hybrid_alpha=alpha, tail_sigma=jnp.asarray(tsig),
                         static_length=static_length)
    fields = {k: np.asarray(v) for k, v in jt._asdict().items()
              if k != "diags" and v is not None}
    fields.update({k: np.asarray(v) for k, v in jt.diags._asdict().items()})
    return jt, interop.tail_solution_from_numpy(**fields, device="cpu")


@pytest.mark.parametrize("localize,cull,max_radius,vertical,nstate", [
    (True, True, 2000.0, False, 301),
    (True, True, 6000.0, False, 301),
    (True, False, 2000.0, False, 301),
    (True, False, 6000.0, False, 301),
    (True, True, 2000.0, True, 301),
    (True, True, 6000.0, True, 301),
    (True, False, 6000.0, True, 301),
    (False, False, None, False, 301),
    (True, True, 2000.0, False, 128),
])
def test_b2h_plain_matches_pallas_interpret(localize, cull, max_radius,
                                            vertical, nstate):
    """Both angle forms (series at <= 5000 km, arccos above), culling on
    and off, vertical localization, unlocalized, a ragged last tile (301
    rows) and whole tiles (128 rows).  The static length (1200 km) exceeds
    every finite radius, so the widened cull is live."""
    prior, ye, lat, lon, obs, body_vert, bsig, tsig = _scattered(
        nstate=nstate, vertical=vertical)
    bm = prior.mean(1)
    bp = prior - bm[:, None]
    slen = 1200.0
    jt, tt = _hybrid_tail(ye, obs, localize, tsig, slen)
    want = jfused.ensrf_blocked_body_pallas_fused(
        jnp.asarray(bm), jnp.asarray(bp), jnp.asarray(lat), jnp.asarray(lon),
        jt, _jax_obs(obs),
        body_vert=None if body_vert is None else jnp.asarray(body_vert),
        localize=localize, block_size=8, tile=64, interpret=True,
        vertical=vertical, cull=cull, max_radius_km=max_radius, hybrid=True,
        body_sigma=jnp.asarray(bsig), static_length=slen)
    got = ensrf_fused.fused_body(
        torch.tensor(bm), torch.tensor(bp), torch.tensor(lat),
        torch.tensor(lon), tt,
        interop.obs_arrays_from_numpy(**obs, device="cpu"),
        body_vert=None if body_vert is None else torch.tensor(body_vert),
        localize=localize, block_size=8, vertical=vertical, cull=cull,
        max_radius_km=max_radius, hybrid=True, body_sigma=torch.tensor(bsig),
        static_length=slen)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL,
                                   atol=TOL)
    assert np.abs(got[0].numpy() - bm).max() > 0.1  # the update is not void
    # CPU tensors never reach either instantiation of the kernel.
    assert ensrf_fused.launches == 0 and ensrf_fused.hybrid_launches == 0


def test_b2h_widened_cull_is_exact_and_needed():
    """With ``static_length`` (1500 km) above every finite radius (300-900
    km), the cull at ``max(radius, static_length)`` still skips pairs and
    gives the unculled result; culling at the radii alone would drop live
    static columns and change it."""
    prior, ye, lat, lon, obs, _, bsig, tsig = _scattered(nstate=3000,
                                                         nobs=40, seed=5)
    bm = prior.mean(1)
    bp = prior - bm[:, None]
    slen = 1500.0
    _, tt = _hybrid_tail(ye, obs, True, tsig, slen)
    tobs = interop.obs_arrays_from_numpy(**obs, device="cpu")
    args = (torch.tensor(bm), torch.tensor(bp), torch.tensor(lat),
            torch.tensor(lon), tt, tobs)
    kw = dict(block_size=8, max_radius_km=2000.0, hybrid=True,
              body_sigma=torch.tensor(bsig), static_length=slen)
    ops = ensrf_fused.prepare(torch.tensor(bp), torch.tensor(lat),
                              torch.tensor(lon), tt, tobs, block_size=8,
                              cull=True, max_radius_km=2000.0, hybrid=True,
                              body_sigma=torch.tensor(bsig),
                              static_length=slen)
    npanels = 8 // ensrf_fused.PANEL
    alive = ((ops["bits"][..., None] >> torch.arange(npanels)) & 1).float()
    assert 0.0 < float(alive.mean()) < 1.0  # the cull skips something
    culled = ensrf_fused.fused_body(*args, cull=True, **kw)
    whole = ensrf_fused.fused_body(*args, cull=False, **kw)
    for a, b in zip(culled, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)
    # The radii alone: fewer alive pairs, a different (wrong) posterior.
    narrow = ensrf_fused.cull_bits(
        latlon_to_unit(torch.tensor(lat), torch.tensor(lon)),
        latlon_to_unit(tobs.lats, tobs.lons), tobs.radii,
        tobs.assim, ops["tile"], ops["y_b"].shape[0], 8)
    wrong = ensrf_fused.fused_apply_plain(
        torch.tensor(bm), torch.tensor(bp), ops["geom"], ops["y_b"],
        ops["ggt_b"], ops["tab_b"], narrow, ops["tile"], True, False,
        ops["series"], hybrid=True)
    assert np.abs(wrong[0].numpy() - whole[0].numpy()).max() > 1e-3


def test_b2h_angle_form_for_long_static_length(monkeypatch):
    """A static length of 9000 km under 2000 km radii: the wrapper must
    take the arccos form (within ~2e-8 rad), because the static column's
    support reaches 18000 km (162 degrees), far outside the range the
    series form was fitted on (its distance error is 89 km at 135 degrees
    and 2342 km at 180).  B2h's plain version then matches the serial
    exact-haversine hybrid within 1e-6 x the increment RMS (5.3e-8 x on
    this input); forced to the series form, as the JAX package's wrapper
    would pick it from the radii alone, it misses by 1.3e-3 x."""
    prior, ye, lat, lon, obs, _, bsig, tsig = _scattered(nstate=400,
                                                         nobs=24, seed=19)
    obs["radii"] = np.full(24, 2000.0)
    bm = prior.mean(1)
    bp = prior - bm[:, None]
    tm = ye.mean(1)
    tp = ye - tm[:, None]
    slen, alpha = 9000.0, 0.5
    tobs = interop.obs_arrays_from_numpy(**obs, device="cpu")
    t = torch.tensor
    hkw = dict(hybrid_alpha=alpha, static_length=slen)
    ser, *_ = tcore.ensrf_serial(
        t(bm), t(bp), t(tm), t(tp), t(lat), t(lon), tobs, localize=True,
        fast_geometry=True, body_sigma=t(bsig), tail_sigma=t(tsig), **hkw)
    tail = tcore.tail_scan(t(tm), t(tp), tobs, localize=True,
                           fast_geometry=True, tail_sigma=t(tsig), **hkw)
    incr_rms = float(torch.sqrt(torch.mean((ser - t(bm)) ** 2)))

    def body_err():
        got, _ = ensrf_fused.fused_body(
            t(bm), t(bp), t(lat), t(lon), tail, tobs, block_size=8,
            max_radius_km=2000.0, hybrid=True, body_sigma=t(bsig),
            static_length=slen)
        return float((got - ser).abs().max())

    assert not ensrf_fused.series_form(2000.0, slen)
    assert ensrf_fused.series_form(2000.0, 5000.0)
    assert body_err() <= 1e-6 * incr_rms
    monkeypatch.setattr(ensrf_fused, "series_form", lambda *a: True)
    assert body_err() > 1e-4 * incr_rms


# ---------------------------------------------------------------------------
# The public API.
# ---------------------------------------------------------------------------


def _pair(ntimes=1, nvars=1, nobs=9, seed=5):
    """The same state and obs, as JAX objects and as port objects."""
    jstate = make_demo_state(nvars=nvars, ntimes=ntimes, ny=9, nx=11,
                             nmems=12, seed=seed)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=nobs, seed=seed + 1,
                                         radius=600.0, all_assim=False))
    s = jstate.structure
    data = np.asarray(jstate.data)
    tstate = interop.state_from_numpy(
        {name: data[i] for i, name in enumerate(s.var_names)},
        {"validtime": s.times64(), "lat": s.lat, "lon": s.lon},
        dtype="float64", device="cpu")
    tbatch = interop.obs_batch_from_numpy(
        {k: getattr(jbatch, k) for k in _BATCH_FIELDS})
    return jstate, jbatch, tstate, tbatch


def _compare_updates(jcfg, tcfg, route, **pair_kw):
    jstate, jbatch, tstate, tbatch = _pair(**pair_kw)
    tfilt = EnSRF(tstate, tbatch, config=tcfg, verbose=False)
    assert tfilt._route(tstate.structure.nstate) == route
    jpost, jobs = JEnSRF(jstate, jbatch, config=jcfg, verbose=False).update()
    tpost, tobs = tfilt.update()
    np.testing.assert_allclose(interop.state_to_numpy(tpost),
                               np.asarray(jpost.data), rtol=TOL, atol=TOL)
    jobs.materialize_diagnostics()
    for name in ("prior_mean", "prior_var", "post_mean", "post_var"):
        a, b = getattr(tobs, name), np.asarray(getattr(jobs, name))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)],
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(tobs.assimilated, jobs.assimilated)
    assert not np.allclose(interop.state_to_numpy(tpost),
                           interop.state_to_numpy(tstate))


@pytest.mark.parametrize("ntimes,nvars,per_row_sigma", [
    (1, 1, False),  # flat, vt = 1
    (2, 2, True),   # gridded, vt = 4: B2h with per-row weights, not B3
])
def test_update_b2h_route_matches_jax_pallas(ntimes, nvars, per_row_sigma):
    """Hybrid with ``fast_geometry``: the port's B2h route (plain version
    on the CPU, plain panel tail) against the JAX package's fused kernel in
    interpret mode."""
    nstate = nvars * ntimes * 9 * 11
    sigma = (np.random.default_rng(3).uniform(1.0, 2.0, nstate)
             if per_row_sigma else 1.5)
    kw = dict(localization="GC", dtype="float64", fast_geometry=True,
              tail_panel=4, block_size=3, hybrid_alpha=0.5,
              static_b_sigma=sigma, static_b_length=800.0)
    _compare_updates(JConfig(use_pallas=True, **kw), FilterConfig(**kw),
                     "B2h", ntimes=ntimes, nvars=nvars)
    assert ensrf_fused.launches == 0 and ensrf_fused.hybrid_launches == 0
    assert tail_solve.launches == 0


def test_update_exact_haversine_hybrid_routes_plain_and_matches_jax():
    kw = dict(localization="GC", dtype="float64", block_size=4,
              hybrid_alpha=0.3, static_b_sigma=2.0, static_b_length=700.0)
    _compare_updates(JConfig(use_pallas=False, **kw), FilterConfig(**kw),
                     "plain", ntimes=2)


def test_update_serial_hybrid_matches_jax():
    kw = dict(localization="GC", dtype="float64", method="serial",
              hybrid_alpha=0.5, static_b_sigma=1.5, static_b_length=800.0)
    _compare_updates(JConfig(**kw), FilterConfig(**kw), "serial")


def test_hybrid_with_variable_localization_raises_as_in_jax():
    kw = dict(localization="GC", hybrid_alpha=0.5, static_b_sigma=1.0,
              static_b_length=800.0, variable_localization={"T2m:T2m": 1.0})
    with pytest.raises(ValueError, match="hybrid"):
        JConfig(**kw)
    with pytest.raises(ValueError, match="hybrid"):
        FilterConfig(**kw)
    arrays, obs, _ = _toy(nobs=3)
    with pytest.raises(ValueError, match="hybrid"):
        _run("torch", "ensrf_serial", arrays, obs, hybrid_alpha=0.5,
             body_sigma=np.ones(50), tail_sigma=np.ones(3),
             static_length=800.0, varloc=torch.ones(1, 1),
             row_var=torch.zeros(50, dtype=torch.long),
             ob_var=torch.zeros(3, dtype=torch.long))


# ---------------------------------------------------------------------------
# Hybrid on a mesh (``body_sigma`` split with the rows, the ob-side inputs
# replicated): float64, 1e-10
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["serial", "blocked"])
def test_hybrid_sharded_equals_single_device(method):
    """``ensrf_update_sharded`` of both packages on 101 rows over 8
    shards, against each other and the single-device function."""
    from efa_xray_tpu.parallel import make_mesh as jmake_mesh
    from efa_xray_tpu.parallel.sharded import ensrf_update_sharded as jshard
    from efa_xray_tpu_torch.parallel import make_mesh, sharded

    arrays, obs, _ = _toy(nstate=101, nobs=9, seed=13)
    bsig, tsig = _sigmas(arrays, 17)
    kw = dict(hybrid_alpha=0.6, static_length=1500.0, localize=True)
    jout = jshard(*map(jnp.asarray, arrays), _jax_obs(obs),
                  mesh=jmake_mesh(), method=method, block_size=4,
                  body_sigma=jnp.asarray(bsig), tail_sigma=jnp.asarray(tsig),
                  **kw)
    tout = sharded.ensrf_update_sharded(
        *map(torch.tensor, arrays),
        interop.obs_arrays_from_numpy(**obs, device="cpu"),
        mesh=make_mesh(["cpu"] * 8), method=method, block_size=4,
        body_sigma=torch.tensor(bsig), tail_sigma=torch.tensor(tsig), **kw)
    fn = "ensrf_serial" if method == "serial" else "ensrf_blocked"
    single = _run("torch", fn, arrays, obs, body_sigma=bsig,
                  tail_sigma=tsig, **kw,
                  **({} if method == "serial" else dict(block_size=4)))
    got = [np.asarray(x) for x in tout[:4]]
    _assert_close(got, [np.asarray(x) for x in jout[:4]], 1e-10, "jax mesh")
    _assert_close(got, single, 1e-10, "single device")


def test_hybrid_via_ensrf_api_blocked_and_mesh():
    """The public API: the mesh posterior equals the JAX mesh one and the
    port's blocked and serial ones (plain route: exact haversine)."""
    from test_torch_sharded import (
        assert_mesh_agrees,
        close,
        mesh_runs,
        to_port,
    )

    jstate = make_demo_state(nmems=14, seed=2)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=6, seed=3,
                                         radius=1500.0))
    kw = dict(localization="GC", dtype="float64", hybrid_alpha=0.5,
              static_b_sigma=1.5, static_b_length=800.0)
    runs = mesh_runs(JEnSRF, EnSRF, jstate, jbatch, kw)
    assert_mesh_agrees(runs)
    serial, _ = EnSRF(*to_port(jstate, jbatch), verbose=False,
                      config=FilterConfig(**kw, method="serial")).update()
    close(runs[2][0], serial.data.numpy(), 1e-9)
