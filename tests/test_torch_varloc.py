"""Cross-variable localization in the port, and the grid-mode routing of
``EnSRF.update()``: the port against the JAX package (float64, CPU, the
kernels' plain versions and the Pallas kernels in interpret mode) and
against the NumPy oracle; and each solver's cross-variable localization on
a mesh of ``[cpu] * 8`` against the JAX package's 8 CPU devices."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle_numpy as oracle
from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import ensrf_core as jcore
from efa_xray_tpu.assimilation.ensrf import EnSRF as JEnSRF
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.observation.observation import Observation
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu.state.ensemble import EnsembleState as JState
from efa_xray_tpu.state.structure import StateStructure as JStructure
from efa_xray_tpu_torch import EnSRF, EnsembleState, FilterConfig, interop
from efa_xray_tpu_torch.assimilation import ensrf_core as tcore
from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid, tail_solve
from efa_xray_tpu_torch.state.structure import StateStructure

TOL = 1e-9
_BATCH_FIELDS = ("values", "errors", "lats", "lons", "times_s", "obtypes",
                 "localize_radius", "assimilate_flags", "verts",
                 "descriptions", "vert_radius")


# ---------------------------------------------------------------------------
# ensrf_core with varloc
# ---------------------------------------------------------------------------


def _core_setup(nv=3, nt=2, ng=30, nm=11, no=14, seed=5, vertical=False):
    """A gridded state of nv variables x nt times over ng scattered points,
    obs of random variables at grid points (as
    ``tests/test_varloc.py::test_parity_vs_numpy_oracle_with_factors``)."""
    rng = np.random.default_rng(seed)
    ns = nv * nt * ng
    prior = 280 + 5 * rng.standard_normal((ns, nm))
    glat = rng.uniform(-60, 60, ng)
    glon = rng.uniform(0, 360, ng)
    row_lat = np.tile(glat, nv * nt)
    row_lon = np.tile(glon, nv * nt)
    row_var = np.repeat(np.arange(nv), nt * ng)
    rows = rng.integers(0, ng, no)
    ovar = rng.integers(0, nv, no)
    ye = prior[ovar * nt * ng + rows]
    obs = dict(values=ye.mean(1) + rng.normal(0, 1, no),
               errors=rng.uniform(0.5, 2.0, no), lats=glat[rows],
               lons=glon[rows], radii=np.full(no, 2500.0),
               assim=rng.random(no) < 0.85)
    body_vert = None
    if vertical:
        body_vert = np.repeat(rng.uniform(200, 1000, nv), nt * ng)
        obs["verts"] = rng.uniform(200, 1000, no)
        obs["vert_radii"] = rng.choice([400.0, np.inf], no)
    fac = rng.uniform(0.0, 1.0, (nv + 1, nv))
    return prior, ye, row_lat, row_lon, row_var, ovar, obs, body_vert, fac


def _split(prior, ye):
    bm, tm = prior.mean(1), ye.mean(1)
    return bm, prior - bm[:, None], tm, ye - tm[:, None]


def _core_run(pkg, fn, setup, **kw):
    prior, ye, lat, lon, rvar, ovar, obs, bv, fac = setup
    arrays = _split(prior, ye) + (lat, lon)
    if pkg == "jax":
        a = jnp.asarray
        o = jcore.ObsArrays(**{k: a(v) for k, v in obs.items()})
        out = getattr(jcore, fn)(
            *map(a, arrays), o, body_vert=None if bv is None else a(bv),
            varloc=a(fac), row_var=a(rvar.astype(np.int32)),
            ob_var=a(ovar.astype(np.int32)), **kw)
    else:
        t = torch.tensor
        out = getattr(tcore, fn)(
            *map(t, arrays),
            interop.obs_arrays_from_numpy(**obs, device="cpu"),
            body_vert=None if bv is None else t(bv), varloc=t(fac),
            row_var=t(rvar), ob_var=t(ovar), **kw)
    bm, bp, tm, tp, diags = out
    return [np.asarray(x) for x in (bm, bp, tm, tp, *diags)]


def _assert_same(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g[~np.isnan(g)], w[~np.isnan(w)],
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("kw", [
    dict(localize=True),
    dict(localize=True, fast_geometry=True, vertical=True),
    dict(localize=False),
])
@pytest.mark.parametrize("fn", ["ensrf_serial", "ensrf_blocked"])
def test_core_varloc_matches_jax(fn, kw):
    setup = _core_setup(vertical=kw.get("vertical", False))
    extra = dict(block_size=4) if fn == "ensrf_blocked" else {}
    _assert_same(_core_run("torch", fn, setup, **kw, **extra),
                 _core_run("jax", fn, setup, **kw, **extra))


def test_core_varloc_matches_numpy_oracle():
    setup = _core_setup(nt=1)
    prior, ye, lat, lon, rvar, ovar, obs, _, fac = setup
    want, wd = oracle.serial_ensrf(
        prior, ye, obs["values"], obs["errors"], obs["lats"], obs["lons"],
        obs["radii"], lat, lon, obs["assim"], localize=True, varloc=fac,
        row_var=rvar, ob_var=ovar)
    for fn, extra in (("ensrf_serial", {}), ("ensrf_blocked",
                                             dict(block_size=5))):
        bm, bp, tm, tp, pm, pv, om, ov, asm = _core_run("torch", fn, setup,
                                                        **extra)
        np.testing.assert_allclose(bm[:, None] + bp, want, rtol=TOL, atol=TOL)
        _assert_same([pm, pv, om, ov], [wd["prior_mean"], wd["prior_var"],
                                        wd["post_mean"], wd["post_var"]],
                     1e-8)


@pytest.mark.parametrize("panel", [None, 4, 32])
def test_tail_varloc_matches_jax(panel):
    """``tail_scan`` (panel None) and the plain branch of
    ``tail_scan_blocked`` (4-ob panels; one panel covering the batch)."""
    prior, ye, lat, lon, rvar, ovar, obs, bv, fac = _core_setup(vertical=True)
    tm, tp = ye.mean(1), ye - ye.mean(1, keepdims=True)
    kw = dict(localize=True, vertical=True)
    jkw = dict(kw, **({} if panel is None else dict(panel=panel)))
    jfn = jcore.tail_scan if panel is None else jcore.tail_scan_blocked
    tfn = tcore.tail_scan if panel is None else tcore.tail_scan_blocked
    j = jfn(jnp.asarray(tm), jnp.asarray(tp),
            jcore.ObsArrays(**{k: jnp.asarray(v) for k, v in obs.items()}),
            varloc=jnp.asarray(fac), ob_var=jnp.asarray(ovar.astype(np.int32)),
            **jkw)
    t = tfn(torch.tensor(tm), torch.tensor(tp),
            interop.obs_arrays_from_numpy(**obs, device="cpu"),
            varloc=torch.tensor(fac),
            ob_var=torch.tensor(ovar), **jkw)
    names = ("ye", "gain_coef", "sqrt_coef", "tail_mean", "tail_perts")
    _assert_same([getattr(t, n).numpy() for n in names]
                 + [d.numpy() for d in t.diags],
                 [np.asarray(getattr(j, n)) for n in names]
                 + [np.asarray(d) for d in j.diags])


def test_kernel_tail_refuses_varloc(monkeypatch):
    """The kernel tail once refused ``varloc``; B1 now carries it in its
    panel weights and B4 in its per-(ob, row) factor: the chordal kernel
    tail equals the plain one at 1e-10, through B1 and B4."""
    prior, ye, lat, lon, rvar, ovar, obs, bv, fac = _core_setup()
    calls = []
    for module, name in ((tail_solve, "tail_panel_solve"),
                         (ensrf_grid, "block_apply")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _r=real, _n=name, **k:
                            (calls.append(_n), _r(*a, **k))[1])
    run = lambda kernels: tcore.tail_scan_blocked(
        torch.tensor(ye.mean(1)), torch.tensor(ye - ye.mean(1)[:, None]),
        interop.obs_arrays_from_numpy(**obs, device="cpu"),
        fast_geometry=True, panel=4, kernels=kernels,
        varloc=torch.tensor(fac), ob_var=torch.tensor(ovar))
    got, want = run(True), run(False)
    assert calls.count("tail_panel_solve") == 4
    assert calls.count("block_apply") == 4
    names = ("ye", "gain_coef", "sqrt_coef", "tail_mean", "tail_perts")
    _assert_same([getattr(got, n).numpy() for n in names]
                 + [d.numpy() for d in got.diags],
                 [getattr(want, n).numpy() for n in names]
                 + [d.numpy() for d in want.diags], tol=1e-10)


# ---------------------------------------------------------------------------
# EnSRF.update() on a gridded multi-variable state
# ---------------------------------------------------------------------------

_LEVELS = (500.0, 700.0, 850.0)


def _level_pair(nobs=12, seed=7, nmems=12, flat=False):
    """A level-stacked state (``T_500``, ``T_700``, ``T_850`` with their
    pressure in ``var_verts``, 2 times, a 6 x 7 grid; or one variable,
    one time when ``flat``) and obs of several variables with levels and
    vertical radii, as JAX objects and as port objects."""
    rng = np.random.default_rng(seed)
    names = ("T_500",) if flat else tuple(f"T_{int(p)}" for p in _LEVELS)
    levels = _LEVELS[:len(names)]
    ntimes = 1 if flat else 2
    lon, lat = np.meshgrid(np.linspace(230, 250, 7), np.linspace(35, 50, 6))
    times = (np.datetime64("2026-08-01T00")
             + np.arange(ntimes) * np.timedelta64(6, "h"))
    data = np.stack([rng.normal(260 + 10 * i, 3, (ntimes, 6, 7, nmems))
                     for i in range(len(names))])
    args = (names, times, lat, lon, nmems)
    jstate = JState(jnp.asarray(data),
                    JStructure.build(*args, var_verts=levels))
    tstate = EnsembleState(torch.tensor(data),
                           StateStructure.build(*args, var_verts=levels))
    obs = []
    for i in range(nobs):
        k = i % len(names)
        obs.append(Observation(
            value=float(262 + 10 * k + rng.normal(0, 2)), obtype=names[k],
            time=times[0], error=1.0, lat=float(rng.uniform(36, 49)),
            lon=float(rng.uniform(231, 249)), vert=levels[k],
            vert_localize_radius=float(rng.choice([300.0, np.inf])),
            assimilate_this=bool(i % 5 != 4), localize_radius=900.0))
    jbatch = JBatch.coerce(obs)
    tbatch = interop.obs_batch_from_numpy(
        {k: getattr(jbatch, k) for k in _BATCH_FIELDS})
    return jstate, jbatch, tstate, tbatch


_SPEC = {"T_500:T_850": 0.0, "T_850:T_500": 0.4, "T_700:T_700": 0.8}


def _compare(jcfg, tcfg, **pair_kw):
    jstate, jbatch, tstate, tbatch = _level_pair(**pair_kw)
    jpost, jobs = JEnSRF(jstate, jbatch, config=jcfg, verbose=False).update()
    filt = EnSRF(tstate, tbatch, config=tcfg, verbose=False)
    tpost, tobs = filt.update()
    np.testing.assert_allclose(interop.state_to_numpy(tpost),
                               np.asarray(jpost.data), rtol=TOL, atol=TOL)
    jobs.materialize_diagnostics()
    for name in ("prior_mean", "prior_var", "post_mean", "post_var"):
        a, b = getattr(tobs, name), np.asarray(getattr(jobs, name))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)],
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(tobs.assimilated, jobs.assimilated)
    assert tobs.assimilated.any() and not tobs.assimilated.all()
    assert (ensrf_grid.b3_launches == ensrf_grid.b4_launches
            == ensrf_fused.launches == tail_solve.launches == 0)
    return filt, tstate, tpost


@pytest.mark.parametrize("label,kw,route", [
    ("defaults", dict(), "B4"),
    ("fast_geometry", dict(fast_geometry=True, tail_panel=8), "B3"),
    ("fast_geometry+varloc", dict(fast_geometry=True, tail_panel=8,
                                  variable_localization=_SPEC), "B3"),
    ("varloc, haversine", dict(variable_localization=_SPEC), "plain"),
])
def test_update_matches_jax_pallas_route(label, kw, route):
    """The port's ``EnSRF.update()`` against the JAX package's kernel route
    (``use_pallas=True``) on a 3-level x 2-time gridded state with
    vertical localization: B4 at the default config, B3 with fast
    geometry (with and without cross-variable factors), and the plain
    update where neither package has a kernel."""
    base = dict(localization="GC", dtype="float64", block_size=4, **kw)
    jkw = dict(base)
    if route == "B3" and "variable_localization" not in kw:
        jkw["tail_pallas"] = True  # the port's B1/B2 tail
    filt, _, _ = _compare(JConfig(use_pallas=True, **jkw),
                          FilterConfig(**base))
    assert filt._route(filt.prior.structure.nstate) == route


def test_zero_cross_factor_isolates_level_through_b3():
    """All obs observe T_500; the factor T_500 -> T_850 = 0 keeps every
    T_850 row at its prior exactly on the B3 route."""
    jstate, jbatch, tstate, tbatch = _level_pair()
    tbatch.obtypes = ["T_500"] * tbatch.nobs
    cfg = FilterConfig(localization="GC", dtype="float64",
                       fast_geometry=True, tail_panel=8, block_size=4,
                       variable_localization={"T_500:T_850": 0.0})
    filt = EnSRF(tstate, tbatch, config=cfg, verbose=False)
    assert filt._route(tstate.structure.nstate) == "B3"
    post, _ = filt.update()
    prior = interop.state_to_numpy(tstate)
    got = interop.state_to_numpy(post)
    np.testing.assert_array_equal(got[2], prior[2])
    assert np.abs(got[0] - prior[0]).max() > 1e-6


@pytest.mark.parametrize("kw,flat,route", [
    (dict(method="serial"), False, "serial"),
    (dict(fast_geometry=True), False, "B3"),
    (dict(fast_geometry=True, variable_localization=_SPEC), False, "B3"),
    (dict(fast_geometry=True), True, "B2"),
    (dict(localization=None), False, "B2"),
    (dict(), False, "B4"),
    (dict(), True, "B4"),
    (dict(variable_localization=_SPEC), False, "plain"),
    (dict(fast_geometry=True, variable_localization={"T_500:T_500": 0.5}),
     True, "plain"),
    (dict(localization=None, variable_localization=_SPEC), False, "plain"),
])
def test_routing_selects_the_jax_kernel(monkeypatch, kw, flat, route):
    """Each row of the routing table: the route the port names, the
    dispatchers it calls, and the JAX package's choice on the same
    configuration (mirrors ``tests/test_pallas_kernel.py::
    test_ensrf_class_routes_gridded_fast_geometry_to_v4_grid``)."""
    calls = []

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls.append(name)
            return real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    spy(ensrf_grid, "grid_apply")
    spy(ensrf_grid, "block_apply")
    spy(ensrf_fused, "fused_apply")
    spy(tail_solve, "tail_panel_solve")
    spy(tcore, "ensrf_blocked")
    spy(tcore, "ensrf_serial")
    jstate, jbatch, tstate, tbatch = _level_pair(nobs=6, flat=flat)
    if flat and "variable_localization" in kw:
        tbatch.obtypes = ["T_500"] * tbatch.nobs
    base = dict(localization="GC", dtype="float64", block_size=4,
                tail_panel=8)
    base.update(kw)
    filt = EnSRF(tstate, tbatch, config=FilterConfig(**base), verbose=False)
    assert filt._route(tstate.structure.nstate) == route
    filt.update()
    want = {"serial": {"ensrf_serial"}, "plain": {"ensrf_blocked"},
            "B3": {"grid_apply"}, "B4": {"block_apply"},
            "B2": {"fused_apply"}}[route]
    body = set(calls) - {"tail_panel_solve"}
    assert body == want, calls
    # The B1 tail on every kernel route, the plain panel scan on the
    # others.
    assert ("tail_panel_solve" in calls) == (route not in ("serial",
                                                            "plain"))
    # The JAX package on the same configuration.
    jfilt = JEnSRF(jstate, jbatch, verbose=False,
                   config=JConfig(use_pallas=True, **base))
    if route in ("serial", "plain"):
        assert route == "serial" or not jfilt._use_pallas()
    else:
        assert jfilt._use_pallas()
        assert jfilt._grid_kernel_ok() == (route == "B3")
        # The JAX package takes its tail kernel on the chordal runs
        # without varloc only; the port's B1 carries every kernel route.
        jtail = jfilt._tail_pallas(interpret=False)
        assert jtail == (route in ("B2", "B3")
                         and "variable_localization" not in kw)
        assert filt._tail_kernels()


def test_varloc_kwargs_match_jax():
    jstate, jbatch, tstate, tbatch = _level_pair()
    jf = JEnSRF(jstate, jbatch, verbose=False,
                config=JConfig(localization="GC", variable_localization=_SPEC))
    tf = EnSRF(tstate, tbatch, verbose=False,
               config=FilterConfig(localization="GC", dtype="float64",
                                   variable_localization=_SPEC))
    want = jf.varloc_kwargs(jnp.float64)
    got = tf.varloc_kwargs()
    for k in ("varloc", "row_var", "ob_var"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["varloc"].shape == (4, 3)
    assert tf.varloc_kwargs() and not EnSRF(
        tstate, tbatch, verbose=False,
        config=FilterConfig(dtype="float64")).varloc_kwargs()
    with pytest.raises(KeyError, match="unknown variable"):
        EnSRF(tstate, tbatch, verbose=False,
              config=FilterConfig(variable_localization={"NOPE:T_500": 0.5})
              ).varloc_kwargs()


def test_flat_demo_state_default_config_matches_jax_b4():
    """vt = 1 through B4 (vertical folded into per-row weights has no
    levels here): the demo state at the default config."""
    jstate = make_demo_state(ntimes=1, ny=6, nx=8, nmems=12, seed=21)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=9, seed=22,
                                         radius=700.0, all_assim=False))
    s = jstate.structure
    data = np.asarray(jstate.data)
    tstate = interop.state_from_numpy(
        {n: data[i] for i, n in enumerate(s.var_names)},
        {"validtime": s.times64(), "lat": s.lat, "lon": s.lon},
        dtype="float64", device="cpu")
    tbatch = interop.obs_batch_from_numpy(
        {k: getattr(jbatch, k) for k in _BATCH_FIELDS})
    kw = dict(localization="GC", dtype="float64", block_size=4)
    jpost, _ = JEnSRF(jstate, jbatch, verbose=False,
                      config=JConfig(use_pallas=True, **kw)).update()
    filt = EnSRF(tstate, tbatch, verbose=False, config=FilterConfig(**kw))
    assert filt._route(s.nstate) == "B4"
    tpost, _ = filt.update()
    np.testing.assert_allclose(interop.state_to_numpy(tpost),
                               np.asarray(jpost.data), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# Cross-variable localization on a mesh (``row_var`` split with the rows,
# the factors and ``ob_var`` replicated): float64, 1e-10
# ---------------------------------------------------------------------------


def _two_var_pair(nobs=14, seed=0, nmems=16, one_obtype=False):
    """``tests/test_varloc.py``'s two-variable state (2 times, 6 x 8),
    with every ob on the first variable when ``one_obtype``."""
    jstate = make_demo_state(nvars=2, ntimes=2, ny=6, nx=8, nmems=nmems,
                             seed=seed)
    obs = make_demo_obs(jstate, nobs=nobs, seed=seed + 1, radius=2000.0)
    names = jstate.structure.var_names
    if one_obtype:
        for ob in obs:
            ob.obtype = names[0]
    return jstate, JBatch.coerce(obs), names


def test_serial_blocked_mesh_agree_with_factors():
    from test_torch_sharded import (
        assert_mesh_agrees,
        close,
        mesh_runs,
        to_port,
    )

    jstate, jbatch, names = _two_var_pair(nobs=18, seed=3)
    spec = {f"{names[0]}:{names[1]}": 0.3, f"{names[1]}:{names[0]}": 0.7,
            (names[1], names[1]): 0.9}
    kw = dict(localization="GC", dtype="float64", variable_localization=spec)
    runs = mesh_runs(JEnSRF, EnSRF, jstate, jbatch, kw)
    assert_mesh_agrees(runs)
    serial, _ = EnSRF(*to_port(jstate, jbatch), verbose=False,
                      config=FilterConfig(**kw, method="serial")).update()
    close(runs[2][0], serial.data.numpy(), 1e-9)


def test_enkf_varloc_isolation_on_a_mesh(monkeypatch):
    """The EnKF with a zero cross factor on a mesh: the untargeted
    variable stays at its prior exactly, and the mesh analysis meets the
    JAX mesh one and the port's single-device one (the JAX draws)."""
    import jax

    from efa_xray_tpu.assimilation import enkf as jenkf
    from efa_xray_tpu_torch import EnKF
    from efa_xray_tpu_torch.assimilation import enkf as tenkf
    from test_torch_sharded import assert_mesh_agrees, mesh_runs

    def draw(seed, errors, nmems, scale=True):
        return torch.from_numpy(np.array(jenkf.draw_ob_perturbations(
            jax.random.PRNGKey(seed), jnp.asarray(errors.numpy()), nmems,
            scale=scale)))

    monkeypatch.setattr(tenkf, "draw_ob_perturbations", draw)
    jstate, jbatch, names = _two_var_pair(seed=7, one_obtype=True)
    runs = mesh_runs(jenkf.EnKF, EnKF, jstate, jbatch,
                     dict(localization="GC", dtype="float64",
                          variable_localization={
                              f"{names[0]}:{names[1]}": 0.0}), seed=4)
    assert_mesh_agrees(runs)
    np.testing.assert_array_equal(runs[2][0][1], np.asarray(jstate.data)[1])


def test_letkf_varloc_isolation_on_a_mesh():
    """The LETKF's rho factor (per-(group, patch) solves) on a mesh: a
    zero cross factor isolates the untargeted variable, and the mesh
    analysis meets the JAX mesh one and the port's single-device one."""
    from efa_xray_tpu.assimilation.letkf import LETKF as JLETKF
    from efa_xray_tpu_torch import LETKF
    from test_torch_sharded import assert_mesh_agrees, mesh_runs

    jstate, jbatch, names = _two_var_pair(seed=23, one_obtype=True)
    runs = mesh_runs(JLETKF, LETKF, jstate, jbatch,
                     dict(localization="GC", dtype="float64",
                          letkf_k_obs=8, letkf_chunk=16,
                          variable_localization={
                              f"{names[0]}:{names[1]}": 0.0}))
    assert_mesh_agrees(runs)
    prior = np.asarray(jstate.data)
    np.testing.assert_allclose(runs[2][0][1], prior[1], atol=1e-12)
    assert np.abs(runs[2][0][0] - prior[0]).max() > 1e-8
