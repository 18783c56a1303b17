"""The cycling harness in the port against the JAX package's.

A small Lorenz-96 (40 variables, 10 members, every 2nd variable observed)
runs a few cycles through both ``CyclingHarness`` classes from the same
spun-up ensemble, with the same NumPy draws of obs noise and additive
inflation: every ``CycleStats`` field, the final ensemble and every
transient field (inflation, R, bias, IAU increment, smoother window)
agree at 1e-9 in float64 on the CPU.  One case per option of the harness
(the cycling cases of ``tests/test_lorenz96.py`` and
``tests/test_inflation.py``).  The EnKF gets the same perturbation tables
in both packages (JAX's threefry draws cannot be matched); the adaptive
cases run the JAX package with its Anderson root taken without
cancellation (the ``jax_stable_root`` fixture).  Then the port alone:
checkpoint/resume bit for bit, and the harness's EnSRF route (the
kernels' plain versions here) against ``EnSRF.update()`` and the plain
``ensrf_blocked``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efa_xray_tpu.assimilation import enkf as jenkf
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.models import lorenz96 as jl96
from efa_xray_tpu.models.cycling import CyclingHarness as JHarness
from efa_xray_tpu_torch import FilterConfig, interop
from efa_xray_tpu_torch.assimilation import enkf as tenkf
from efa_xray_tpu_torch.assimilation import ensrf_core as tcore
from efa_xray_tpu_torch.assimilation.ensrf import FlatRoute
from efa_xray_tpu_torch.models import cycling, lorenz96
from efa_xray_tpu_torch.models.cycling import CyclingHarness
from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid, tail_solve
from test_torch_adaptive_inflation import jax_stable_root  # noqa: F401

TOL = 1e-9
NVARS, NMEMS, NCYCLES = 40, 10, 4
ROWS = np.arange(0, NVARS, 2)

CASES = {
    "ensrf, static inflation": dict(inflation=1.05),
    "letkf": dict(solver="letkf", inflation=1.05),
    "enkf": dict(solver="enkf", inflation=1.05, enkf_seed=3),
    "adaptive, evolved sd, damping, cap": dict(
        adaptive_inflation=True, adaptive_sd=0.6, adaptive_sd_evolve=True,
        adaptive_sd_min=0.15, adaptive_damp=0.9, adaptive_max=1.6),
    "adaptive, fixed sd": dict(adaptive_inflation=True, adaptive_sd=0.3),
    "additive, white": dict(inflation=1.02, additive_sigma=0.2),
    "additive, bank": dict(additive_sigma=0.3, additive_bank="bank"),
    "adaptive_r": dict(inflation=1.05, adaptive_r=True,
                       run=dict(obs_noise_var=2.0)),
    "adaptive_bias": dict(inflation=1.05, adaptive_bias=True,
                          run=dict(obs_bias=1.0)),
    "iau": dict(inflation=1.05, iau_steps=2),
    "smoother lag": dict(inflation=1.05, smoother_lag=2),
    "rtps": dict(rtps_alpha=0.5),
    "rtpp": dict(rtpp_alpha=0.5),
}


@pytest.fixture(scope="module")
def spun_up():
    truth, ens = jl96.spinup_ensemble(nvars=NVARS, nmems=NMEMS, seed=2)
    bank = np.random.default_rng(4).normal(0.0, 1.0, (25, NVARS))
    return np.array(truth), np.array(ens), bank


def _harnesses(kw, bank, radius=4000.0):
    """The JAX harness and the port's (CPU) for one case's options."""
    kw = dict(kw)
    kw.pop("run", None)
    cfg_kw = {k: kw.pop(k) for k in ("rtps_alpha", "rtpp_alpha")
              if k in kw}
    if kw.get("additive_bank") == "bank":
        kw["additive_bank"] = bank
    steps = 2 if kw.get("iau_steps") else 4
    lats, lons = jl96.fake_latlon(NVARS)
    common = dict(state_lats=lats, state_lons=lons, ob_error=1.0,
                  localize_radius=radius, obs_operator_rows=ROWS, **kw)
    cfg = dict(localization="GC", dtype="float64", block_size=8, **cfg_kw)
    jh = JHarness(forecast=lambda x: jl96.integrate(x, nsteps=steps),
                  config=JConfig(**cfg), **common)
    th = CyclingHarness(
        forecast=lambda x: lorenz96.integrate(x, nsteps=steps),
        config=FilterConfig(**cfg), device="cpu", **common)
    return jh, th


@pytest.fixture
def same_eps(monkeypatch):
    """Both packages' EnKF draw one table per cycle from the same NumPy
    stream, in call order."""
    tables = []

    def table(i, nobs, nmems):
        while len(tables) <= i:
            rng = np.random.default_rng(100 + len(tables))
            eps = rng.standard_normal((nobs, nmems))
            tables.append(eps - eps.mean(axis=1, keepdims=True))
        return tables[i]

    calls = {"jax": 0, "port": 0}

    def jdraw(key, errors, nmems, scale=True):
        e = table(calls["jax"], errors.shape[0], nmems)
        calls["jax"] += 1
        return jnp.asarray(e * np.sqrt(np.asarray(errors))[:, None])

    def tdraw(seed, errors, nmems, scale=True):
        e = table(calls["port"], errors.shape[0], nmems)
        calls["port"] += 1
        return torch.as_tensor(e, dtype=errors.dtype) * torch.sqrt(
            errors)[:, None]

    monkeypatch.setattr(jenkf, "draw_ob_perturbations", jdraw)
    monkeypatch.setattr(tenkf, "draw_ob_perturbations", tdraw)
    return calls


def _assert_same_run(jstats, tstats, jh, th):
    assert [s.cycle for s in jstats] == [s.cycle for s in tstats]
    for f in ("analysis_rmse", "background_rmse", "mean_spread",
              "obs_prior_rmse", "obs_post_rmse", "analysis_crps"):
        np.testing.assert_allclose([getattr(s, f) for s in tstats],
                                   [getattr(s, f) for s in jstats],
                                   rtol=TOL, atol=TOL, err_msg=f)
    want = interop.harness_transients_to_numpy(jh)
    got = interop.harness_transients_to_numpy(th)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, list):
            assert len(g) == len(w), k
            for a, b in zip(g, w):
                np.testing.assert_allclose(np.asarray(a, np.float64),
                                           np.asarray(b, np.float64),
                                           rtol=TOL, atol=TOL, err_msg=k)
        elif w is None:
            assert g is None, k
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64),
                                       rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_harness_matches_jax(case, spun_up, request):
    if case.startswith("adaptive,"):
        request.getfixturevalue("jax_stable_root")
    if case == "enkf":
        calls = request.getfixturevalue("same_eps")
    truth, ens, bank = spun_up
    kw = CASES[case]
    jh, th = _harnesses(kw, bank)
    run_kw = dict(kw.get("run", {}), seed=7)
    jstats = jh.run(ens.copy(), truth.copy(), NCYCLES, **run_kw)
    tstats = th.run(ens.copy(), truth.copy(), NCYCLES, **run_kw)
    _assert_same_run(jstats, tstats, jh, th)
    if case == "enkf":
        assert calls == {"jax": NCYCLES, "port": NCYCLES}
    if case == "smoother lag":
        assert th.smoothed_rmse() and len(th.smoothed_rmse()) == len(
            jh.smoothed_rmse())
    # the analysis beats the background on average over the run
    assert np.mean([s.background_rmse - s.analysis_rmse
                    for s in tstats]) > 0


def test_analysis_step_with_obs_operator_matches_jax(spun_up):
    """A general H (``obs_operator``: pairwise means of neighbours) through
    ``analysis_step`` in both packages."""
    truth, ens, bank = spun_up
    jh, th = _harnesses(dict(inflation=1.05), bank)
    pick = lambda x: 0.5 * (x[:, ROWS] + x[:, (ROWS + 1) % NVARS]).T
    jh.obs_operator = lambda x: pick(x)
    th.obs_operator = lambda x: pick(x)
    y = 0.5 * (truth[ROWS] + truth[(ROWS + 1) % NVARS]) + 0.3
    lats, lons = jl96.fake_latlon(NVARS)
    ja, jd = jh.analysis_step(jnp.asarray(ens), jnp.asarray(y), lats[ROWS],
                              lons[ROWS])
    ta, td = th.analysis_step(torch.as_tensor(ens), y, lats[ROWS],
                              lons[ROWS])
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=TOL,
                               atol=TOL)
    for a, b in zip(td[:4], jd[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("case", ["adaptive_r + bias + smoother",
                                  "additive + evolved adaptive + iau"])
def test_checkpoint_resume_is_bit_exact(case, spun_up, tmp_path):
    """save_checkpoint / load_checkpoint + ``run(resume=True)`` in a fresh
    harness reproduces the uninterrupted run bit for bit: the RNG, the
    adaptive fields, the IAU increment and the smoother window carry
    over (``tests/test_lorenz96.py:435``, ``:573``,
    ``tests/test_inflation.py:459``)."""
    truth, ens, bank = spun_up
    kw = (dict(inflation=1.05, smoother_lag=2, adaptive_r=True,
               adaptive_bias=True)
          if case.startswith("adaptive_r") else
          dict(additive_sigma=0.2, adaptive_inflation=True,
               adaptive_sd_evolve=True, adaptive_sd_min=0.15, iau_steps=2))
    make = lambda: _harnesses(kw, bank)[1]
    full_h = make()
    full = full_h.run(ens.copy(), truth.copy(), 6, seed=5, obs_bias=0.5)
    h = make()
    first = h.run(ens.copy(), truth.copy(), 3, seed=5, obs_bias=0.5)
    h.save_checkpoint(str(tmp_path / "c.pkl"))
    h2 = make()
    h2.load_checkpoint(str(tmp_path / "c.pkl"))
    second = h2.run(None, None, 3, obs_bias=0.5, resume=True)
    assert [s.cycle for s in first + second] == list(range(6))
    for a, b in zip(first + second, full):
        assert a == b
    assert torch.equal(h2._final_ensemble, full_h._final_ensemble)
    want = interop.harness_transients_to_numpy(full_h)
    got = interop.harness_transients_to_numpy(h2)
    for k in ("_lam", "_lam_sd", "_r_work", "_bias_work", "_iau_increment",
              "_smoothed_rmse"):
        if k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def test_fresh_run_resets_state(spun_up):
    """A run without ``resume`` inherits nothing from the previous one
    (``tests/test_lorenz96.py:502``)."""
    truth, ens, bank = spun_up
    h = _harnesses(dict(inflation=1.05, smoother_lag=2, adaptive_r=True),
                   bank)[1]
    a = h.run(ens.copy(), truth.copy(), 3, seed=3)
    b = h.run(ens.copy(), truth.copy(), 3, seed=3)
    assert a == b
    with pytest.raises(ValueError):
        CyclingHarness(forecast=lambda x: x, state_lats=np.zeros(3),
                       state_lons=np.zeros(3), device="cpu").run(
                           np.zeros((2, 3)), np.zeros(3), 1, resume=True)


ROUTES = {"B4": dict(), "B2": dict(fast_geometry=True),
          "B2, unlocalized": dict(localization=None),
          # options the JAX harness ignores: the route ignores them too
          "B4, hybrid config": dict(hybrid_alpha=0.5, static_b_sigma=1.0,
                                    static_b_length=500.0),
          "B4, variable_localization config": dict(
              variable_localization={("X", "X"): 0.5}),
          "B4, serial method config": dict(method="serial"),
          "B2, hybrid config": dict(hybrid_alpha=0.5, static_b_sigma=1.0,
                                    static_b_length=500.0,
                                    fast_geometry=True)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_flat_route_equals_ensrf_update_and_plain(route, spun_up,
                                                  monkeypatch):
    """The harness's EnSRF analysis takes :class:`FlatRoute`, the route of
    ``EnSRF.update()`` (B1 tail, B4 or B2 body; their plain versions on
    the CPU): it equals ``EnSRF.update()`` on the same ensemble as a
    location-list state at 1e-10, and, where the body computes the plain
    blocked update's weights (exact haversine, or none), the plain
    ``ensrf_blocked`` at 1e-10 (B2's chordal angle is a polynomial).
    ``method``, ``hybrid_alpha`` and ``variable_localization``, which the
    JAX harness ignores, neither move it off the kernel route nor change
    its result: ``EnSRF.update()`` gets the config without them."""
    from efa_xray_tpu_torch import EnSRF, EnsembleState, ObservationBatch

    truth, ens, bank = spun_up
    routes = []
    real = FlatRoute._body_apply

    def spy(self, r, *a, **k):
        routes.append(r)
        return real(self, r, *a, **k)

    monkeypatch.setattr(FlatRoute, "_body_apply", spy)
    kw = ROUTES[route]
    cfg = FilterConfig(dtype="float64", block_size=8, **kw)
    lats, lons = jl96.fake_latlon(NVARS)
    th = CyclingHarness(forecast=lambda x: x, state_lats=lats,
                        state_lons=lons, localize_radius=4000.0,
                        obs_operator_rows=ROWS, config=cfg, device="cpu")
    y = truth[ROWS] + 0.5
    ta, td = th.analysis_step(torch.as_tensor(ens), y, lats[ROWS],
                              lons[ROWS])
    assert routes == [route.split(",")[0]]

    base = FilterConfig(dtype="float64", block_size=8, **{
        k: v for k, v in kw.items() if k in ("fast_geometry",
                                             "localization")})
    time = np.datetime64("2026-08-01T00:00:00")
    state = EnsembleState.from_vardict(
        {"X": ens.T[None]}, {"validtime": np.array([time]), "lat": lats,
                             "lon": lons}, dtype="float64", device="cpu")
    n = len(ROWS)
    batch = ObservationBatch(
        values=y, errors=np.ones(n), lats=lats[ROWS], lons=lons[ROWS],
        times_s=np.full(n, state.structure.times_s[0]), obtypes=["X"] * n,
        localize_radius=np.full(n, 4000.0), assimilate_flags=np.ones(n, bool),
        verts=np.full(n, np.nan), descriptions=[None] * n)
    post, out = EnSRF(state, batch, config=base, verbose=False).update()
    np.testing.assert_allclose(ta.numpy(), post.to_vect().T.numpy(),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(td.prior_mean.numpy(), out.prior_mean,
                               rtol=0, atol=1e-10)
    if not base.fast_geometry:
        x = torch.as_tensor(ens).T
        bm = x.mean(dim=1)
        ye = x[torch.as_tensor(ROWS)]
        tm = ye.mean(dim=1)
        obs = interop.obs_arrays_from_numpy(
            y, np.ones(n), lats[ROWS], lons[ROWS], np.full(n, 4000.0),
            np.ones(n, bool), device="cpu")
        pbm, pbp, *_ = tcore.ensrf_blocked(
            bm, x - bm[:, None], tm, ye - tm[:, None],
            torch.as_tensor(lats), torch.as_tensor(lons), obs,
            localize=base.localize, block_size=8)
        np.testing.assert_allclose(ta.numpy(),
                                   (pbm[:, None] + pbp).T.numpy(),
                                   rtol=0, atol=1e-10)
    # on CPU tensors no CUDA launch is counted
    assert tail_solve.launches == 0 and ensrf_fused.launches == 0
    assert ensrf_grid.b4_launches == 0


def test_crps_mean_matches_the_brute_force_oracle(spun_up):
    """``_crps_mean`` (the sorted-pair identity) against the all-pairs
    form (``tests/test_lorenz96.py:107``)."""
    truth, ens, _ = spun_up
    mae = np.mean(np.abs(ens - truth[None, :]))
    pair = np.mean(np.abs(ens[:, None, :] - ens[None, :, :]))
    np.testing.assert_allclose(cycling._crps_mean(ens, truth),
                               mae - 0.5 * pair, rtol=1e-12)
