"""The shallow-water model in the port against the JAX package's.

On a 16 x 32 channel in float64 on the CPU, from the same initial arrays:
``tendency``, a few RK4 steps of ``integrate``, ``initial_state`` (the
same NumPy draws), the flat-state adapters ``pack`` / ``unpack`` /
``grid_latlon`` / ``var_rows`` / ``make_flat_forecast``, and the
multivariate analysis and cycles of ``tests/test_swe.py`` (height obs
only, winds never observed) through both packages' ``CyclingHarness``,
all at 1e-9.  The spin-up is cut to a few hundred steps: parity needs a
trajectory, not the attractor (the winds' correction by height obs, which
needs the attractor's balance, is gated on the card).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.models import swe as jswe
from efa_xray_tpu.models.cycling import CyclingHarness as JHarness
from efa_xray_tpu_torch import FilterConfig, interop
from efa_xray_tpu_torch.models import swe
from efa_xray_tpu_torch.models.cycling import CyclingHarness

TOL = 1e-9
NY, NX, NM = 16, 32, 8
N = NY * NX
STEPS = 5


def _close(got, want, tol=TOL):
    for k in swe.VAR_ORDER:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def short_spinup():
    """A truth and an ensemble, 300 + 60 steps of the port's model from the
    JAX package's initial state: NumPy dicts (truth [NY, NX], members [NM,
    NY, NX]).  Every JAX integration below runs STEPS steps, so that it
    compiles once per shape."""
    x0 = {k: torch.as_tensor(np.array(v))
          for k, v in jswe.initial_state(NY, NX, seed=0).items()}
    truth = swe.integrate(x0, NY, nsteps=300)
    gen = torch.Generator().manual_seed(1)
    ens = swe.integrate(
        {k: truth[k][None] + (0.05 if k == "eta" else 0.02) * torch.randn(
            (NM, NY, NX), generator=gen, dtype=torch.float64)
         for k in truth}, NY, nsteps=60)
    return ({k: v.numpy() for k, v in truth.items()},
            {k: v.numpy() for k, v in ens.items()})


def test_initial_state_and_jet_match_jax():
    got = swe.initial_state(NY, NX, seed=3, device="cpu", dtype="float64")
    _close(got, jswe.initial_state(NY, NX, seed=3), tol=0)
    for a, b in zip(swe.jet_profile(NY), jswe.jet_profile(NY)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("members", [False, True], ids=["truth", "members"])
def test_tendency_and_integrate_match_jax(short_spinup, members):
    truth, ens = short_spinup
    x = ens if members else truth
    tx = interop.fields_from_numpy(x, device="cpu")
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    _close(swe.tendency(tx, NY), jswe.tendency(jx, NY))
    p = swe.SWEParams(nu4=2e-2, tau=100.0, f0=0.4)
    _close(swe.tendency(tx, NY, p), jswe.tendency(jx, NY, p))
    # p passed as make_flat_forecast passes it: one JAX compile per shape
    _close(swe.integrate(tx, NY, nsteps=STEPS),
           jswe.integrate(jx, NY, nsteps=STEPS, p=jswe.DEFAULT))


def test_flat_adapters_match_jax(short_spinup):
    truth, ens = short_spinup
    tx = interop.fields_from_numpy(ens, device="cpu")
    flat = swe.pack(tx, NY, NX)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jswe.pack({k: jnp.asarray(v)
                                            for k, v in ens.items()}, NY, NX)))
    assert flat.shape == (NM, 3 * N)
    back = swe.unpack(flat, NY, NX)
    for k in swe.VAR_ORDER:
        assert torch.equal(back[k], tx[k])
    for a, b in zip(swe.grid_latlon(NY, NX), jswe.grid_latlon(NY, NX)):
        np.testing.assert_array_equal(a, b)
    for v in swe.VAR_ORDER:
        np.testing.assert_array_equal(swe.var_rows(v, NY, NX, stride=2),
                                      jswe.var_rows(v, NY, NX, stride=2))
    fc = swe.make_flat_forecast(NY, NX, nsteps=STEPS)(flat)
    jfc = jswe.make_flat_forecast(NY, NX, nsteps=STEPS)(
        jnp.asarray(flat.numpy()))
    np.testing.assert_allclose(fc.numpy(), np.asarray(jfc), rtol=TOL,
                               atol=TOL)


def test_spinup_ensemble_shapes_and_finite():
    truth, ens = swe.spinup_ensemble(ny=8, nx=16, nmems=4, spinup_steps=20,
                                     member_steps=5, device="cpu",
                                     dtype="float64")
    assert truth["eta"].shape == (8, 16) and ens["u"].shape == (4, 8, 16)
    assert all(torch.isfinite(v).all() for v in ens.values())
    # members differ from one another
    assert float(ens["eta"].std(dim=0).mean()) > 0


def _harnesses(rows, ob_error, forecast_steps, **cfg):
    lat, lon = swe.grid_latlon(NY, NX)
    common = dict(state_lats=lat, state_lons=lon, ob_error=ob_error,
                  localize_radius=4000.0, obs_operator_rows=rows)
    jh = JHarness(forecast=jswe.make_flat_forecast(NY, NX, forecast_steps),
                  config=JConfig(dtype="float64", **cfg), **common)
    th = CyclingHarness(forecast=swe.make_flat_forecast(NY, NX,
                                                        forecast_steps),
                        config=FilterConfig(dtype="float64", **cfg),
                        device="cpu", **common)
    return jh, th


def test_height_obs_analysis_matches_jax(short_spinup):
    """One analysis of eta obs at every 2nd point (``tests/test_swe.py``'s
    ``_height_obs_update``, with the example's RTPS): the same posterior
    in both packages, and the observed eta corrected."""
    truth, ens = short_spinup
    flat_ens = np.asarray(jswe.pack({k: jnp.asarray(v)
                                     for k, v in ens.items()}, NY, NX))
    flat_truth = np.asarray(jswe.pack({k: jnp.asarray(v)
                                       for k, v in truth.items()}, NY, NX))
    rows = swe.var_rows("eta", NY, NX, stride=2)
    lat, lon = swe.grid_latlon(NY, NX)
    y = flat_truth[rows] + 1e-2 * np.random.default_rng(7).standard_normal(
        len(rows))
    jh, th = _harnesses(rows, 1e-4, 1, rtps_alpha=0.5)
    ja, jd = jh.analysis_step(jnp.asarray(flat_ens), jnp.asarray(y),
                              lat[rows], lon[rows])
    ta, td = th.analysis_step(interop.flat_ensemble_from_numpy(
        flat_ens, device="cpu"), y, lat[rows], lon[rows])
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(td.post_mean.numpy(), np.asarray(jd.post_mean),
                               rtol=TOL, atol=TOL)
    rmse = lambda e: np.sqrt(np.mean((e[:, :N].mean(0)
                                      - flat_truth[:N]) ** 2))
    assert rmse(ta.numpy()) < rmse(flat_ens)


def test_swe_cycles_match_jax(short_spinup):
    """Two cycles of the flat forecast and eta-only analyses through both
    harnesses."""
    truth, ens = short_spinup
    flat = lambda d: np.asarray(jswe.pack({k: jnp.asarray(v)
                                           for k, v in d.items()}, NY, NX))
    # the obs rows of the single analysis above: one JAX compile of the
    # analysis for both tests
    rows = swe.var_rows("eta", NY, NX, stride=2)
    jh, th = _harnesses(rows, 1e-4, STEPS, rtps_alpha=0.5)
    js = jh.run(flat(ens), flat(truth), 2, seed=3)
    ts = th.run(flat(ens), flat(truth), 2, seed=3)
    for a, b in zip(ts, js):
        for f in ("analysis_rmse", "background_rmse", "mean_spread",
                  "obs_prior_rmse", "obs_post_rmse", "analysis_crps"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=TOL, atol=TOL, err_msg=f)
    np.testing.assert_allclose(th._final_ensemble.numpy(),
                               np.asarray(jh._final_ensemble), rtol=TOL,
                               atol=TOL)
