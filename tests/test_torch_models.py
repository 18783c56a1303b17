"""The Lorenz-96 models in the port against the JAX package: tendencies
and RK4 trajectories from the same initial arrays (float64, CPU, 1e-12),
the grids, and the spin-up's use of its generator."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efa_xray_tpu.models import l96_2d as j2d
from efa_xray_tpu.models import lorenz96 as j96
from efa_xray_tpu_torch.models import l96_2d, lorenz96

TOL = 1e-12


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("shape", [(40,), (6, 40)])
def test_lorenz96_matches_jax(shape):
    x0 = 8.0 + np.random.default_rng(1).normal(0, 1.0, shape)
    _close(lorenz96.tendency(torch.from_numpy(x0), forcing=8.5),
           j96.tendency(jnp.asarray(x0), forcing=8.5))
    _close(lorenz96.integrate(torch.from_numpy(x0), dt=0.05, nsteps=12),
           j96.integrate(jnp.asarray(x0), dt=0.05, nsteps=12))
    lats, lons = lorenz96.fake_latlon(40)
    jlats, jlons = j96.fake_latlon(40)
    np.testing.assert_array_equal(lats, jlats)
    np.testing.assert_array_equal(lons, jlons)


@pytest.mark.parametrize("shape,kappa", [((7, 16), 1.0), ((3, 7, 16), 0.4)])
def test_l96_2d_matches_jax(shape, kappa):
    x0 = 8.0 + np.random.default_rng(2).normal(0, 1.0, shape)
    _close(l96_2d.tendency(torch.from_numpy(x0), kappa=kappa),
           j2d.tendency(jnp.asarray(x0), kappa=kappa))
    _close(l96_2d.integrate(torch.from_numpy(x0), nsteps=9, kappa=kappa),
           j2d.integrate(jnp.asarray(x0), nsteps=9, kappa=kappa))
    flat = x0.reshape(x0.shape[:-2] + (-1,))
    _close(l96_2d.make_flat_forecast(7, 16, nsteps=3, kappa=kappa)(
               torch.from_numpy(flat)),
           j2d.make_flat_forecast(7, 16, nsteps=3, kappa=kappa)(flat))


def test_grid_latlon_matches_jax():
    for ny, nx, lat_max in ((8, 32, 60.0), (5, 9, 30.0)):
        got = l96_2d.grid_latlon(ny, nx, lat_max)
        want = j2d.grid_latlon(ny, nx, lat_max)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("model,kw", [
    (lorenz96, dict(nvars=20, nmems=5)),
    (l96_2d, dict(ny=4, nx=12, nmems=5)),
])
def test_spinup_draws_from_its_generator(model, kw):
    """JAX's PRNG is not reproduced: the spin-up is on the attractor, in
    the dtype asked for, and the same seed or generator state gives the
    same ensemble."""
    a = model.spinup_ensemble(seed=3, spinup_steps=40, device="cpu",
                              dtype=torch.float64, **kw)
    b = model.spinup_ensemble(
        generator=torch.Generator().manual_seed(3), spinup_steps=40,
        device="cpu", dtype=torch.float64, **kw)
    c = model.spinup_ensemble(seed=4, spinup_steps=40, device="cpu",
                              dtype=torch.float64, **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert x.dtype == torch.float64 and torch.isfinite(x).all()
    assert not torch.equal(a[1], c[1])
    truth, ens = a
    assert ens.shape == (kw["nmems"],) + truth.shape
    # spread around the truth, on the L96 attractor's scale
    assert 0.1 < float(ens.std(dim=0).mean()) < 10.0
