"""Geometry and localization: the port's torch functions against the JAX
package's, on the same float64 inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efa_xray_tpu.observation import localization as jloc
from efa_xray_tpu.observation.thinning import _hilbert3d_np
from efa_xray_tpu_torch.observation import localization as tloc

TOL = 1e-12  # float64, identical formulas


def _points(n=257, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-89, 89, n), rng.uniform(-180, 360, n)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("halfwidth", [500.0, 2000.0, np.inf])
def test_gaspari_cohn(halfwidth):
    d = np.concatenate([[0.0], np.linspace(0, 5000, 301)])
    _close(tloc.gaspari_cohn(torch.tensor(d), halfwidth),
           jloc.gaspari_cohn(jnp.asarray(d), halfwidth))


def test_haversine_and_unit_vectors():
    lat, lon = _points()
    lat2, lon2 = _points(seed=1)
    _close(tloc.haversine((torch.tensor(lat), torch.tensor(lon)),
                          (torch.tensor(lat2), torch.tensor(lon2))),
           jloc.haversine((jnp.asarray(lat), jnp.asarray(lon)),
                          (jnp.asarray(lat2), jnp.asarray(lon2))), 1e-9)
    _close(tloc.latlon_to_unit(torch.tensor(lat), torch.tensor(lon)),
           jloc.latlon_to_unit(jnp.asarray(lat), jnp.asarray(lon)))


def test_arccos_and_chordal_weights():
    t = np.linspace(-1, 1, 401)
    _close(tloc._arccos_as(torch.tensor(t)), jloc._arccos_as(jnp.asarray(t)))
    lat, lon = _points(64)
    r = np.where(np.arange(64) % 5 == 0, np.inf, 1500.0)
    bx = tloc.latlon_to_unit(torch.tensor(lat), torch.tensor(lon))
    jx = jloc.latlon_to_unit(jnp.asarray(lat), jnp.asarray(lon))
    _close(tloc.chordal_gc_weights(bx[:, None, :], bx[None, :, :],
                                   torch.tensor(r)[None, :]),
           jloc.chordal_gc_weights(jx[:, None, :], jx[None, :, :],
                                   jnp.asarray(r)[None, :]))


@pytest.mark.parametrize("curve", ["morton", "hilbert"])
def test_space_filling_keys_equal(curve):
    lat, lon = _points(1000, seed=2)
    bx = tloc.latlon_to_unit(torch.tensor(lat), torch.tensor(lon))
    jx = jloc.latlon_to_unit(jnp.asarray(lat), jnp.asarray(lon))
    fn = f"{curve}3d_keys"
    got = getattr(tloc, fn)(bx).numpy()
    want = np.asarray(getattr(jloc, fn)(jx)).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    if curve == "hilbert":
        np.testing.assert_array_equal(tloc.hilbert3d_np(lat, lon),
                                      _hilbert3d_np(lat, lon))
