"""The port's plain EnSRF core against the JAX package's, the NumPy oracle,
and its own algebraic invariants, in float64."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle_numpy as oracle
from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import ensrf_core as jcore
from efa_xray_tpu.observation import forward as jfwd
from efa_xray_tpu.observation.observation import ObservationBatch
from efa_xray_tpu_torch import interop
from efa_xray_tpu_torch.assimilation import ensrf_core as tcore

TOL = 1e-9


def _setup(nobs=15, seed=3, radius=800.0, vertical=False):
    state = make_demo_state(nvars=2, ntimes=3, ny=6, nx=8, nmems=20,
                            seed=seed)
    batch = ObservationBatch.coerce(make_demo_obs(
        state, nobs=nobs, seed=seed + 1, radius=radius, all_assim=False))
    s = state.structure
    taps = jfwd.build_taps(s, batch.lats, batch.lons, batch.times_s,
                           batch.var_indices(s))
    vect = np.asarray(state.to_vect(), dtype=np.float64)
    ye = np.asarray(jfwd.apply_taps_obj(jnp.asarray(vect), taps))
    row_lat, row_lon = s.row_latlon()
    rng = np.random.default_rng(seed)
    obs = dict(values=batch.values, errors=batch.errors, lats=batch.lats,
               lons=batch.lons,
               radii=np.where(np.arange(nobs) % 6 == 5, np.inf,
                              batch.localize_radius),
               assim=batch.assimilate_flags & taps.qc_ok)
    body_vert = None
    if vertical:
        obs["verts"] = rng.uniform(100, 1000, nobs)
        obs["vert_radii"] = rng.choice([400.0, np.inf], nobs)
        body_vert = rng.uniform(100, 1000, vect.shape[0])
    return vect, ye, row_lat, row_lon, obs, body_vert


def _split(vect, ye):
    bm = vect.mean(1)
    tm = ye.mean(1)
    return bm, vect - bm[:, None], tm, ye - tm[:, None]


def _run(pkg, fn, vect, ye, row_lat, row_lon, obs, body_vert, **kw):
    """Run ``fn`` of the JAX core (``pkg="jax"``) or the port's on the
    same NumPy inputs; returns NumPy outputs."""
    arrays = _split(vect, ye) + (row_lat, row_lon)
    if pkg == "jax":
        args = [jnp.asarray(a) for a in arrays]
        o = jcore.ObsArrays(**{k: jnp.asarray(v) for k, v in obs.items()})
        bv = None if body_vert is None else jnp.asarray(body_vert)
        out = getattr(jcore, fn)(*args, o, body_vert=bv, **kw)
    else:
        args = [torch.tensor(a) for a in arrays]
        o = interop.obs_arrays_from_numpy(**obs, device="cpu")
        bv = None if body_vert is None else torch.tensor(body_vert)
        out = getattr(tcore, fn)(*args, o, body_vert=bv, **kw)
    bm, bp, tm, tp, diags = out
    return [np.asarray(x) for x in (bm, bp, tm, tp, *diags)]


def _assert_same(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g[~np.isnan(g)], w[~np.isnan(w)],
                                   rtol=tol, atol=tol)


CASES = [
    dict(localize=True),
    dict(localize=False),
    dict(localize=True, fast_geometry=True),
    dict(localize=True, vertical=True),
    dict(localize=True, fast_geometry=True, unbiased=True),
]


@pytest.mark.parametrize("kw", CASES)
@pytest.mark.parametrize("fn", ["ensrf_serial", "ensrf_blocked"])
def test_core_matches_jax(fn, kw):
    vect, ye, lat, lon, obs, bv = _setup(vertical=kw.get("vertical", False))
    extra = dict(block_size=5) if fn == "ensrf_blocked" else {}
    want = _run("jax", fn, vect, ye, lat, lon, obs, bv, **kw, **extra)
    got = _run("torch", fn, vect, ye, lat, lon, obs, bv, **kw, **extra)
    _assert_same(got, want)


def _tails(obs, ye, **kw):
    tm = ye.mean(1)
    tp = ye - tm[:, None]
    j = jcore.tail_scan_blocked(
        jnp.asarray(tm), jnp.asarray(tp),
        jcore.ObsArrays(**{k: jnp.asarray(v) for k, v in obs.items()}),
        **{k.replace("kernels", "pallas_apply"): v for k, v in kw.items()},
        **(dict(interpret=True) if kw.get("kernels") else {}))
    t = tcore.tail_scan_blocked(torch.tensor(tm), torch.tensor(tp),
                                interop.obs_arrays_from_numpy(
                                    **obs, device="cpu"), **kw)
    return j, t


@pytest.mark.parametrize("kw", [
    dict(localize=True, panel=8),
    dict(localize=True, vertical=True, panel=16),
    dict(localize=True, fast_geometry=True, panel=8, kernels=True,
         max_radius_km=2000.0),
    dict(localize=True, fast_geometry=True, vertical=True, panel=8,
         kernels=True, max_radius_km=None),
    dict(localize=False, panel=8, kernels=True),
    dict(localize=True, fast_geometry=True, panel=32, kernels=True,
         max_radius_km=900.0),
])
def test_tail_scan_blocked_matches_jax(kw):
    """Plain branch against the JAX XLA branch; kernel branch (B1 + B2
    plain versions) against the JAX Pallas branch in interpret mode; the
    32-ob panel covers the one-panel (nobs <= panel) path."""
    vect, ye, lat, lon, obs, bv = _setup(nobs=21,
                                         vertical=kw.get("vertical", False))
    j, t = _tails(obs, ye, **kw)
    names = ("ye", "gain_coef", "sqrt_coef", "tail_mean", "tail_perts")
    _assert_same([getattr(t, n).numpy() for n in names] +
                 [d.numpy() for d in t.diags],
                 [np.asarray(getattr(j, n)) for n in names] +
                 [np.asarray(d) for d in j.diags])


@pytest.mark.parametrize("localized", [True, False])
def test_serial_matches_numpy_oracle(localized):
    vect, ye, lat, lon, obs, _ = _setup(radius=800.0 if localized else None)
    want, wd = oracle.serial_ensrf(
        vect, ye, obs["values"], obs["errors"], obs["lats"], obs["lons"],
        obs["radii"], lat, lon, obs["assim"], localize=localized)
    bm, bp, tm, tp, pm, pv, om, ov, asm = _run(
        "torch", "ensrf_serial", vect, ye, lat, lon, obs, None,
        localize=localized)
    np.testing.assert_allclose(bm[:, None] + bp, want, rtol=TOL, atol=TOL)
    _assert_same([pm, pv, om, ov],
                 [wd["prior_mean"], wd["prior_var"], wd["post_mean"],
                  wd["post_var"]], 1e-8)
    np.testing.assert_array_equal(asm, wd["assimilated"])


@pytest.mark.parametrize("block_size", [1, 3, 7, 32])
def test_blocked_equals_serial_any_block_size(block_size):
    vect, ye, lat, lon, obs, _ = _setup(nobs=13)
    s = _run("torch", "ensrf_serial", vect, ye, lat, lon, obs, None)
    b = _run("torch", "ensrf_blocked", vect, ye, lat, lon, obs, None,
             block_size=block_size)
    _assert_same(b, s, 1e-10)


@pytest.mark.parametrize("kw", [dict(localize=True), dict(localize=False),
                                dict(localize=True, fast_geometry=True),
                                dict(localize=True, vertical=True),
                                dict(localize=True, unbiased=True)])
def test_tail_scan_blocked_equals_tail_scan_any_panel(kw):
    vect, ye, lat, lon, obs, _ = _setup(nobs=23, vertical=kw.get("vertical",
                                                                 False))
    tm = torch.tensor(ye.mean(1))
    tp = torch.tensor(ye - ye.mean(1, keepdims=True))
    o = interop.obs_arrays_from_numpy(**obs, device="cpu")
    a = tcore.tail_scan(tm, tp, o, **kw)
    for panel in (4, 8, 23, 40):
        b = tcore.tail_scan_blocked(tm, tp, o, panel=panel, **kw)
        for name in ("ye", "gain_coef", "sqrt_coef", "tail_mean",
                     "tail_perts"):
            np.testing.assert_allclose(getattr(b, name).numpy(),
                                       getattr(a, name).numpy(), atol=1e-11,
                                       err_msg=f"{kw} panel={panel} {name}")
        _assert_same([d.numpy() for d in b.diags],
                     [d.numpy() for d in a.diags], 1e-11)
