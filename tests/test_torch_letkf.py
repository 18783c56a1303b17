"""The LETKF in the port against the JAX package (float64, CPU, 1e-9).

Each case of ``tests/test_letkf.py`` but the five that need a mesh has its
counterpart here, held against the JAX package as well as against the
property it pins.  The JAX test that reads the chord dots' precision out
of a jaxpr becomes one on the port's dots (three products, never a matrix
product) and on the absence of TF32 switches in the port.  Added: the
top-k tie order, the Newton-Schulz iteration count against the JAX
package's, ``solve_patch_weights`` / ``apply_patch_weights`` and
``letkf_update`` with varloc, the host candidates against the JAX
package's, the selection cache's device key, the refusals, the device
default, and ``taps_topk``."""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import ensrf_core as jcore
from efa_xray_tpu.assimilation import letkf_core as jl
from efa_xray_tpu.assimilation.letkf import LETKF as JLETKF
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.observation import forward as jfwd
from efa_xray_tpu.observation.observation import Observation
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu.state.ensemble import EnsembleState as JState
from efa_xray_tpu.state.structure import StateStructure as JStructure
from efa_xray_tpu_torch import (
    EnKF,
    EnSRF,
    EnsembleState,
    FilterConfig,
    LETKF,
    interop,
)
from efa_xray_tpu_torch.assimilation import ensrf_core as tcore
from efa_xray_tpu_torch.assimilation import letkf as tletkf
from efa_xray_tpu_torch.assimilation import letkf_core as tl
from efa_xray_tpu_torch.observation import forward as tfwd
from efa_xray_tpu_torch.observation.localization import haversine
from efa_xray_tpu_torch.state.structure import StateStructure

TOL = 1e-9
_BATCH_FIELDS = ("values", "errors", "lats", "lons", "times_s", "obtypes",
                 "localize_radius", "assimilate_flags", "verts",
                 "descriptions", "vert_radius")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               rtol=tol, atol=tol)


def _toy(ngrid=60, vt=2, nmems=12, nobs=9, seed=0, radius=2000.0,
         glat=None, glon=None):
    """``tests/test_letkf.py``'s toy: ``(jax_args, port_args, ngrid)``,
    each args ``[bm, bp, tm, tp, grid_lat, grid_lon, obs]``."""
    rng = np.random.default_rng(seed)
    prior = rng.normal(280, 4, (ngrid * vt, nmems))
    lat = rng.uniform(-60, 60, ngrid)
    lon = rng.uniform(0, 360, ngrid)
    rows = rng.integers(0, ngrid, nobs)
    ye = prior.reshape(vt, ngrid, nmems)[0][rows]
    o = dict(values=ye.mean(1) + rng.normal(0, 1.0, nobs),
             errors=np.ones(nobs), lats=lat[rows], lons=lon[rows],
             radii=np.full(nobs, radius), assim=np.ones(nobs, bool))
    glat = lat if glat is None else glat
    glon = lon if glon is None else glon
    arrays = [prior.mean(1), prior - prior.mean(1, keepdims=True),
              ye.mean(1), ye - ye.mean(1, keepdims=True), glat, glon]
    jargs = [jnp.asarray(a) for a in arrays] + [jcore.ObsArrays(
        **{k: jnp.asarray(v) for k, v in o.items()})]
    targs = [torch.from_numpy(np.array(a, np.float64)) for a in arrays] + [
        interop.obs_arrays_from_numpy(**o, dtype="float64", device="cpu")]
    return jargs, targs, ngrid


def _both(jargs, targs, ngrid, **kw):
    """``letkf_update`` of both packages on the same inputs; asserts they
    agree and returns the port's."""
    want = jl.letkf_update(*jargs, ngrid=ngrid, **kw)
    got = tl.letkf_update(*targs, ngrid=ngrid, **kw)
    for i in range(4):
        _close(got[i], want[i])
    for f in range(5):
        _close(got[4][f], want[4][f])
    return got


# ---------------------------------------------------------------------------
# letkf_core
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sqrt_method", ["eigh", "newton_schulz"])
def test_unlocalized_matches_serial_ensrf_mean_and_covariance(sqrt_method):
    jargs, targs, ngrid = _toy()
    bm1, bp1, *_ = tcore.ensrf_serial(*targs[:4], targs[4].repeat(2),
                                      targs[5].repeat(2), targs[6],
                                      localize=False, unbiased=True)
    bm2, bp2, *_ = _both(jargs, targs, ngrid, localize=False,
                         sqrt_method=sqrt_method)
    _close(bm2, bm1, 1e-10)
    _close(bp2 @ bp2.T, bp1 @ bp1.T, 1e-10)


def test_newton_schulz_matches_eigh():
    jargs, targs, ngrid = _toy(radius=1500.0)
    kw = dict(localize=True, k_obs=6)
    eig = _both(jargs, targs, ngrid, sqrt_method="eigh", **kw)
    ns = _both(jargs, targs, ngrid, sqrt_method="newton_schulz",
               ns_iters=60, **kw)
    for i in (0, 1, 3):
        _close(ns[i], eig[i])


def _jax_ns_iterations(amat, cap=200):
    """The iteration count at which the JAX package's while_loop exits
    on ``amat``: the least cap whose result equals the uncapped one."""
    full = np.asarray(jl._invsqrt_newton_schulz(jnp.asarray(amat), cap)[0])
    for n in range(1, cap):
        if np.array_equal(np.asarray(
                jl._invsqrt_newton_schulz(jnp.asarray(amat), n)[0]), full):
            return n
    return cap


@pytest.mark.parametrize("cond", [1.0, 30.0, 1e4])
def test_newton_schulz_exits_where_jax_exits(cond):
    """The same batch gives the same iteration count as the JAX package's
    ``lax.while_loop`` (its exit rule kept exactly), one host read per
    iteration, and ``A^{-1/2}``, ``A^{-1}`` equal to eigh's."""
    rng = np.random.default_rng(int(cond))
    m = 10
    q, _ = np.linalg.qr(rng.normal(size=(5, m, m)))
    ev = np.exp(rng.uniform(0.0, np.log(cond), (5, m)))
    amat = np.einsum("bij,bj,bkj->bik", q, ev, q)
    tl.reset_counts()
    got = tl._invsqrt_newton_schulz(torch.from_numpy(amat), 200)
    assert tl.ns_calls == 1
    assert tl.ns_iterations == _jax_ns_iterations(amat)
    assert tl.host_syncs == tl.ns_iterations
    want = jl._invsqrt_newton_schulz(jnp.asarray(amat), 200)
    ref = tl._invsqrt_eigh(torch.from_numpy(amat))
    for a, b, c in zip(got, want, ref):
        _close(a, b)
        _close(a, c, 1e-9 * cond)


def test_localization_confines_update():
    """Grid points beyond twice the radius from every ob are untouched."""
    jargs, targs, ngrid = _toy(radius=500.0, seed=3)
    bm, bp, *_ = _both(jargs, targs, ngrid, localize=True, k_obs=9)
    obs = targs[6]
    d = haversine((targs[4][:, None], targs[5][:, None]),
                  (obs.lats[None, :], obs.lons[None, :])).numpy()
    far = np.tile(d.min(axis=1) > 2.0 * 500.0 + 1.0, 2)
    assert far.any()
    np.testing.assert_allclose(bm.numpy()[far], targs[0].numpy()[far],
                               atol=1e-12)
    np.testing.assert_allclose(bp.numpy()[far], targs[1].numpy()[far],
                               atol=1e-12)
    assert np.abs(bm.numpy()[~far] - targs[0].numpy()[~far]).max() > 1e-6


def test_posterior_perturbations_stay_centered():
    jargs, targs, ngrid = _toy(seed=4)
    _, bp, _, tp, _ = _both(jargs, targs, ngrid, localize=True)
    assert float(bp.sum(dim=1).abs().max()) < 1e-10
    assert float(tp.sum(dim=1).abs().max()) < 1e-10


def test_patch_sharing_approximates_pointwise():
    """On a raster row patches of 4 stay close to per-point weights, and
    equal them when a patch's members share one location."""
    jargs, targs, ngrid = _toy(ngrid=64, radius=4000.0, seed=5,
                               glat=np.full(64, 45.0),
                               glon=np.arange(64) * 2.0 + 180.0)
    bm1, *_ = _both(jargs, targs, ngrid, patch_size=1)
    bm4, *_ = _both(jargs, targs, ngrid, patch_size=4, chunk=5)
    upd = float((bm1 - targs[0]).abs().max())
    assert upd > 0 and float((bm1 - bm4).abs().max()) < 0.2 * upd
    jargs, targs, _ = _toy(ngrid=64, radius=4000.0, seed=5)
    for args, pkg in ((jargs, jnp), (targs, torch)):
        args[4] = pkg.repeat_interleave(args[4][::4], 4) if pkg is torch \
            else jnp.repeat(args[4][::4], 4)
        args[5] = pkg.repeat_interleave(args[5][::4], 4) if pkg is torch \
            else jnp.repeat(args[5][::4], 4)
    shared, *_ = _both(jargs, targs, ngrid, patch_size=4)
    point, *_ = _both(jargs, targs, ngrid, patch_size=1)
    _close(shared, point, 1e-10)


def test_assim_mask_removes_influence():
    jargs, targs, ngrid = _toy(seed=6)
    jargs[6] = jargs[6]._replace(assim=jnp.zeros(9, bool))
    targs[6] = targs[6]._replace(assim=torch.zeros(9, dtype=torch.bool))
    bm, bp, _, _, diags = _both(jargs, targs, ngrid, localize=True)
    _close(bm, targs[0], 1e-10)
    _close(bp, targs[1], 1e-10)
    assert not diags.assimilated.any()
    assert torch.isnan(diags.post_mean).all()


def test_k_obs_truncation_exact_when_footprint_is_small():
    jargs, targs, ngrid = _toy(nobs=6, radius=300.0, seed=7)
    full, *_ = _both(jargs, targs, ngrid, k_obs=6)
    k3, *_ = _both(jargs, targs, ngrid, k_obs=3)
    _close(full, k3, 1e-10)


def test_empty_obs_is_identity():
    jargs, targs, ngrid = _toy(nobs=0)
    bm, bp, tm, tp, diags = tl.letkf_update(*targs, ngrid=ngrid)
    assert torch.equal(bm, targs[0]) and torch.equal(bp, targs[1])
    assert diags.prior_mean.shape == (0,)


def test_letkf_vertical_masks_far_levels():
    """An ob with a tight vertical radius at level A leaves level B
    untouched and updates level A exactly as the horizontal analysis of
    that slab alone."""
    jargs, targs, _ = _toy(ngrid=40, vt=1, nmems=10, nobs=5, seed=11)
    for args, pkg in ((jargs, jnp), (targs, torch)):
        cat = jnp.concatenate if pkg is jnp else torch.cat
        full = jnp.full if pkg is jnp else (
            lambda n, v: torch.full((n,), v, dtype=torch.float64))
        args.append(dict(
            bm=cat([args[0], args[0] + 7.0]), bp=cat([args[1], args[1] * 0.8]),
            vert=cat([full(40, 500.0), full(40, 850.0)]),
            obs=args[6]._replace(verts=full(5, 500.0),
                                 vert_radii=full(5, 100.0))))
    jv, tv = jargs.pop(), targs.pop()
    want = jl.letkf_update(jv["bm"], jv["bp"], *jargs[2:6], jv["obs"],
                           ngrid=40, k_obs=5, vertical=True,
                           body_vert=jv["vert"])
    bm, bp, *_ = tl.letkf_update(tv["bm"], tv["bp"], *targs[2:6], tv["obs"],
                                 ngrid=40, k_obs=5, vertical=True,
                                 body_vert=tv["vert"])
    _close(bm, want[0])
    _close(bp, want[1])
    _close(bm[40:], tv["bm"][40:], 1e-12)
    _close(bp[40:], tv["bp"][40:], 1e-12)
    bm_h, bp_h, *_ = _both(jargs, targs, 40, k_obs=5)
    _close(bm[:40], bm_h, 1e-10)
    _close(bp[:40], bp_h, 1e-10)


def _unit(lat, lon):
    la, lo = np.radians(lat), np.radians(lon)
    return np.stack([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo),
                     np.sin(la)], -1)


def test_select_local_obs_matches_f64_oracle_with_ties():
    """Nearest-k selection equals the exact float64 ranking (stable: on a
    tie the lower index) and the JAX package's indices in order, with
    obs duplicated at one location (equal dots) and chunk padding."""
    rng = np.random.default_rng(3)
    npatch, k = 1000, 16
    pxyz = _unit(rng.uniform(-88, 88, npatch), rng.uniform(0, 360, npatch))
    oxyz = _unit(rng.uniform(-88, 88, 300), rng.uniform(0, 360, 300))
    oxyz[rng.integers(0, 300, 40)] = oxyz[rng.integers(0, 300, 40)]
    p32, o32 = pxyz.astype(np.float32), oxyz.astype(np.float32)
    got = tl.select_local_obs(torch.from_numpy(p32), torch.from_numpy(o32),
                              k, chunk=256).numpy()
    want = np.asarray(jl.select_local_obs(jnp.asarray(p32), jnp.asarray(o32),
                                          k, chunk=256))
    np.testing.assert_array_equal(got, want)
    sel = oxyz[got]  # [P, k, 3]: some patch ranks two equal obs
    assert (np.abs(sel[:, :, None] - sel[:, None]).sum(-1) == 0).sum() > \
        npatch * k
    oracle = np.argsort(-(pxyz @ oxyz.T), axis=1, kind="stable")[:, :k]
    assert sum(frozenset(a) != frozenset(b)
               for a, b in zip(got, oracle)) == 0
    d64 = tl.select_local_obs(torch.from_numpy(pxyz), torch.from_numpy(oxyz),
                              k, chunk=300).numpy()
    np.testing.assert_array_equal(d64, np.asarray(jl.select_local_obs(
        jnp.asarray(pxyz), jnp.asarray(oxyz), k, chunk=300)))


def test_top_k_keeps_jax_tie_order():
    """Descending, ties to the lower index, -inf last, -0.0 below +0.0:
    ``jax.lax.top_k``'s order on float32 scores."""
    rng = np.random.default_rng(0)
    x = rng.choice(np.float32([-np.inf, -1.5, -0.0, 0.0, 0.25, 1.0, 3.0]),
                   size=(50, 40)).astype(np.float32)
    for k in (1, 7, 40):
        got = tl._top_k(torch.from_numpy(x), k).numpy()
        want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tl._top_k(torch.from_numpy(x), 9, "approx").numpy(),
        tl._top_k(torch.from_numpy(x), 9).numpy())


def test_chord_dots_are_fp32_products_and_tf32_is_never_enabled():
    """The chord dots are three products and two sums (no matrix product
    TF32 could reach), rounded to float32 like the JAX package's einsum;
    no module of the port turns TF32 on."""
    rng = np.random.default_rng(1)
    p = _unit(rng.uniform(-80, 80, 64), rng.uniform(0, 360, 64))
    o = _unit(rng.uniform(-80, 80, 50), rng.uniform(0, 360, 50))
    got64 = tl._chord_dots(torch.from_numpy(p), torch.from_numpy(o))
    assert got64.dtype == torch.float32
    want = np.asarray(jnp.einsum(
        "pc,oc->po", jnp.asarray(p), jnp.asarray(o),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST))
    np.testing.assert_array_equal(got64.numpy(), want)
    p32, o32 = p.astype(np.float32), o.astype(np.float32)
    by_hand = (p32[:, None, 0] * o32[None, :, 0]
               + p32[:, None, 1] * o32[None, :, 1]
               + p32[:, None, 2] * o32[None, :, 2])
    np.testing.assert_array_equal(
        tl._chord_dots(torch.from_numpy(p32), torch.from_numpy(o32)).numpy(),
        by_hand)
    root = pathlib.Path(tl.__file__).parents[1]
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert "allow_tf32 = True" not in text, path
        assert "set_float32_matmul_precision" not in text, path


def _solve_inputs(seed=2, nobs=30, npatch=23, nmems=8, k=7):
    rng = np.random.default_rng(seed)
    ye = rng.normal(size=(nobs, nmems))
    ye -= ye.mean(1, keepdims=True)
    olat, olon = rng.uniform(30, 60, nobs), rng.uniform(200, 260, nobs)
    plat, plon = rng.uniform(30, 60, npatch), rng.uniform(200, 260, npatch)
    arrays = dict(
        ye=ye, innov=rng.normal(size=nobs), rinv=1.0 / rng.uniform(0.5, 2,
                                                                  nobs),
        obs_xyz=_unit(olat, olon), obs_radii=np.full(nobs, 900.0),
        patch_xyz=_unit(plat, plon))
    idx = np.argsort(-(arrays["patch_xyz"] @ arrays["obs_xyz"].T), axis=1,
                     kind="stable")[:, :k]
    extra = dict(patch_verts=rng.uniform(300, 900, npatch),
                 obs_verts=rng.uniform(300, 900, nobs),
                 obs_vert_radii=np.full(nobs, 250.0),
                 varloc=rng.uniform(0, 1, (3, 2)),
                 obs_var=rng.integers(0, 3, nobs),
                 patch_var=rng.integers(0, 2, npatch))
    return arrays, idx, extra


@pytest.mark.parametrize("mode", ["horizontal", "vertical", "varloc"])
def test_solve_and_apply_patch_weights_match_jax(mode):
    arrays, idx, extra = _solve_inputs()
    kw = {}
    if mode == "vertical":
        kw = {k: extra[k] for k in ("patch_verts", "obs_verts",
                                    "obs_vert_radii")}
    elif mode == "varloc":
        kw = {k: extra[k] for k in ("varloc", "obs_var", "patch_var")}
    args = [arrays[k] for k in ("ye", "innov", "rinv", "obs_xyz",
                                "obs_radii", "patch_xyz")] + [idx]
    for sqrt in ("eigh", "newton_schulz"):
        want = jl.solve_patch_weights(
            *[jnp.asarray(a) for a in args], sqrt_method=sqrt, chunk=5,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        got = tl.solve_patch_weights(
            *[torch.from_numpy(a) for a in args], sqrt_method=sqrt, chunk=5,
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        _close(got.wbar, want.wbar)
        _close(got.transform, want.transform)
        _close(got.transform.sum(-1), np.ones((23, 8)), 1e-10)
    rng = np.random.default_rng(4)
    ngrid = 23 * 3 - 2
    bm, bp = rng.normal(size=2 * ngrid), rng.normal(size=(2 * ngrid, 8))
    want = jl.apply_patch_weights(jnp.asarray(bm), jnp.asarray(bp),
                                  jl.PatchWeights(*(jnp.asarray(_np(x))
                                                    for x in got)),
                                  ngrid=ngrid, patch_size=3)
    res = tl.apply_patch_weights(torch.from_numpy(bm), torch.from_numpy(bp),
                                 got, ngrid=ngrid, patch_size=3)
    for a, b in zip(res, want):
        _close(a, b)


def test_letkf_update_varloc_matches_jax():
    """Cross-variable factors on rho force per-(group, patch) solves."""
    jargs, targs, ngrid = _toy(vt=3, seed=9)
    rng = np.random.default_rng(9)
    vl = rng.uniform(0, 1, (4, 3))
    ob_var = rng.integers(0, 3, 9)
    group_var = np.arange(3)
    for sqrt in ("eigh", "newton_schulz"):
        got = tl.letkf_update(
            *targs, ngrid=ngrid, k_obs=5, patch_size=2, chunk=7,
            sqrt_method=sqrt, varloc=torch.from_numpy(vl),
            ob_var=torch.from_numpy(ob_var),
            group_var=torch.from_numpy(group_var))
        want = jl.letkf_update(
            *jargs, ngrid=ngrid, k_obs=5, patch_size=2, chunk=7,
            sqrt_method=sqrt, varloc=jnp.asarray(vl),
            ob_var=jnp.asarray(ob_var), group_var=jnp.asarray(group_var))
        for i in range(4):
            _close(got[i], want[i])


# ---------------------------------------------------------------------------
# letkf_topk="host": host-certified exact selection
# ---------------------------------------------------------------------------


def _raster(ny=24, nx=36):
    lon, lat = np.meshgrid(np.linspace(0, 350, nx), np.linspace(-80, 80, ny))
    return lat.ravel(), lon.ravel()


def _clustered_obs(rng, nobs=400):
    near = rng.uniform(size=nobs) < 0.9
    return (np.where(near, rng.uniform(40, 50, nobs),
                     rng.uniform(-80, 80, nobs)),
            np.where(near, rng.uniform(100, 110, nobs),
                     rng.uniform(0, 360, nobs)))


def _covers_true_topk(cand, mask, geff, plat, plon, patch, olat, olon, k):
    ngrid = plat.size
    npatch = -(-ngrid // patch)
    gx = _unit(plat, plon)
    pad = npatch * patch - ngrid
    if pad:
        gx = np.concatenate([gx, np.repeat(gx[-1:], pad, axis=0)])
    px = gx.reshape(npatch, patch, 3).mean(1)
    px /= np.linalg.norm(px, axis=-1, keepdims=True)
    ox = _unit(olat, olon)
    for p in range(npatch):
        d = np.linalg.norm(ox - px[p], axis=-1)
        true = set(np.argsort(d, kind="stable")[:min(k, olat.size)])
        assert true <= set(cand[p // geff][mask[p // geff]]), p


@pytest.mark.parametrize("patch,k,chunk", [(1, 8, 64), (4, 16, 96),
                                           (8, 33, 50)])
def test_host_candidates_certificate_covers_true_topk(patch, k, chunk):
    """The copied candidate search gives the JAX package's sets, and they
    cover every patch's brute-force top-k under clustered obs."""
    glat, glon = _raster()
    olat, olon = _clustered_obs(np.random.default_rng(0))
    got = tl.host_select_candidates(glat, glon, glat.size, patch, olat, olon,
                                    k, chunk=chunk)
    want = jl.host_select_candidates(glat, glon, glat.size, patch, olat,
                                     olon, k, chunk=chunk)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    _covers_true_topk(*got, glat, glon, patch, olat, olon, k)


def test_host_candidates_wide_group_fallback():
    """Shuffled rows make every group non-local: per-patch certificates,
    a bounded width, still exact."""
    rng = np.random.default_rng(21)
    glat, glon = rng.uniform(-85, 85, 4096), rng.uniform(0, 360, 4096)
    olat, olon = rng.uniform(-85, 85, 500), rng.uniform(0, 360, 500)
    cand, mask, geff = tl.host_select_candidates(glat, glon, 4096, 4, olat,
                                                 olon, 16, chunk=128)
    assert cand.shape[1] < 500
    _covers_true_topk(cand, mask, geff, glat, glon, 4, olat, olon, 16)


@pytest.mark.parametrize("patch,k,chunk", [(1, 12, 100), (8, 16, 48),
                                           (4, 999, 64)])
def test_host_topk_matches_exact(patch, k, chunk):
    """``letkf_topk="host"`` is exact: the posterior of the device-exact
    selection, and the JAX package's host path, across patch sizes,
    misaligned chunk/group geometry and k > nobs."""
    jstate, jbatch, tstate, tbatch = _pair(ntimes=2, ny=18, nx=26, nmems=10,
                                           seed=11, nobs=35, radius=1100.0)
    outs = {}
    for tk in ("exact", "host"):
        kw = dict(localization="GC", dtype="float64", letkf_patch_size=patch,
                  letkf_k_obs=k, letkf_chunk=chunk, letkf_topk=tk)
        outs[tk] = interop.state_to_numpy(LETKF(
            tstate, tbatch, config=FilterConfig(**kw)).update()[0])
    np.testing.assert_array_equal(outs["exact"], outs["host"])
    jpost, _ = JLETKF(jstate, jbatch, config=JConfig(**kw)).update()
    _close(outs["host"], jpost.data)


# ---------------------------------------------------------------------------
# The LETKF class
# ---------------------------------------------------------------------------


def _pair(nobs=7, seed=1, radius=1500.0, **state_kw):
    jstate = make_demo_state(seed=seed, **state_kw)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=nobs, seed=seed + 1,
                                         radius=radius))
    return (jstate, jbatch) + _to_port(jstate, jbatch)


def _to_port(jstate, jbatch):
    s = jstate.structure
    tstate = EnsembleState(torch.tensor(np.asarray(jstate.data)),
                           StateStructure.build(
                               s.var_names, s.times64(), s.lat, s.lon,
                               s.nmems, var_verts=s.var_verts))
    tbatch = interop.obs_batch_from_numpy(
        {k: getattr(jbatch, k) for k in _BATCH_FIELDS})
    return tstate, tbatch


def _level_pair():
    """``tests/test_vertical_localization.py``'s two-level state (T_500,
    T_850) and one ob at 500 hPa with a 150 hPa vertical radius."""
    rng = np.random.default_rng(4)
    ny, nx, nmems = 6, 8, 12
    lon, lat = np.meshgrid(np.linspace(230.0, 244.0, nx),
                           np.linspace(42.0, 50.0, ny))
    times = (np.datetime64("2026-08-01T00")
             + np.arange(2) * np.timedelta64(6, "h"))
    base = rng.normal(270, 3, (2, ny, nx, nmems))
    data = np.stack([base, base + 15.0])
    jstate = JState(jnp.asarray(data), JStructure.build(
        ("T_500", "T_850"), times, lat, lon, nmems, var_verts=(500.0, 850.0)))
    ob = Observation(value=272.0, obtype="T_500", time=times[0], error=1.0,
                     lat=float(lat[2, 3]), lon=float(lon[2, 3]), vert=500.0,
                     assimilate_this=True, localize_radius=5000.0,
                     vert_localize_radius=150.0)
    return (jstate, JBatch.coerce([ob])) + _to_port(jstate,
                                                    JBatch.coerce([ob]))


def _compare_classes(jstate, jbatch, tstate, tbatch, inflation=None, **kw):
    jpost, jobs = JLETKF(jstate, jbatch, inflation=inflation,
                         config=JConfig(**kw)).update()
    tpost, tobs = LETKF(tstate, tbatch, inflation=inflation,
                        config=FilterConfig(**kw)).update()
    _close(interop.state_to_numpy(tpost), jpost.data)
    jobs.materialize_diagnostics()
    for name in ("prior_mean", "prior_var", "post_mean", "post_var"):
        _close(getattr(tobs, name), getattr(jobs, name))
    np.testing.assert_array_equal(tobs.assimilated, jobs.assimilated)
    return tpost, tobs


def test_letkf_api_update_reduces_variance():
    jstate, jbatch, tstate, tbatch = _pair()
    post, batch = _compare_classes(jstate, jbatch, tstate, tbatch,
                                   inflation=1.05, dtype="float64")
    assert post.data.shape == tstate.data.shape
    assert np.nanmean(batch.post_var) < np.nanmean(batch.prior_var)
    assert batch.assimilated.all()
    assert (np.abs(batch.values - batch.post_mean).mean()
            < np.abs(batch.values - batch.prior_mean).mean())


def test_letkf_matches_ensrf_unlocalized_api():
    """Unlocalized, the LETKF's analysis mean is the EnSRF's (unbiased);
    the covariance too."""
    jstate, jbatch, tstate, tbatch = _pair(nobs=5)
    post_l, _ = _compare_classes(jstate, jbatch, tstate, tbatch,
                                 localization=None, dtype="float64")
    post_e, _ = EnSRF(tstate, tbatch, verbose=False, config=FilterConfig(
        localization=None, dtype="float64", unbiased_variance=True)).update()
    _close(post_l.data.mean(dim=-1), post_e.data.mean(dim=-1))
    xl = post_l.to_vect() - post_l.to_vect().mean(1, keepdim=True)
    xe = post_e.to_vect() - post_e.to_vect().mean(1, keepdim=True)
    _close(xl @ xl.T, xe @ xe.T)


def test_letkf_vertical_api():
    """Vertical localization through the API on a two-level state: the
    JAX package's analysis; the observed level moves, the far one not."""
    jstate, jbatch, tstate, tbatch = _level_pair()
    post, _ = _compare_classes(jstate, jbatch, tstate, tbatch,
                               localization="GC", dtype="float64")
    d = interop.state_to_numpy(post) - tstate.data.numpy()
    assert np.abs(d[0]).max() > 1e-6
    np.testing.assert_allclose(d[1], 0.0, atol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(letkf_patch_size=2, letkf_k_obs=5, letkf_chunk=7, rtps_alpha=0.5,
         outlier_threshold=1.2),
    dict(letkf_k_obs=6, rtpp_alpha=0.3, unbiased_variance=True,
         variable_localization={"T2m:T1_2m": 0.2, "T1_2m:T2m": 0.0}),
    dict(letkf_patch_size=3, letkf_sqrt="eigh", letkf_topk="host",
         letkf_chunk=16),
])
def test_letkf_class_matches_jax(kw):
    """Options through both classes: patches, chunks, RTPS/RTPP, the
    outlier check, unbiased variances, variable localization (per-group
    solves), eigh, and the host selection."""
    jstate, jbatch, tstate, tbatch = _pair(nvars=2, ntimes=2, nobs=11,
                                           seed=6, radius=900.0)
    _compare_classes(jstate, jbatch, tstate, tbatch, inflation=1.1,
                     localization="GC", dtype="float64", **kw)


def test_letkf_topk_and_solve_precision_settings_agree():
    """``letkf_topk="approx"`` and every ``letkf_solve_precision`` run the
    exact selection and true fp64/fp32 solve (the JAX package's CPU
    behaviour; the LETKF has no body kernel, and only those take a lower
    product mode): the analyses are identical.  Unknown values raise."""
    _, _, tstate, tbatch = _pair(ntimes=1, ny=10, nx=10, nmems=12, seed=1,
                                 nobs=15, radius=900.0)
    outs = []
    for topk, sp in (("exact", "default"), ("approx", "default"),
                     ("exact", "high"), ("exact", "highest")):
        cfg = FilterConfig(localization="GC", dtype="float64", letkf_k_obs=8,
                           letkf_chunk=16, letkf_topk=topk,
                           letkf_solve_precision=sp)
        outs.append(LETKF(tstate, tbatch, config=cfg).update()[0].data)
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    for bad in (dict(letkf_topk="bogus"), dict(letkf_solve_precision="low"),
                dict(letkf_sqrt="qr"), dict(letkf_k_obs=0),
                dict(taps_topk="fast")):
        with pytest.raises(ValueError):
            FilterConfig(**bad)


def test_host_topk_cache_reused_across_filters_and_keyed_by_device():
    """A second filter on the same network reuses the host build; a new
    network builds again; another device keeps its own entry."""
    _, _, tstate, tbatch = _pair(ntimes=1, ny=10, nx=12, nmems=10, seed=15,
                                 nobs=12, radius=900.0)
    cfg = FilterConfig(localization="GC", dtype="float64", letkf_k_obs=8,
                       letkf_chunk=16, letkf_topk="host")
    before = tletkf.sel_build_count
    LETKF(tstate, tbatch, config=cfg).update()
    assert tletkf.sel_build_count == before + 1
    LETKF(tstate, tbatch, config=cfg).update()
    assert tletkf.sel_build_count == before + 1
    _, _, _, other = _pair(ntimes=1, ny=10, nx=12, nmems=10, seed=98,
                           nobs=12, radius=900.0)
    LETKF(tstate, other, config=cfg).update()
    assert tletkf.sel_build_count == before + 2
    args = (tstate.structure, tbatch.lats, tbatch.lons, 8, 1, 16)
    cpu = tletkf._host_selection_cached(*args, "cpu")
    assert tletkf.sel_build_count == before + 2
    meta = tletkf._host_selection_cached(*args, "meta")
    assert tletkf.sel_build_count == before + 3
    assert cpu[0].device.type == "cpu" and meta[0].device.type == "meta"


@pytest.mark.parametrize("case", ["host+vertical", "host+varloc", "hybrid",
                                  "matmul_precision"])
def test_letkf_refusals(case):
    if case == "host+vertical":
        _, _, tstate, tbatch = _level_pair()
    else:
        _, _, tstate, tbatch = _pair(nvars=2)
    kw = dict(localization="GC", dtype="float64")
    err, match, extra = {
        "host+vertical": (ValueError, "horizontal-only",
                          dict(letkf_topk="host")),
        "host+varloc": (ValueError, "variable_localization",
                        dict(letkf_topk="host",
                             variable_localization={"T2m:T1_2m": 0.5})),
        "hybrid": (ValueError, "EnSRF solver only",
                   dict(hybrid_alpha=0.5, static_b_sigma=1.0,
                        static_b_length=500.0)),
        # Refused until the product modes were ported; now it runs, and
        # the LETKF (no body kernel) gives the default config's posterior.
        "matmul_precision": (None, None, dict(matmul_precision="bfloat16")),
    }[case]
    if err is None:
        post, _ = LETKF(tstate, tbatch,
                        config=FilterConfig(**kw, **extra)).update()
        ref, _ = LETKF(tstate, tbatch, config=FilterConfig(**kw)).update()
        assert torch.equal(post.data, ref.data)
        return
    with pytest.raises(err, match=match):
        LETKF(tstate, tbatch, config=FilterConfig(**kw, **extra)).update()


def test_letkf_obs_order_hilbert_caller_order_diagnostics():
    """All obs at once: the posterior is the same in any obs order, and
    the diagnostics come back in the caller's order, as in the JAX
    package."""
    jstate, jbatch, tstate, tbatch = _pair(nmems=10, seed=3, nobs=11,
                                           radius=2000.0)
    kw = dict(localization="GC", dtype="float64", letkf_k_obs=8,
              letkf_patch_size=2)
    post, b = LETKF(tstate, tbatch, config=FilterConfig(**kw)).update()
    post_h, b_h = _compare_classes(jstate, jbatch, tstate, tbatch,
                                   obs_order="hilbert", **kw)
    _close(post_h.data, post.data, 1e-10)
    for f in ("prior_mean", "post_mean", "post_var"):
        _close(getattr(b_h, f), getattr(b, f), 1e-9)


@pytest.mark.parametrize("solver", [EnKF, LETKF])
def test_device_cpu_runs_and_the_filter_takes_the_state_device(
        solver, monkeypatch):
    """Without a card the state must be built with ``device="cpu"``; the
    filter then runs there.  A filter's device defaults to its state's,
    whose own default is the card (``tests/test_torch_device.py``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jstate, jbatch = _pair()[:2]
    s = jstate.structure
    data = np.asarray(jstate.data)
    fields = {name: data[i] for i, name in enumerate(s.var_names)}
    coords = {"validtime": s.times64(), "lat": s.lat, "lon": s.lon}
    with pytest.raises(RuntimeError, match='device="cpu"'):
        interop.state_from_numpy(fields, coords)
    state = interop.state_from_numpy(fields, coords, device="cpu")
    tbatch = _to_port(jstate, jbatch)[1]
    filt = solver(state, tbatch, config=FilterConfig(localization="GC"))
    assert filt.device == state.device == torch.device("cpu")
    post, _ = filt.update()
    assert post.data.device.type == "cpu" and torch.isfinite(post.data).all()
    explicit = solver(state, tbatch, device="cpu")
    assert explicit.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# taps_topk
# ---------------------------------------------------------------------------


def test_taps_topk_approx_is_the_exact_search():
    """``taps_topk="approx"`` runs the exact device search: recall 1.0
    (the JAX package asks for 0.99), the same taps as ``"exact"`` and as
    the JAX package's ``"approx"`` on the CPU."""
    jstate = make_demo_state(ntimes=2, ny=7, nx=9, nmems=4, seed=3)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=17, seed=4))
    _, tbatch = _to_port(jstate, jbatch)
    s = jstate.structure
    tstruct = StateStructure.build(s.var_names, s.times64(), s.lat, s.lon,
                                   s.nmems)
    args = (jbatch.lats, jbatch.lons, jbatch.times_s,
            np.zeros(jbatch.nobs, np.int64))
    exact = tfwd.build_taps(tstruct, *args, search="device")
    approx = tfwd.build_taps(tstruct, *args, search="device",
                             topk_method="approx")
    jtaps = jfwd.build_taps(s, *args, search="device", topk_method="approx")
    for t in (approx, exact):
        np.testing.assert_array_equal(t.rows, np.asarray(jtaps.rows))
        np.testing.assert_allclose(t.weights, np.asarray(jtaps.weights),
                                   rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        tfwd.build_taps(tstruct, *args, topk_method="fast")
    post_a, _ = LETKF(*_to_port(jstate, jbatch), config=FilterConfig(
        dtype="float64", taps_topk="approx", taps_search="device")).update()
    post_e, _ = LETKF(*_to_port(jstate, jbatch), config=FilterConfig(
        dtype="float64", taps_search="device")).update()
    assert torch.equal(post_a.data, post_e.data)


# ---------------------------------------------------------------------------
# The LETKF on a mesh (``parallel.sharded.letkf_update_sharded``): the
# mesh cases of ``tests/test_letkf.py``, the port's ``[cpu] * 8`` against
# the JAX package's 8 virtual CPU devices and the port's single device
# ---------------------------------------------------------------------------


def _mesh_case(jstate, jbatch, **kw):
    from test_torch_sharded import assert_mesh_agrees, mesh_runs

    runs = mesh_runs(JLETKF, LETKF, jstate, jbatch,
                     dict(localization="GC", dtype="float64", **kw))
    assert_mesh_agrees(runs)
    return runs


def test_letkf_sharded_matches_single_device():
    """63 grid points over 8 shards: the grid padding path."""
    jstate = make_demo_state(ntimes=2, ny=7, nx=9, nmems=16, seed=9)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=9, seed=10,
                                         radius=1200.0))
    runs = _mesh_case(jstate, jbatch)
    assert np.isfinite(runs[2][1]["post_mean"]).all()


def test_letkf_sharded_obs_solve_issues_no_collectives(monkeypatch):
    """The counterpart of the JAX HLO check: each shard's solve gets its
    own 8 grid points of every group and nothing else, and every copy
    between devices happens before the first shard's solve or after the
    last one's."""
    from efa_xray_tpu_torch.parallel import sharded
    from test_torch_sharded import cpu_mesh

    jstate = make_demo_state(ntimes=2, ny=8, nx=8, nmems=12, seed=12)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=6, seed=13,
                                         radius=1200.0))
    tstate, tbatch = _to_port(jstate, jbatch)
    events = []
    local, to = sharded._letkf_local, sharded._to

    def spy_local(bm, *a, **k):
        events.append(("local", bm.clone()))
        return local(bm, *a, **k)

    def spy_to(x, device):
        events.append(("copy", None))
        return to(x, device)

    monkeypatch.setattr(sharded, "_letkf_local", spy_local)
    monkeypatch.setattr(sharded, "_to", spy_to)
    LETKF(tstate, tbatch, config=FilterConfig(dtype="float64"),
          mesh=cpu_mesh()).update()
    kinds = [k for k, _ in events]
    first = kinds.index("local")
    last = len(kinds) - 1 - kinds[::-1].index("local")
    assert kinds.count("local") == 8
    assert "copy" not in kinds[first:last + 1]
    grid = tstate.data.mean(dim=-1).reshape(2, 64)
    for s, bm in enumerate(b for k, b in events if k == "local"):
        assert bm.shape == (2, 8)
        _close(bm, grid[:, 8 * s:8 * (s + 1)], 0.0)


def test_letkf_vertical_api_and_sharded():
    """The two-level state on a mesh: the observed level updated, the far
    level inert."""
    jstate, jbatch, tstate, _ = _level_pair()
    runs = _mesh_case(jstate, jbatch)
    d = runs[2][0] - tstate.data.numpy()
    st = tstate.structure
    assert np.abs(d[st.var_index("T_500")]).max() > 1e-6
    np.testing.assert_allclose(d[st.var_index("T_850")], 0.0, atol=1e-12)


@pytest.mark.parametrize("topk,precision", [("approx", "default"),
                                            ("exact", "highest")])
def test_letkf_sharded_honors_topk_and_solve_precision(topk, precision):
    jstate = make_demo_state(ntimes=1, ny=8, nx=16, nmems=10, seed=5)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=12, seed=6,
                                         radius=1200.0))
    _mesh_case(jstate, jbatch, letkf_k_obs=6, letkf_chunk=8,
               letkf_topk=topk, letkf_solve_precision=precision)


def test_host_topk_mesh_matches_single_device():
    """``letkf_topk="host"`` on a mesh builds the selection in the
    sharded layout once (its own cache key) and meets the single-device
    and JAX analyses."""
    jstate = make_demo_state(ntimes=1, ny=16, nx=24, nmems=12, seed=13)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=25, seed=14,
                                         radius=1000.0))
    before = tletkf.sel_build_count
    _mesh_case(jstate, jbatch, letkf_patch_size=4, letkf_k_obs=12,
               letkf_chunk=32, letkf_topk="host")
    assert tletkf.sel_build_count == before + 2  # single and sharded
    from efa_xray_tpu.assimilation import letkf as jletkf

    tstate, tbatch = _to_port(jstate, jbatch)
    args = (tbatch.lats, tbatch.lons, 12, 4, 32)
    got = tletkf._host_selection_cached(tstate.structure, *args, "cpu",
                                        ndev=8)
    want = jletkf._host_selection_cached(jstate.structure, *args, ndev=8)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert got[2] == want[2]
