"""Parity at the shapes the card now takes (ROADMAP queue C, fault C5),
float64 on the CPU against the JAX package at 1e-9.

* ``EnSRF``, ``EnKF`` and ``LETKF`` ``.update()`` at 300 members (past the
  256 the kernels took), and the EnSRF at 40 members in blocks of 512 and
  1024 obs (past the block any kernel took at that width), through each
  route the card takes.  On CPU tensors the routes run the kernels' plain
  versions, which follow the plan the card runs (sub-blocks of a block
  that does not fit, member slices): the updates here run in the kernels'
  new orders.
* Those orders forced at small shapes (sub-blocks of 8 obs, slices of 32
  and 64 members; B1's sub-panel order at 300 members): against the JAX
  package at 1e-9 in float64, and against the kernels' former order (the
  whole block, every member at once) in float32 at the f32 gate.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import enkf as jenkf
from efa_xray_tpu.assimilation import ensrf_core as jcore
from efa_xray_tpu.assimilation.ensrf import EnSRF as JEnSRF
from efa_xray_tpu.assimilation.letkf import LETKF as JLETKF
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu.ops import ensrf_pallas_fused as jfused
from efa_xray_tpu_torch import EnKF, EnSRF, FilterConfig, LETKF, interop
from efa_xray_tpu_torch.assimilation import enkf as tenkf
from efa_xray_tpu_torch.observation.localization import latlon_to_unit
from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid, tail_solve
from test_torch_ensrf_fused import _jax_obs, _tail, _workload
from test_torch_varloc import _SPEC, _level_pair

TOL = 1e-9
RTOL, ATOL = 2e-5, 2e-4  # the f32 gate
WIDE = 300
_BATCH_FIELDS = ("values", "errors", "lats", "lons", "times_s", "obtypes",
                 "localize_radius", "assimilate_flags", "verts",
                 "descriptions", "vert_radius")


def _pair(nmems, nobs, seed=5, ny=6, nx=8, radius=900.0):
    """The same state and obs as JAX objects and as port objects."""
    jstate = make_demo_state(ntimes=1, ny=ny, nx=nx, nmems=nmems, seed=seed)
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


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               rtol=tol, atol=tol)


def _same(tpost, tobs, jpost, jobs):
    _close(interop.state_to_numpy(tpost), jpost.data)
    jobs.materialize_diagnostics()
    for name in ("prior_mean", "prior_var", "post_mean", "post_var"):
        _close(getattr(tobs, name), getattr(jobs, name))
    np.testing.assert_array_equal(tobs.assimilated, jobs.assimilated)


def _ensrf(pair, route, **kw):
    """The port's update on ``route`` against the JAX package's: its fused
    kernel's route (interpret mode) where B2's polynomial angle forms run
    (one panel: the tail is the plain serial scan in both), else its
    serial update (the blocked form is exact for any block: the same
    algebra, rounded in another order)."""
    jstate, jbatch, tstate, tbatch = pair
    cfg = dict(localization="GC", dtype="float64", **kw)
    filt = EnSRF(tstate, tbatch, config=FilterConfig(**cfg), verbose=False)
    assert filt._route(tstate.structure.nstate) == route
    tpost, tobs = filt.update()
    jcfg = (dict(cfg, use_pallas=True) if route in ("B2", "B2h")
            else dict(cfg, method="serial"))
    jpost, jobs = JEnSRF(jstate, jbatch, verbose=False,
                         config=JConfig(**jcfg)).update()
    _same(tpost, tobs, jpost, jobs)


@pytest.mark.parametrize("route,kw", [
    ("B4", dict(tail_panel=16)),
    ("B2", dict(fast_geometry=True, block_size=8, tail_panel=512)),
    ("B2h", dict(fast_geometry=True, block_size=8, tail_panel=512,
                 hybrid_alpha=0.5, static_b_sigma=2.0,
                 static_b_length=800.0)),
])
def test_ensrf_at_300_members_matches_jax(route, kw):
    """The default route (B1 + B4, two panels), ``fast_geometry`` (B1 +
    B2) and hybrid (B1h + B2h) at 300 members (the JAX fused kernel's
    interpretation in blocks of 8 obs; B2's sub-blocks and slices are
    held below)."""
    _ensrf(_pair(WIDE, 30), route, **kw)


def test_ensrf_b3_route_with_varloc_at_300_members_matches_jax():
    """The B3 route with cross-variable factors on a gridded state with
    vertical localization, at 300 members."""
    jstate, jbatch, tstate, tbatch = _level_pair(nobs=14, nmems=WIDE)
    cfg = dict(localization="GC", dtype="float64", fast_geometry=True,
               tail_panel=8, variable_localization=_SPEC)
    filt = EnSRF(tstate, tbatch, config=FilterConfig(**cfg), verbose=False)
    assert filt._route(tstate.structure.nstate) == "B3"
    tpost, tobs = filt.update()
    jpost, jobs = JEnSRF(jstate, jbatch, verbose=False, config=JConfig(
        method="serial", **cfg)).update()
    _same(tpost, tobs, jpost, jobs)


@pytest.mark.parametrize("block", [512, 1024])
def test_ensrf_in_wide_blocks_matches_jax(block):
    """Blocks of 512 and 1024 obs through B4 at 40 members (its layout
    holds no block of 1024 at any width: sub-blocks of 256; B2's
    sub-blocks are held below)."""
    _ensrf(_pair(40, 300, radius=1500.0), "B4", block_size=block,
           tail_panel=128)


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's EnKF draws the JAX package's table for its seed."""
    def draw(seed, errors, nmems, scale=True):
        return torch.from_numpy(np.array(jenkf.draw_ob_perturbations(
            jax.random.PRNGKey(seed), jnp.asarray(errors.numpy()), nmems,
            scale=scale)))
    monkeypatch.setattr(tenkf, "draw_ob_perturbations", draw)


def test_enkf_at_300_members_matches_jax(jax_draws):
    """The stochastic EnKF at 300 members with the JAX package's draws
    (the B1e + B4e route, two panels; the JAX package's serial EnKF: the
    blocked form is exact)."""
    jstate, jbatch, tstate, tbatch = _pair(WIDE, 24, seed=8)
    cfg = dict(localization="GC", dtype="float64", tail_panel=16)
    tpost, tobs = EnKF(tstate, tbatch, config=FilterConfig(**cfg),
                       verbose=False, seed=21).update()
    jpost, jobs = jenkf.EnKF(jstate, jbatch, verbose=False, seed=21,
                             config=JConfig(method="serial", **cfg)).update()
    _same(tpost, tobs, jpost, jobs)


def test_letkf_at_300_members_matches_jax():
    """The LETKF at 300 members on a tiny grid (LG's and NS's plain
    versions on the CPU, the Newton-Schulz loop's exit the JAX
    package's)."""
    jstate, jbatch, tstate, tbatch = _pair(WIDE, 12, seed=3)
    cfg = dict(localization="GC", dtype="float64", letkf_patch_size=2,
               letkf_k_obs=6, letkf_chunk=8)
    jpost, jobs = JLETKF(jstate, jbatch, config=JConfig(**cfg)).update()
    tpost, tobs = LETKF(tstate, tbatch, config=FilterConfig(**cfg)).update()
    _same(tpost, tobs, jpost, jobs)


# The kernels' new orders forced at small shapes: (sub-block, member
# slice) of a 70-member body in blocks of 16 obs.
ORDERS = [(8, 70), (16, 32), (8, 32), (16, 64)]


def _b2_case(dtype):
    prior, ye, lat, lon, obs, _ = _workload(nstate=150, nmems=70, nobs=21,
                                            seed=9)
    bm = prior.mean(1)
    bp = prior - bm[:, None]
    jt, tt = _tail(ye, obs, True)
    t = lambda x: torch.tensor(x, dtype=dtype)
    ops = ensrf_fused.prepare(t(bp), t(lat), t(lon), tt,
                              interop.obs_arrays_from_numpy(
                                  **obs, dtype="float64", device="cpu"),
                              block_size=16, max_radius_km=2000.0)
    args = (t(bm), t(bp), ops["geom"], ops["y_b"], ops["ggt_b"],
            ops["tab_b"], ops["bits"], ops["tile"], True, False,
            ops["series"])
    want = jfused.ensrf_blocked_body_pallas_fused(
        jnp.asarray(bm), jnp.asarray(bp), jnp.asarray(lat), jnp.asarray(lon),
        jt, _jax_obs(obs), localize=True, block_size=16, tile=64,
        interpret=True, max_radius_km=2000.0)
    return args, want


def test_b2_orders_match_jax_and_the_former_order():
    """B2's plain version in sub-blocks of ``sub`` obs with D0 summed over
    slices of ``mslice`` members (each of ``ORDERS``): the JAX kernel
    (interpret mode) at 1e-9 in float64, the whole-block order at the f32
    gate in float32."""
    args, want = _b2_case(torch.float64)
    args32, _ = _b2_case(torch.float32)
    former = ensrf_fused.fused_apply_plain(*args32, sub=16, mslice=70)
    for sub, mslice in ORDERS:
        got = ensrf_fused.fused_apply_plain(*args, sub=sub, mslice=mslice)
        for a, b in zip(want, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL,
                                       atol=TOL)
        got = ensrf_fused.fused_apply_plain(*args32, sub=sub, mslice=mslice)
        for a, b in zip(former, got):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL,
                                       atol=ATOL)


def test_grid_orders_match_jax_and_the_former_order():
    """B3's plain version (the grid kernel's, B4's too) in each order of
    ``ORDERS`` on a gridded vt = 3 state: the JAX grid kernel (interpret
    mode) at 1e-9 in float64, the whole-block order at the f32 gate in
    float32."""
    state = make_demo_state(ntimes=3, ny=5, nx=6, nmems=70, seed=15)
    s = state.structure
    jobs = JBatch.coerce(make_demo_obs(state, nobs=21, seed=16,
                                       radius=900.0))
    vect = np.asarray(state.to_vect())
    rng = np.random.default_rng(3)
    rows = rng.integers(0, vect.shape[0], 21)
    ye = vect[rows] + rng.normal(0, 0.5, (21, 70))
    ob = dict(values=jobs.values, errors=jobs.errors, lats=jobs.lats,
              lons=jobs.lons, radii=jobs.localize_radius,
              assim=jobs.assimilate_flags)
    jt, tt = _tail(ye, ob, True)
    bm = vect.mean(1)
    bp = vect - bm[:, None]
    row_lat, row_lon = s.row_latlon()
    want = jfused.ensrf_blocked_body_pallas_fused_grid(
        jnp.asarray(bm), jnp.asarray(bp), jnp.asarray(row_lat),
        jnp.asarray(row_lon), jt, _jax_obs(ob), localize=True,
        block_size=16, tile=48, interpret=True, ngrid=s.ngrid)
    for dtype in (torch.float64, torch.float32):
        t = lambda x: torch.tensor(x, dtype=dtype)
        ops = ensrf_grid.grid_prepare(
            t(bp), None, tt, interop.obs_arrays_from_numpy(
                **ob, dtype="float64", device="cpu"), s.ngrid,
            block_size=16)
        w = ensrf_grid.grid_weights(
            latlon_to_unit(t(row_lat[:s.ngrid]), t(row_lon[:s.ngrid])),
            ops["ob_xyz"], ops["radii"]).reshape(-1, 16, s.ngrid)
        args = (t(bm), t(bp), w, ops["table"], ops["y_b"], ops["ggt_b"],
                ops["coef_b"], ops["vt"])
        former = ensrf_grid.grid_apply_plain(*args, sub=16, mslice=70)
        for sub, mslice in ORDERS:
            got = ensrf_grid.grid_apply_plain(*args, sub=sub, mslice=mslice)
            if dtype == torch.float64:
                for a, b in zip(want, got):
                    np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                               rtol=TOL, atol=TOL)
            else:
                for a, b in zip(former, got):
                    np.testing.assert_allclose(b.numpy(), a.numpy(),
                                               rtol=RTOL, atol=ATOL)


def test_b1_subpanel_order_at_300_members_matches_jax():
    """B1's order (the rank-8 sub-panel updates, the warp's sums over
    chunks of 256 members) at 300 members on a 40-ob panel: the JAX
    package's serial scan at 1e-9 in float64, and the serial plain
    version at the f32 gate in float32."""
    rng = np.random.default_rng(4)
    p, m = 40, WIDE
    lat = rng.uniform(30, 50, p)
    lon = rng.uniform(230, 260, p)
    ye = rng.normal(280, 3, (p, m))
    obs = dict(values=ye.mean(1) + rng.normal(0, 1, p),
               errors=rng.uniform(0.5, 2, p), lats=lat, lons=lon,
               radii=np.full(p, 900.0), assim=rng.random(p) > 0.1)
    tm, tp = ye.mean(1), ye - ye.mean(1, keepdims=True)
    jt = jcore.tail_scan(jnp.asarray(tm), jnp.asarray(tp), _jax_obs(obs),
                         localize=True, fast_geometry=True)
    from efa_xray_tpu_torch.assimilation import ensrf_core as tcore
    for dtype in (torch.float64, torch.float32):
        t = lambda x: torch.tensor(x, dtype=dtype)
        pob = interop.obs_arrays_from_numpy(**obs, dtype="float64",
                                            device="cpu")
        w = tcore.panel_weights(latlon_to_unit(pob.lats, pob.lons), pob,
                                False, dtype)
        args = (t(tm), t(tp), pob.values.to(dtype), pob.errors.to(dtype),
                pob.assim, w)
        got = tail_solve.tail_panel_solve_subpanel_plain(*args)
        if dtype == torch.float64:
            for k, name in enumerate(("tail_mean", "tail_perts", "ye",
                                      "gain_coef", "sqrt_coef")):
                _close(got[k].numpy(), np.asarray(getattr(jt, name)))
        else:
            serial = tail_solve.tail_panel_solve_plain(*args)
            for a, b in zip(serial, got):
                a, b = a.numpy(), b.numpy()
                np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
                np.testing.assert_allclose(b[~np.isnan(b)], a[~np.isnan(a)],
                                           rtol=RTOL, atol=ATOL)
