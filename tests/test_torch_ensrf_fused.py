"""B2 parity: the port's plain fused body against the JAX package's Pallas
kernel in interpret mode, in float64 (the CPU counterpart of
``efa_xray_tpu_torch.ops.ensrf_fused``'s CUDA kernel)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import ensrf_core as jcore
from efa_xray_tpu.observation import forward as jfwd
from efa_xray_tpu.observation.observation import ObservationBatch
from efa_xray_tpu.observation.thinning import _hilbert3d_np
from efa_xray_tpu.ops import ensrf_pallas_fused as jfused
from efa_xray_tpu_torch import interop
from efa_xray_tpu_torch.observation.localization import latlon_to_unit
from efa_xray_tpu_torch.ops import ensrf_fused

TOL = 1e-9  # float64, same algebra in another summation order


def _workload(nstate=301, nmems=10, nobs=21, seed=7, vertical=False):
    """Hilbert-ordered scattered rows and obs, mixed radii (some inf),
    some obs not assimilated."""
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
                    else None),
    )
    body_vert = rng.uniform(100, 1000, nstate) if vertical else None
    return prior, ye, lat, lon, obs, body_vert


def _jax_obs(obs):
    return jcore.ObsArrays(**{k: None if v is None else jnp.asarray(v)
                              for k, v in obs.items()})


def _tail(ye, obs, localize):
    tm = ye.mean(1)
    tp = ye - tm[:, None]
    jt = jcore.tail_scan(jnp.asarray(tm), jnp.asarray(tp), _jax_obs(obs),
                         localize=localize, fast_geometry=True)
    fields = {k: np.asarray(v) for k, v in jt._asdict().items()
              if k != "diags" and v is not None}
    fields.update({k: np.asarray(v) for k, v in jt.diags._asdict().items()})
    return jt, interop.tail_solution_from_numpy(**fields, device="cpu")


@pytest.mark.parametrize("localize,cull,max_radius,vertical", [
    (True, True, 2000.0, False),
    (True, True, 6000.0, False),
    (True, False, 2000.0, False),
    (True, False, 6000.0, False),
    (True, True, 2000.0, True),
    (True, True, 6000.0, True),
    (True, False, 6000.0, True),
    (False, False, None, False),
])
def test_b2_plain_matches_pallas_interpret(localize, cull, max_radius,
                                           vertical):
    """Both angle forms (series at <= 5000 km, arccos above), culling on
    and off, vertical localization, and an odd row count (a ragged last
    tile)."""
    prior, ye, lat, lon, obs, body_vert = _workload(vertical=vertical)
    bm = prior.mean(1)
    bp = prior - bm[:, None]
    jt, tt = _tail(ye, obs, localize)
    want = jfused.ensrf_blocked_body_pallas_fused(
        jnp.asarray(bm), jnp.asarray(bp), jnp.asarray(lat), jnp.asarray(lon),
        jt, _jax_obs(obs),
        body_vert=None if body_vert is None else jnp.asarray(body_vert),
        localize=localize, block_size=8, tile=64, interpret=True,
        vertical=vertical, cull=cull, max_radius_km=max_radius)
    got = ensrf_fused.fused_body(
        torch.tensor(bm), torch.tensor(bp), torch.tensor(lat),
        torch.tensor(lon), tt,
        interop.obs_arrays_from_numpy(**obs, device="cpu"),
        body_vert=None if body_vert is None else torch.tensor(body_vert),
        localize=localize, block_size=8, vertical=vertical, cull=cull,
        max_radius_km=max_radius)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL,
                                   atol=TOL)
    assert ensrf_fused.launches == 0  # CPU tensors never reach the kernel


def test_cull_masks_equal_jax_and_pack_into_bits():
    prior, ye, lat, lon, obs, _ = _workload(nstate=500, nobs=40, seed=3)
    tile, bsz = 48, 16
    nblocks = -(-len(obs["values"]) // bsz)
    jm, jp = jfused.cull_masks(
        jcore.latlon_to_unit(jnp.asarray(lat), jnp.asarray(lon)),
        jcore.latlon_to_unit(jnp.asarray(obs["lats"]), jnp.asarray(obs["lons"])),
        jnp.asarray(obs["radii"]), jnp.asarray(obs["assim"]), tile, nblocks,
        bsz)
    bxyz = latlon_to_unit(torch.tensor(lat), torch.tensor(lon))
    oxyz = latlon_to_unit(torch.tensor(obs["lats"]), torch.tensor(obs["lons"]))
    radii = torch.tensor(obs["radii"])
    assim = torch.tensor(obs["assim"])
    tm, tp = ensrf_fused.cull_masks(bxyz, oxyz, radii, assim, tile, nblocks,
                                    bsz)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert (tp == 0).any() and (tp == 1).any()
    bits = ensrf_fused.cull_bits(bxyz, oxyz, radii, assim, tile, nblocks, bsz)
    packed = (tp.to(torch.int64) << torch.arange(tp.shape[2])).sum(-1)
    np.testing.assert_array_equal(bits.numpy(), packed.numpy())


def test_cull_bits_chunked_equals_whole(monkeypatch):
    """The tile-chunked bound (bounded memory at 1e7 rows) gives the same
    bits as one pass."""
    prior, ye, lat, lon, obs, _ = _workload(nstate=600, nobs=40, seed=5)
    args = (latlon_to_unit(torch.tensor(lat), torch.tensor(lon)),
            latlon_to_unit(torch.tensor(obs["lats"]),
                           torch.tensor(obs["lons"])),
            torch.tensor(obs["radii"]), torch.tensor(obs["assim"]), 32, 5, 8)
    whole = ensrf_fused.cull_bits(*args)
    monkeypatch.setattr(ensrf_fused, "_CULL_CHUNK_ELEMS", 3 * 5 * 8)
    chunked = ensrf_fused.cull_bits(*args)
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())


@pytest.mark.parametrize("max_radius,atol", [(None, 1e-6), (900.0, 1e-5)])
def test_b2_on_gridded_state_against_jax_b3(max_radius, atol):
    """B2 on a gridded vt > 1 state, against the JAX package's B3.  The
    public API sends such states to B3 (as the JAX package does), but B2's
    per-row weights serve any row layout; this bounds how far its
    polynomial weights sit from B3's exact chordal form
    (``_arccos_as(dot)`` + ``gaspari_cohn``).  B2's arccos form (no
    radius bound given) is within 2e-8 rad of it, so weights differ by
    ~1e-7 and the posterior by under 1e-6.  B2's series form (radii <=
    5000 km certified) also swaps the GC outer branch for a polynomial fit
    within 2.2e-6 of it (``ensrf_pallas_fused.py:89-94``), which on
    increments of a few K allows 1e-5.  Float64 throughout."""
    state = make_demo_state(ntimes=3, ny=7, nx=9, nmems=14, seed=15)
    obs = ObservationBatch.coerce(make_demo_obs(state, nobs=7, seed=16,
                                                radius=900.0))
    s = state.structure
    taps = jfwd.build_taps(s, obs.lats, obs.lons, obs.times_s,
                           obs.var_indices(s))
    vect = np.asarray(state.to_vect())
    ye = np.asarray(jfwd.apply_taps_obj(jnp.asarray(vect), taps))
    bm = vect.mean(1)
    bp = vect - bm[:, None]
    row_lat, row_lon = s.row_latlon()
    ob = dict(values=obs.values, errors=obs.errors, lats=obs.lats,
              lons=obs.lons, radii=obs.localize_radius,
              assim=obs.assimilate_flags & taps.qc_ok)
    jt, tt = _tail(ye, ob, True)
    want = jfused.ensrf_blocked_body_pallas_fused_grid(
        jnp.asarray(bm), jnp.asarray(bp), jnp.asarray(row_lat),
        jnp.asarray(row_lon), jt, _jax_obs(ob), localize=True, block_size=3,
        tile=48, interpret=True, ngrid=s.ngrid)
    got = ensrf_fused.fused_body(
        torch.tensor(bm), torch.tensor(bp), torch.tensor(row_lat),
        torch.tensor(row_lon), tt,
        interop.obs_arrays_from_numpy(**ob, device="cpu"),
        localize=True, block_size=3, max_radius_km=max_radius)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=atol)


_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "efa_xray_tpu_torch", "csrc", "ensrf_fused.cu")


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("bsz,nmems", [(128, 30), (128, 80), (128, 256),
                                       (64, 80)])
def test_b2_shared_memory_fits_the_card(bsz, nmems, hybrid):
    """The tile the wrapper picks fits the 227 KB a CTA may use.  32 rows
    where an SM holds two such CTAs; else 64 rows (32 if 64 overflow)."""
    tile = ensrf_fused.pick_tile(bsz, nmems, hybrid)
    assert tile in (32, 64)
    assert (ensrf_fused.smem_bytes(tile, bsz, nmems, hybrid)
            <= ensrf_fused.MAX_SMEM_BYTES)
    small = ensrf_fused.smem_bytes(32, bsz, nmems, hybrid)
    if 2 * (small + 1024) <= 233472:
        assert tile == 32
    else:
        assert (tile == 32) == (ensrf_fused.smem_bytes(64, bsz, nmems, hybrid)
                                > ensrf_fused.MAX_SMEM_BYTES)
    # Two CTAs per SM at every size here but 256 members.
    assert (2 * (small + 1024) <= 233472) == (nmems != 256)


def test_b2_shared_memory_mirrors_the_kernel_layout():
    """``make_layout`` of ``csrc/ensrf_fused.cu`` by hand at T 64, B 128,
    M 80: X 64 x 84, Y 128 x 84 + 64, U 128 x 64, 16 x 256 partial sums, a
    ring of 2 x 8 x 128, weights 8 x 64, a table of 8 x 128, geometry 4 x
    64, mean and increment 2 x 64, lists 2 x 16; B2h adds static columns 8
    x 64, three table rows and the sigma row."""
    pure = (64 * 84 + (128 * 84 + 64) + 128 * 64 + 16 * 256
            + 2 * 8 * 128 + 8 * 64 + 8 * 128 + 4 * 64 + 2 * 64 + 32)
    assert ensrf_fused.smem_bytes(64, 128, 80, False) == 4 * pure
    assert ensrf_fused.smem_bytes(64, 128, 80, True) == 4 * (
        pure + 8 * 64 + 3 * 128 + 64)
    # A block of 12 obs is padded to two panels; 30 members to a row
    # stride of 36 words (4 x odd).
    small = (32 * 36 + (16 * 36 + 8) + 16 * 32 + 16 * 256 + 2 * 8 * 16
             + 8 * 32 + 8 * 12 + 4 * 32 + 2 * 32 + 4)
    assert ensrf_fused.smem_bytes(32, 12, 30, False) == 4 * small
    with open(_CU) as f:
        src = f.read()
    assert f"kThreads = {ensrf_fused.THREADS};" in src
    assert f"kPanel = {ensrf_fused.PANEL};" in src
    assert f"kTabPure = {len(ensrf_fused.TABLE_ROWS)};" in src
    assert (f"kTabHybrid = "
            f"{len(ensrf_fused.TABLE_ROWS) + len(ensrf_fused.HYBRID_ROWS)};"
            in src)


def test_b2_plain_is_the_same_at_either_tile_with_the_cull_on():
    """The cull bits are computed at the tile, so another tile changes
    their shape and not the result: tiles of 32 and 64 rows agree with
    each other and with the unculled update."""
    prior, ye, lat, lon, obs, _ = _workload(nstate=333, nobs=40, seed=11)
    bm = torch.tensor(prior.mean(1))
    bp = torch.tensor(prior - prior.mean(1)[:, None])
    _, tt = _tail(ye, obs, True)
    oa = interop.obs_arrays_from_numpy(**obs, device="cpu")
    ops = ensrf_fused.prepare(bp, torch.tensor(lat), torch.tensor(lon), tt,
                              oa, block_size=16, cull=True,
                              max_radius_km=2000.0)
    bxyz = latlon_to_unit(torch.tensor(lat), torch.tensor(lon))
    oxyz = latlon_to_unit(oa.lats, oa.lons)
    out = {}
    for tile in (None, 32, 64):
        bits = None if tile is None else ensrf_fused.cull_bits(
            bxyz, oxyz, oa.radii, oa.assim, tile, ops["y_b"].shape[0], 16)
        if bits is not None:
            assert bits.shape == (-(-333 // tile), ops["y_b"].shape[0])
            assert (bits == 0).any()  # the cull is live
        out[tile] = ensrf_fused.fused_apply_plain(
            bm, bp, ops["geom"], ops["y_b"], ops["ggt_b"], ops["tab_b"],
            bits, tile or 64, True, False, ops["series"])
    for tile in (32, 64):
        for a, b in zip(out[tile], out[None]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL,
                                       atol=TOL)
