"""B3 and B4 parity: the port's plain versions against the JAX package's
Pallas kernels in interpret mode, in float64 (the CPU counterparts of the
CUDA kernel in ``efa_xray_tpu_torch/csrc/ensrf_grid.cu``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efa_xray_tpu.assimilation import ensrf_core as jcore
from efa_xray_tpu.ops import ensrf_pallas as jblock
from efa_xray_tpu.ops import ensrf_pallas_fused as jfused
from efa_xray_tpu_torch import interop
from efa_xray_tpu_torch.ops import ensrf_grid

TOL = 1e-9  # float64, same algebra in another summation order


def _workload(nvt=4, ny=5, nx=7, nmems=9, nobs=13, seed=2, vertical=False):
    """``nvt`` groups over a 5 x 7 grid (35 points: no power-of-two tile
    divides it), obs at grid rows, mixed radii (some inf), some obs not
    assimilated.  With ``vertical``: one level per group (per row when
    nvt = 1) and obs with levels and mixed vertical radii."""
    rng = np.random.default_rng(seed)
    lon, lat = np.meshgrid(np.linspace(230, 250, nx), np.linspace(30, 50, ny))
    ngrid = ny * nx
    row_lat = np.tile(lat.ravel(), nvt)
    row_lon = np.tile(lon.ravel(), nvt)
    prior = rng.normal(280, 3, (nvt * ngrid, nmems))
    rows = rng.integers(0, nvt * ngrid, nobs)
    ye = prior[rows] + rng.normal(0, 0.5, (nobs, nmems))
    obs = dict(
        values=ye.mean(1) + rng.normal(0, 1, nobs),
        errors=rng.uniform(0.5, 2.0, nobs),
        lats=row_lat[rows], lons=row_lon[rows],
        radii=np.where(rng.random(nobs) < 0.15, np.inf,
                       rng.uniform(400, 1500, nobs)),
        assim=rng.random(nobs) > 0.15,
    )
    body_vert = None
    if vertical:
        body_vert = (np.repeat(rng.uniform(200, 1000, nvt), ngrid) if nvt > 1
                     else rng.uniform(200, 1000, ngrid))
        obs["verts"] = rng.uniform(200, 1000, nobs)
        obs["vert_radii"] = rng.choice([300.0, np.inf], nobs)
    return prior, ye, row_lat, row_lon, obs, body_vert, ngrid


def _jax_obs(obs):
    return jcore.ObsArrays(**{k: jnp.asarray(v) for k, v in obs.items()})


def _tail(ye, obs):
    """The pre-solved obs sequence, from the JAX tail scan, for both
    packages."""
    tm = ye.mean(1)
    jt = jcore.tail_scan(jnp.asarray(tm), jnp.asarray(ye - tm[:, None]),
                         _jax_obs(obs), localize=True, fast_geometry=True)
    fields = {k: np.asarray(v) for k, v in jt._asdict().items()
              if k != "diags" and v is not None}
    fields.update({k: np.asarray(v) for k, v in jt.diags._asdict().items()})
    return jt, interop.tail_solution_from_numpy(**fields, device="cpu")


def _t(x):
    return None if x is None else torch.tensor(x)


def _assert_pair(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("localize,vertical,group_factor", [
    (True, False, False),
    (True, True, False),
    (True, False, True),
    (True, True, True),
    (False, False, False),
])
def test_b3_plain_matches_pallas_interpret(localize, vertical, group_factor):
    """Vertical table off and on, with and without a cross-variable
    ``group_factor``, unlocalized; a 35-point grid and 13 obs in blocks of
    4 (ragged grid tile, padded last block)."""
    prior, ye, lat, lon, obs, bv, ngrid = _workload(vertical=vertical)
    bm = prior.mean(1)
    bp = prior - bm[:, None]
    gf = (np.random.default_rng(3).uniform(0, 1, (4, len(ye)))
          if group_factor else None)
    jt, tt = _tail(ye, obs)
    want = jfused.ensrf_blocked_body_pallas_fused_grid(
        jnp.asarray(bm), jnp.asarray(bp), jnp.asarray(lat), jnp.asarray(lon),
        jt, _jax_obs(obs), body_vert=None if bv is None else jnp.asarray(bv),
        localize=localize, block_size=4, tile=16, interpret=True,
        vertical=vertical, ngrid=ngrid,
        group_factor=None if gf is None else jnp.asarray(gf))
    got = ensrf_grid.grid_body(
        _t(bm), _t(bp), _t(lat), _t(lon), tt,
        interop.obs_arrays_from_numpy(**obs, device="cpu"), ngrid=ngrid,
        body_vert=_t(bv),
        localize=localize, block_size=4, vertical=vertical,
        group_factor=_t(gf))
    _assert_pair(got, want)
    assert ensrf_grid.b3_launches == 0  # CPU tensors never reach the kernel


def test_b3_weight_chunks_equal_one_pass(monkeypatch):
    """Building the weights and launching over chunks of blocks (the byte
    budget) gives the one-pass result."""
    prior, ye, lat, lon, obs, bv, ngrid = _workload(vertical=True, nobs=21)
    bm = prior.mean(1)
    bp = prior - bm[:, None]
    _, tt = _tail(ye, obs)
    args = (_t(bm), _t(bp), _t(lat), _t(lon), tt,
            interop.obs_arrays_from_numpy(**obs, device="cpu"))
    kw = dict(ngrid=ngrid, body_vert=_t(bv), block_size=4, vertical=True)
    whole = ensrf_grid.grid_body(*args, **kw)
    calls = []
    real = ensrf_grid.grid_apply

    def spy(*a, **k):
        calls.append(a[4].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(ensrf_grid, "grid_apply", spy)
    monkeypatch.setattr(ensrf_grid, "GRID_WEIGHT_BUDGET_BYTES",
                        2 * 4 * ngrid * 8)
    chunked = ensrf_grid.grid_body(*args, **kw)
    assert calls == [2, 2, 2]  # 6 blocks of 4 obs, 2 blocks a chunk
    for a, b in zip(chunked, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


def _block_args(obs, jt, tt, sl):
    """One block's obs fields for the JAX and the port's B4 wrappers."""
    o = {k: np.asarray(v)[sl] for k, v in obs.items()}
    j = dict(ye_block=jt.ye[sl], gain_coef=jt.gain_coef[sl],
             sqrt_coef=jt.sqrt_coef[sl], ob_lat=jnp.asarray(o["lats"]),
             ob_lon=jnp.asarray(o["lons"]), radii=jnp.asarray(o["radii"]))
    t = dict(ye_block=tt.ye[sl], gain_coef=tt.gain_coef[sl],
             sqrt_coef=tt.sqrt_coef[sl], ob_lat=_t(o["lats"]),
             ob_lon=_t(o["lons"]), radii=_t(o["radii"]))
    if "verts" in o:
        j.update(ob_vert=jnp.asarray(o["verts"]),
                 ob_vrad=jnp.asarray(o["vert_radii"]))
        t.update(ob_vert=_t(o["verts"]), ob_vrad=_t(o["vert_radii"]))
    return j, t


@pytest.mark.parametrize("nvt", [1, 4])
@pytest.mark.parametrize("vertical", [False, True])
@pytest.mark.parametrize("fast_geometry", [False, True])
def test_b4_block_plain_matches_pallas_interpret(nvt, vertical,
                                                 fast_geometry):
    """One 8-ob block: vt = 1 (vertical folded into per-row weights) and
    vt = 4 (the [VT, B] table), haversine and chordal weights."""
    prior, ye, lat, lon, obs, bv, ngrid = _workload(nvt=nvt,
                                                    vertical=vertical)
    bm = prior.mean(1)
    bp = prior - bm[:, None]
    jt, tt = _tail(ye, obs)
    jkw, tkw = _block_args(obs, jt, tt, slice(0, 8))
    common = dict(localize=True, fast_geometry=fast_geometry,
                  vertical=vertical, ngrid=ngrid)
    want = jblock.apply_obs_block_pallas(
        jnp.asarray(bm), jnp.asarray(bp), jnp.asarray(lat), jnp.asarray(lon),
        body_vert=None if bv is None else jnp.asarray(bv), tile=16,
        interpret=True, **jkw, **common)
    got = ensrf_grid.apply_obs_block(
        _t(bm), _t(bp), _t(lat), _t(lon), body_vert=_t(bv), **tkw, **common)
    _assert_pair(got, want)
    assert ensrf_grid.b4_launches == 0


@pytest.mark.parametrize("nvt,vertical,fast_geometry,localize", [
    (4, True, False, True),
    (1, True, False, True),
    (4, False, True, True),
    (4, False, False, False),
])
def test_b4_body_plain_matches_pallas_interpret(nvt, vertical, fast_geometry,
                                                localize):
    """The whole body, one B4 launch per block (13 obs in blocks of 4)."""
    prior, ye, lat, lon, obs, bv, ngrid = _workload(nvt=nvt,
                                                    vertical=vertical)
    bm = prior.mean(1)
    bp = prior - bm[:, None]
    jt, tt = _tail(ye, obs)
    common = dict(localize=localize, block_size=4,
                  fast_geometry=fast_geometry, vertical=vertical, ngrid=ngrid)
    want = jblock.ensrf_blocked_body_pallas(
        jnp.asarray(bm), jnp.asarray(bp), jnp.asarray(lat), jnp.asarray(lon),
        jt, _jax_obs(obs), body_vert=None if bv is None else jnp.asarray(bv),
        tile=16, interpret=True, **common)
    got = ensrf_grid.blocked_body(
        _t(bm), _t(bp), _t(lat), _t(lon), tt,
        interop.obs_arrays_from_numpy(**obs, device="cpu"), body_vert=_t(bv),
        **common)
    _assert_pair(got, want)
    assert ensrf_grid.b4_launches == 0


@pytest.mark.parametrize("nmems", [10, 30, 50, 80, 128, 256])
@pytest.mark.parametrize("block_size", [50, 100, 128, 256])
def test_kernel_shapes_fit_shared_memory(block_size, nmems):
    """The tile choice keeps a CTA inside Hopper's 227 KB and inside the
    share of an SM that the planned number of CTAs leaves it, and the
    mirror of the kernel's shared-memory layout counts every buffer.  The
    one shape that no tile holds (256 obs x 256 members: Y alone is 260
    KB) is refused by the launch wrapper with a ValueError."""
    tile = ensrf_grid.pick_tile(block_size, nmems)
    smem = ensrf_grid.smem_bytes(tile, block_size, nmems)
    ys = 4 * (-(-nmems // 4) | 1)
    bp = -(-block_size // 8) * 8
    assert smem == 4 * (
        tile * ys                      # X, rows padded to 4 x odd words
        + bp * ys + 4 * (bp // 8)      # Y, each panel shifted by 4 words
        + bp * tile                    # d0 / u columns
        + 2 * bp * 8                   # two slots of ggt panel columns
        + 2 * 8 * tile                 # two slots of weight panel rows
        + -(-3 * block_size // 4) * 4  # gain, sqrt_coef, table factor
        + tile)                        # mean
    ctas = ensrf_grid.ctas_per_sm(tile, block_size, nmems)
    if (block_size, nmems) == (256, 256):
        assert tile == 32 and ctas == 0 and smem > ensrf_grid.MAX_SMEM_BYTES
        return
    assert tile in (32, 64)
    assert smem <= ensrf_grid.MAX_SMEM_BYTES
    # The CTAs planned for fit an SM, each with the 1 KB the system keeps.
    assert 1 <= ctas <= 3
    assert ctas * (smem + 1024) <= 233472
    # 64 points are taken exactly where two such CTAs fit.
    two_of_64 = 2 * (ensrf_grid.smem_bytes(64, block_size, nmems)
                     + 1024) <= 233472
    assert tile == (64 if two_of_64 else 32)


def test_tile_rule_at_the_measured_shapes():
    """Blocks of 128 obs: three CTAs of 64 points at 30 members, two at
    80, and 256 members, which the kernel's first version refused, in one
    CTA of 32 points."""
    assert (ensrf_grid.pick_tile(128, 30),
            ensrf_grid.ctas_per_sm(64, 128, 30)) == (64, 3)
    assert (ensrf_grid.pick_tile(128, 80),
            ensrf_grid.ctas_per_sm(64, 128, 80)) == (64, 2)
    assert (ensrf_grid.pick_tile(128, 256),
            ensrf_grid.ctas_per_sm(32, 128, 256)) == (32, 1)
    assert ensrf_grid.smem_bytes(32, 128, 256) <= ensrf_grid.MAX_SMEM_BYTES
