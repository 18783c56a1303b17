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
from efa_xray_tpu_torch.observation.localization import haversine
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


# (label, groups, vertical, fast_geometry, varloc, localize, B4e) and where
# the weights come from on the card: the kernel, a w operand, none.
_WEIGHT_SOURCES = [
    ("exact haversine", 1, False, False, False, True, False, "kernel"),
    ("exact haversine, VT > 1 table", 4, True, False, False, True, False,
     "w"),
    ("exact haversine, VT > 1 without a table", 4, False, False, False,
     True, False, "w"),
    ("B4e", 1, False, False, False, True, True, "kernel"),
    ("B4e, VT > 1 table", 4, True, False, False, True, True, "w"),
    ("fast_geometry", 1, False, True, False, True, False, "w"),
    ("varloc", 1, False, False, True, True, False, "w"),
    ("vertical per row at VT = 1", 1, True, False, False, True, False, "w"),
    ("unlocalized", 4, False, False, False, False, False, "none"),
]


def _block_operands(nvt, vertical, fast_geometry, varloc, localize, enkf,
                    on_card):
    """:func:`ensrf_grid.block_operands` on the first 8 obs of
    :func:`_workload`, given the grid's points as
    :func:`ensrf_grid.points_for_kernel` chooses them on the card (when
    ``on_card``) or on the CPU."""
    prior, ye, lat, lon, obs, bv, ngrid = _workload(nvt=nvt,
                                                    vertical=vertical)
    _, tt = _tail(ye, obs)
    sl = slice(0, 8)
    ye_b = tt.ye[sl]
    kw = dict(localize=localize, fast_geometry=fast_geometry,
              vertical=vertical, ngrid=ngrid, body_vert=_t(bv))
    if vertical:
        kw.update(ob_vert=_t(obs["verts"][sl]),
                  ob_vrad=_t(obs["vert_radii"][sl]))
    if varloc:
        kw["ob_row_factor"] = torch.rand(
            (8, len(prior)), dtype=torch.float64,
            generator=torch.Generator().manual_seed(1))
    if enkf:
        kw["apply_rows"] = ye_b - 0.1
    kw["point_geo"] = ensrf_grid.points_for_kernel(
        _t(lat[:ngrid]), _t(lon[:ngrid]), torch.float64, on_card=on_card,
        localize=localize, fast_geometry=fast_geometry, vertical=vertical,
        vt=nvt, row_factor=varloc)
    args = (_t(lat), _t(lon), ye_b, tt.sqrt_coef[sl], _t(obs["lats"][sl]),
            _t(obs["lons"][sl]), _t(obs["radii"][sl]), len(prior))
    return ensrf_grid.block_operands(*args, **kw), ngrid


@pytest.mark.parametrize("case", _WEIGHT_SOURCES, ids=lambda c: c[0])
def test_b4_weight_source_follows_the_inputs(case):
    """On the card B4 computes its weights for exact haversine on a flat
    state (VT = 1), in B4 and B4e; it reads ``w`` at VT > 1 (where each
    group's CTA would compute them again), for ``fast_geometry``, varloc
    and per-row vertical levels, and nothing unlocalized.  The kernel's
    :class:`Geometry` gives the CPU's weights bit for bit; the table and
    ``ggt`` are the CPU's either way."""
    label, nvt, vertical, fast, varloc, localize, enkf, source = case
    (vt, w, table, ggt), ngrid = _block_operands(
        nvt, vertical, fast, varloc, localize, enkf, on_card=True)
    (vt_c, w_c, table_c, ggt_c), _ = _block_operands(
        nvt, vertical, fast, varloc, localize, enkf, on_card=False)
    assert vt == vt_c == nvt
    got = {ensrf_grid.Geometry: "kernel", type(None): "none"}.get(
        type(w), "w")
    assert got == source
    assert not isinstance(w_c, ensrf_grid.Geometry)
    assert (w_c is None) == (source == "none")
    if source == "kernel":
        assert w.points.shape == (3, ngrid) and w.obs.shape == (4, 8)
        assert torch.equal(ensrf_grid.geometry_weights(*w), w_c)
    elif source == "w":
        assert torch.equal(w, w_c)
    for a, b in ((table, table_c), (ggt, ggt_c)):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def _edge_geometry(dtype):
    """Points and obs at the edges of the haversine and of Gaspari-Cohn:
    the poles, longitudes of +-180 and past 360, obs on grid points, obs
    whose halfwidth puts a point at exactly one and two halfwidths,
    negative and infinite halfwidths, and a padded ob (``blocked_body``'s
    latitude and longitude 0, infinite halfwidth).  Returns ``(lat, lon,
    olat, olon, rad)`` in ``dtype``."""
    rng = np.random.default_rng(11)
    lat = np.concatenate([[90.0, -90.0, 0.0, 45.0, -45.0, 89.9999],
                          rng.uniform(-90.0, 90.0, 61)])
    lon = np.concatenate([[180.0, -180.0, 180.0, -180.0, 540.0, 0.0],
                          rng.uniform(-180.0, 540.0, 61)])
    olat = np.concatenate([[90.0, -90.0, 0.0, 45.0, -45.0, 0.0],
                           lat[10:14], rng.uniform(-90.0, 90.0, 14), [0.0]])
    olon = np.concatenate([[-180.0, 180.0, -180.0, 180.0, 180.0, 179.9999],
                           lon[10:14], rng.uniform(-180.0, 180.0, 14), [0.0]])
    rad = rng.uniform(100.0, 4000.0, len(olat))
    rad[[0, 1, 24]] = np.inf
    rad[[2, 3]] = [-700.0, -np.inf]
    t = lambda x: torch.tensor(x, dtype=dtype)
    lat, lon, olat, olon, rad = map(t, (lat, lon, olat, olon, rad))
    d = haversine((olat[:, None], olon[:, None]), (lat[None, :], lon[None, :]))
    # r = d / |c| at exactly 1 and 2 (c = d, c = d / 2), and -d
    rad[14], rad[15], rad[16], rad[17] = (d[14, 20], d[15, 21] / 2.0,
                                          -d[16, 22], -d[17, 23] / 2.0)
    return lat, lon, olat, olon, rad


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_geometry_weights_equal_the_torch_weights(dtype):
    """The weights from the kernel's geometry operands, op for op in the
    kernel's order (``geometry_weights``), equal ``block_operands``' torch
    weights bit for bit at the edges of :func:`_edge_geometry`, and are 1
    at one and 0 at two halfwidths, 1 for an infinite halfwidth and for
    the padded ob, 1 on an ob's own point."""
    lat, lon, olat, olon, rad = _edge_geometry(dtype)
    b = len(olat)
    ye = torch.zeros((b, 4), dtype=dtype)
    _, want, _, _ = ensrf_grid.block_operands(
        lat, lon, ye, torch.ones(b, dtype=dtype), olat, olon, rad, len(lat))
    geo = ensrf_grid.Geometry(ensrf_grid.point_geometry(lat, lon, dtype),
                              ensrf_grid.point_geometry(olat, olon, dtype, rad))
    got = ensrf_grid.geometry_weights(*geo)
    assert got.dtype == dtype and torch.equal(got, want)
    for j, i in ((14, 20), (16, 22)):  # r = 1: 1 - 0.25 + 0.5 + 0.625 - 5/3
        assert abs(float(got[j, i]) - 5.0 / 24.0) < 1e-6
    assert float(got[15, 21]) == 0.0 and float(got[17, 23]) == 0.0
    assert torch.all(got[[0, 1, 24]] == 1.0)
    assert torch.all(got[[6, 7, 8, 9], [10, 11, 12, 13]] == 1.0)
    # GC's float32 rounding leaves a few 1e-7 below 0 near two halfwidths
    assert torch.all((got > -1e-6) & (got <= 1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sub_blocks_pad_the_geometry_with_no_ops(dtype):
    """Cut into sub-blocks, the geometry keeps each ob's weights bit for
    bit, in the order ``w``'s rows take, and pads with obs of weight 1
    (zero obs: exact no-ops either way)."""
    lat, lon, olat, olon, rad = _edge_geometry(dtype)
    b, g = 24, len(lat)
    geo = ensrf_grid.Geometry(
        ensrf_grid.point_geometry(lat, lon, dtype),
        torch.stack([ensrf_grid.point_geometry(olat[:b], olon[:b], dtype,
                                               rad[:b]),
                     ensrf_grid.point_geometry(olat[1:b + 1], olon[1:b + 1],
                                               dtype, rad[1:b + 1])]))
    w = ensrf_grid.geometry_weights(*geo)
    y = torch.zeros((2, b, 4), dtype=dtype)
    ggt = torch.zeros((2, b, b), dtype=dtype)
    coef = torch.zeros((2, 2, b), dtype=dtype)
    *_, w_sub, _, _ = ensrf_grid.sub_blocks(y, ggt, coef, w, None, None, 16)
    *_, g_sub, _, _ = ensrf_grid.sub_blocks(y, ggt, coef, geo, None, None,
                                            16)
    assert g_sub.obs.shape == (4, 4, 16) and w_sub.shape == (4, 16, g)
    got = ensrf_grid.geometry_weights(*g_sub)
    keep = (torch.arange(4)[:, None] % 2 == 0) | (torch.arange(16) < 8)
    assert torch.equal(got[keep], w_sub[keep])
    assert torch.all(got[~keep] == 1.0) and torch.all(w_sub[~keep] == 0.0)


@pytest.mark.parametrize("nmems,bsz", [(9, 8), (256, 256)])
def test_b4_plain_from_geometry_equals_from_w(nmems, bsz):
    """The plain version fed the kernel's :class:`Geometry` gives the
    result of the plain version fed the torch weights, bit for bit, at
    one block and where the plan sweeps sub-blocks (256 obs at 256
    members)."""
    prior, ye, lat, lon, obs, _, ngrid = _workload(nvt=1, nmems=nmems,
                                                    nobs=bsz)
    bm = prior.mean(1)
    bp = prior - bm[:, None]
    _, tt = _tail(ye, obs)
    assert ensrf_grid.plan(bsz, nmems).sub < bsz or bsz == 8
    args = (_t(lat), _t(lon), tt.ye, tt.sqrt_coef, _t(obs["lats"]),
            _t(obs["lons"]), _t(obs["radii"]), len(bm))
    vt, w, _, ggt = ensrf_grid.block_operands(*args)
    geo = ensrf_grid.Geometry(
        ensrf_grid.point_geometry(_t(lat), _t(lon), torch.float64),
        ensrf_grid.point_geometry(_t(obs["lats"]), _t(obs["lons"]),
                                  torch.float64, _t(obs["radii"]))[None])
    coef = torch.stack([tt.gain_coef, tt.sqrt_coef])[None]
    rest = (None, tt.ye[None], ggt[None], coef, vt)
    want = ensrf_grid.grid_apply_plain(_t(bm), _t(bp), w[None], *rest)
    got = ensrf_grid.grid_apply_plain(_t(bm), _t(bp), geo, *rest)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latitude_alone_puts_a_pair_past_its_support(seed):
    """B4's kernel gives weight 0 without the trigonometry where latitude
    alone puts a pair past two halfwidths (``csrc/ensrf_grid.cu``
    ``gc_haversine``: the cosines' product >= 0, ``|dlat| <= 3``, ``R
    |dlat| >= 2.002 |hw|``, each product rounded once in float32).  The
    torch weights of every such pair are 0, halfwidths within 0.2% of the
    bound included."""
    rng = np.random.default_rng(seed)
    f32 = torch.float32
    lat = rng.uniform(-90.0, 90.0, 4000)
    olat = rng.uniform(-90.0, 90.0, 96)
    near = np.abs(np.deg2rad(lat[rng.integers(0, 4000, 96)] - olat))
    rad = np.concatenate([near[:64] * 6371.0 / 2.0
                          * (1.0 + rng.uniform(-2e-3, 2e-3, 64)),
                          rng.uniform(1.0, 9000.0, 32)])
    t = lambda x: torch.tensor(x, dtype=f32)
    geo = ensrf_grid.Geometry(
        ensrf_grid.point_geometry(t(lat), t(rng.uniform(-180, 540, 4000)),
                                  f32),
        ensrf_grid.point_geometry(t(olat), t(rng.uniform(-180, 180, 96)),
                                  f32, t(rad)))
    w = ensrf_grid.geometry_weights(*geo)
    olat_r, _, ocos, hw = (geo.obs[i, :, None] for i in range(4))
    dlat = (geo.points[0] - olat_r).abs()
    past = ((ocos * geo.points[2] >= 0.0) & (dlat <= 3.0)
            & (dlat * 6371.0 >= hw.abs() * 2.002))
    assert int(past.sum()) > 100_000
    assert torch.all(w[past] == 0.0)
    # the bound is tight: some pairs just inside it keep a weight
    assert bool((w[~past] > 0.0).any())
