"""The tiles and shared-memory layouts of the body kernels' tensor-core
modes (``efa_xray_tpu_torch/csrc/mma_modes.cuh``), on the CPU.

* The tile B2/B2h and B3/B4 pick in each product mode fits the card (227
  KB a CTA, and the CTAs planned per SM with the 1 KB the system keeps
  for each), by the fp32 rule applied to the mode's layout, and the
  modes keep fp32's tiles and CTAs at the shapes the kernels were sized
  on.
* ``smem_bytes`` and ``ctas_per_sm`` mirror ``make_mode_layout`` by hand.
* The mode strides put every fragment load of the modes on distinct
  banks (the layout's claim, checked by listing the lanes' words), and
  ``staged_y`` is Y as the plain versions round it.
* Where a mode's B2 tile differs from fp32's (100 members in blocks of
  128: 64 rows against 32), ``prepare``'s cull bits at that tile equal
  the JAX ``cull_masks`` at it, and the plain body there meets the JAX
  kernel's ``mxu_bf16`` branch in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efa_xray_tpu.assimilation import ensrf_core as jcore
from efa_xray_tpu.ops import ensrf_pallas_fused as jfused
from efa_xray_tpu_torch import interop
from efa_xray_tpu_torch.observation.localization import latlon_to_unit
from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid, precision
from test_torch_ensrf_fused import _jax_obs, _tail, _workload
from test_torch_precision_modes import BF16_GATE

SM_BYTES = 233472  # an SM's shared memory
CTA_RESERVED = 1024  # what the system keeps of it for each CTA
MODES = ("tf32", "bf16")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("bsz,nmems", [(128, 30), (128, 80), (128, 100),
                                       (128, 256), (64, 80), (100, 200)])
def test_b2_mode_tile_fits_the_card(bsz, nmems, hybrid, mode):
    """32 rows where two such CTAs of the mode's layout fit an SM; else
    64, or 32 where 64 overflow; always inside 227 KB."""
    tile = ensrf_fused.pick_tile(bsz, nmems, hybrid, mode)
    smem = lambda t: ensrf_fused.smem_bytes(t, bsz, nmems, hybrid, mode)
    assert smem(tile) <= ensrf_fused.MAX_SMEM_BYTES
    if 2 * (smem(32) + CTA_RESERVED) <= SM_BYTES:
        assert tile == 32
    else:
        assert (tile == 32) == (smem(64) > ensrf_fused.MAX_SMEM_BYTES)


def test_b2_mode_tiles_at_the_measured_shapes():
    """At 80 members in blocks of 128 a mode adds only U's wider rows (128
    x 4 words) to fp32's layout: two CTAs of 32 rows, as in fp32; at 100
    members the wider X and Y rows (108 words for 100) take the second
    CTA and the modes run 64 rows where fp32 runs 32; 256 members: one CTA
    of 32 rows in all."""
    for hybrid in (False, True):
        fp32 = ensrf_fused.smem_bytes(32, 128, 80, hybrid)
        for mode in MODES:
            assert (ensrf_fused.smem_bytes(32, 128, 80, hybrid, mode)
                    == fp32 + 4 * 128 * 4)
            assert ensrf_fused.pick_tile(128, 80, hybrid, mode) == 32
            assert ensrf_fused.pick_tile(128, 256, hybrid, mode) == 32
    assert ensrf_fused.pick_tile(128, 100) == 32
    assert [ensrf_fused.pick_tile(128, 100, False, m) for m in MODES] == [
        64, 64]


def test_b2_mode_layout_by_hand():
    """``make_mode_layout`` of ``csrc/ensrf_fused.cu`` by hand at 32 rows,
    blocks of 128, 256 members in TF32: X and Y rows of 260 words (4 x odd,
    at least 256), U 128 x (32 + 4), the partial sums (16 x 256), the ring
    (2 x 8 x 128), weights, table, geometry, mean and increment, lists.
    84 members: rows of 92 words in TF32 (the staged K is 88) and in bf16
    (96), where fp32 has 84."""
    x, y, u = 32 * 260, 128 * 260 + 64, 128 * 36
    rest = 16 * 256 + 2 * 8 * 128 + 8 * 32 + 8 * 128 + 4 * 32 + 2 * 32 + 32
    for mode in MODES:
        assert (ensrf_fused.smem_bytes(32, 128, 256, False, mode)
                == 4 * (x + y + u + rest))
    assert [precision.mode_row_stride(m, 84) for m in MODES] == [92, 100]
    assert [precision.mode_row_stride(m, 80) for m in MODES] == [84, 84]
    assert [precision.mode_row_stride(m, 30) for m in MODES] == [36, 36]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bsz", [8, 50, 128, 200])
@pytest.mark.parametrize("nmems", [12, 30, 50, 80, 128, 256])
def test_grid_mode_tile_fits_the_card(nmems, bsz, mode):
    """64 points exactly where two CTAs of the mode's layout fit an SM;
    the CTAs planned fit it.  The one shape whose whole block fits no tile,
    200 obs x 256 members in TF32 or bf16, is planned as sub-blocks of 64
    obs at 32 points (the wrapper refused it before)."""
    tile, sub, mslice = ensrf_grid.plan(bsz, nmems, mode)
    smem = ensrf_grid.smem_bytes(tile, sub, mslice, mode)
    ctas = ensrf_grid.ctas_per_sm(tile, sub, mslice, mode)
    assert tile == (64 if ensrf_grid.ctas_per_sm(64, sub, nmems, mode) >= 2
                    else 32)
    if ensrf_grid.smem_bytes(32, bsz, nmems, mode) > ensrf_grid.MAX_SMEM_BYTES:
        assert (bsz, nmems, tile, sub, mslice) == (200, 256, 32, 64, 256)
    else:
        assert (sub, mslice) == (bsz, nmems)
        assert tile == ensrf_grid.pick_tile(bsz, nmems, mode)
    assert smem <= ensrf_grid.MAX_SMEM_BYTES
    assert 1 <= ctas <= 3
    assert ctas * (smem + CTA_RESERVED) <= SM_BYTES


def test_grid_mode_layout_by_hand():
    """``make_mode_layout`` of ``csrc/ensrf_grid.cu`` by hand: the fp32
    layout with U's rows 4 words wider.  Blocks of 128: at 30 members and
    64 points exactly three CTAs fit an SM (76,800 bytes each, with the 1
    KB the system keeps), at 80 members two, as in fp32."""
    for mode in MODES:
        for t, m in ((64, 30), (64, 80), (32, 256)):
            assert (ensrf_grid.smem_bytes(t, 128, m, mode)
                    == ensrf_grid.smem_bytes(t, 128, m) + 4 * 128 * 4)
        assert ensrf_grid.smem_bytes(64, 128, 30, mode) == 76800
        assert [ensrf_grid.pick_tile(128, m, mode) for m in (30, 80)] == [
            64, 64]
        assert [ensrf_grid.ctas_per_sm(64, 128, m, mode)
                for m in (30, 80)] == [3, 2]


def _banks(words):
    return np.asarray(words) % 32


@pytest.mark.parametrize("nmems", [12, 21, 30, 50, 80, 84, 128, 256])
@pytest.mark.parametrize("tile", [32, 64])
def test_mode_fragment_loads_hit_distinct_banks(tile, nmems):
    """Lane (g, t) = (lane / 4, lane % 4) of a warp: the 8 ldmatrix rows of
    a matrix of Y (D0's A, bf16 apply's B) fall on 8 distinct 16-byte bank
    groups; D0's scalar TF32 loads of X (row g, member t), the TF32 apply's
    Y and U loads (obs 2t and 2t + 1, member or row g) and the bf16
    apply's packed U pairs (even row 2t) on 32 distinct banks."""
    g, t = np.divmod(np.arange(32), 4)
    us = precision.u_stride("tf32", tile)
    assert us == precision.u_stride("bf16", tile) == tile + 4
    for mode in MODES:
        ys = precision.mode_row_stride(mode, nmems)
        assert ys >= precision.staged_values(mode, nmems)
        assert len(set((np.arange(8) * ys // 4) % 8)) == 8
        for obs in (2 * t, 2 * t + 1):
            assert len(set(_banks(obs * us + g))) == 32
        if mode == "tf32":
            assert len(set(_banks(g * ys + t))) == 32
            for obs in (2 * t, 2 * t + 1):
                assert len(set(_banks(obs * ys + g))) == 32


def test_staged_y_is_y_as_the_plain_versions_round_it():
    """The wrapper rounds Y once for every CTA: TF32 as float32 of the same
    shape, bf16 as bfloat16 rows padded with zeros to whole k-steps of 16
    (21 members: 32 values), both equal to ``round_inputs``."""
    y = torch.from_numpy(np.random.default_rng(3).normal(
        0, 5, (2, 9, 21)).astype(np.float32))
    t32 = precision.staged_y(y, "tf32")
    assert t32.dtype == torch.float32 and t32.shape == y.shape
    torch.testing.assert_close(t32, precision.round_inputs(y, "tf32"),
                               rtol=0.0, atol=0.0)
    b16 = precision.staged_y(y, "bf16")
    assert b16.dtype == torch.bfloat16 and b16.shape == (2, 9, 32)
    torch.testing.assert_close(b16[..., :21].float(),
                               precision.round_inputs(y, "bf16"),
                               rtol=0.0, atol=0.0)
    assert not b16[..., 21:].any()
    with pytest.raises(ValueError):
        precision.staged_y(y, "ieee")


def _mode_tile_workload():
    """100 members, one block of 128 obs (40 of them real), 500 rows: the
    modes' B2 tile is 64 rows there, fp32's 32."""
    prior, ye, lat, lon, obs, _ = _workload(nstate=500, nmems=100, nobs=40,
                                            seed=13)
    prior, ye = prior.astype(np.float32), ye.astype(np.float32)
    return prior, ye, lat, lon, obs


def test_mode_tile_cull_bits_equal_jax_cull_masks():
    """``prepare(precision=...)`` culls at the mode's tile: its bits are
    the JAX ``cull_masks`` at 64 rows, packed, for both modes."""
    prior, ye, lat, lon, obs = _mode_tile_workload()
    _, tt = _tail(ye.astype(np.float64), obs, True)
    oa = interop.obs_arrays_from_numpy(**obs, device="cpu")
    bp = torch.tensor(prior - prior.mean(1)[:, None], dtype=torch.float64)
    jm, jp = jfused.cull_masks(
        jcore.latlon_to_unit(jnp.asarray(lat), jnp.asarray(lon)),
        jcore.latlon_to_unit(jnp.asarray(obs["lats"]),
                             jnp.asarray(obs["lons"])),
        jnp.asarray(obs["radii"]), jnp.asarray(obs["assim"]), 64, 1, 128)
    packed = (torch.tensor(np.asarray(jp), dtype=torch.int64)
              << torch.arange(16)).sum(-1)
    assert (np.asarray(jp) == 0).any() and (np.asarray(jp) == 1).any()
    for mode in MODES:
        ops = ensrf_fused.prepare(bp, torch.tensor(lat), torch.tensor(lon),
                                  tt, oa, block_size=128, cull=True,
                                  max_radius_km=2000.0, precision=mode)
        assert ops["tile"] == 64
        np.testing.assert_array_equal(ops["bits"].numpy(), packed.numpy())
    assert ensrf_fused.prepare(bp, torch.tensor(lat), torch.tensor(lon), tt,
                               oa, block_size=128, cull=True,
                               max_radius_km=2000.0)["tile"] == 32


def test_plain_body_at_the_mode_tile_matches_jax_mxu_bf16():
    """In float32 at the modes' 64-row tile: the plain body in bf16
    against ``ensrf_blocked_body_pallas_fused(..., mxu_bf16=True)`` in
    interpret mode (at BF16_GATE of the largest increment), and in TF32
    bit for bit the same body with fp32's 32-row cull bits (the cull is
    exact at either tile)."""
    prior, ye, lat, lon, obs = _mode_tile_workload()
    bm = prior.mean(1)
    bp = prior - bm[:, None]
    jt, _ = _tail(ye, obs, True)
    want = jfused.ensrf_blocked_body_pallas_fused(
        jnp.asarray(bm), jnp.asarray(bp), jnp.asarray(lat),
        jnp.asarray(lon), jt, _jax_obs(obs), localize=True, block_size=128,
        tile=64, interpret=True, mxu_bf16=True, max_radius_km=2000.0)
    fields = {k: np.asarray(v, np.float32) for k, v in jt._asdict().items()
              if k != "diags" and v is not None}
    fields.update({k: np.asarray(v, np.float32)
                   for k, v in jt.diags._asdict().items()})
    tt = interop.tail_solution_from_numpy(**fields, dtype="float32",
                                          device="cpu")
    oa = interop.obs_arrays_from_numpy(**obs, dtype="float32", device="cpu")
    args = [torch.from_numpy(np.asarray(x, np.float32))
            for x in (bm, bp, lat, lon)]
    kw = dict(localize=True, block_size=128, max_radius_km=2000.0)
    got = ensrf_fused.fused_body(*args, tt, oa, precision="bf16", **kw)
    for g, w, p in zip(got, want, (bm, bp)):
        inc = np.abs(np.asarray(w) - p).max()
        assert inc > 1e-3
        assert np.abs(g.numpy() - np.asarray(w)).max() <= BF16_GATE * inc
    ops = ensrf_fused.prepare(args[1], args[2], args[3], tt, oa,
                              precision="tf32", **{
                                  k: v for k, v in kw.items()
                                  if k != "localize"})
    bits32 = ensrf_fused.cull_bits(
        latlon_to_unit(args[2], args[3]), latlon_to_unit(oa.lats, oa.lons),
        oa.radii, oa.assim, 32, 1, 128)
    rest = (ops["geom"], ops["y_b"], ops["ggt_b"], ops["tab_b"])
    at64 = ensrf_fused.fused_apply_plain(args[0], args[1], *rest,
                                         ops["bits"], 64, True, False,
                                         ops["series"], precision="tf32")
    at32 = ensrf_fused.fused_apply_plain(args[0], args[1], *rest, bits32,
                                         32, True, False, ops["series"],
                                         precision="tf32")
    for a, b in zip(at64, at32):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0)
