"""B1 parity: the port's plain panel solve against the JAX package's Pallas
kernel in interpret mode, in float64 (the CPU counterpart of
``efa_xray_tpu_torch.ops.tail_solve``'s CUDA kernel)."""

import contextlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efa_xray_tpu.assimilation import ensrf_core as jcore
from efa_xray_tpu.ops.tail_solve_pallas import tail_panel_solve_pallas
from efa_xray_tpu_torch.assimilation import ensrf_core as tcore
from efa_xray_tpu_torch.ops import tail_solve

F64 = torch.float64
TOL = 1e-9  # float64, same algebra in another summation order


def _panel(p=16, m=12, seed=0):
    rng = np.random.default_rng(seed)
    ye = rng.normal(280, 3, (p, m))
    tm = ye.mean(1)
    tp = ye - tm[:, None]
    vals = tm + rng.normal(0, 1.5, p)
    errs = rng.uniform(0.5, 2.0, p)
    assim = rng.random(p) > 0.25
    assim[0] = True
    lats = rng.uniform(-60, 60, p)
    lons = rng.uniform(0, 40, p)
    radii = rng.choice([800.0, 3000.0, np.inf], p)
    verts = rng.uniform(100, 1000, p)
    vrad = rng.choice([300.0, np.inf], p)
    return tm, tp, vals, errs, assim, lats, lons, radii, verts, vrad


def _t(x):
    return torch.tensor(np.array(x))


@pytest.mark.parametrize("localize", [True, False])
@pytest.mark.parametrize("unbiased", [False, True])
def test_b1_plain_matches_pallas_interpret(localize, unbiased):
    tm, tp, vals, errs, assim, lats, lons, radii, verts, vrad = _panel()
    xyz = np.asarray(jcore.latlon_to_unit(jnp.asarray(lats), jnp.asarray(lons)))
    w = np.asarray(jcore.chordal_gc_weights(
        jnp.asarray(xyz)[None, :, :], jnp.asarray(xyz)[:, None, :],
        jnp.asarray(radii)[:, None])) if localize else None
    want = tail_panel_solve_pallas(
        jnp.asarray(tm), jnp.asarray(tp), jnp.asarray(vals), jnp.asarray(errs),
        jnp.asarray(assim), None if w is None else jnp.asarray(w),
        localize=localize, unbiased=unbiased, interpret=True)
    got = tail_solve.tail_panel_solve(
        _t(tm), _t(tp), _t(vals), _t(errs), _t(assim),
        None if w is None else _t(w), unbiased=unbiased)
    names = ("tm", "tp", "ye", "gain", "sqrt", "pm", "pv", "om", "ov")
    for name, a, b in zip(names, want, got):
        a = np.asarray(a)
        b = b.numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        np.testing.assert_allclose(b[~np.isnan(b)], a[~np.isnan(a)],
                                   rtol=TOL, atol=TOL, err_msg=name)
    assert tail_solve.launches == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("vertical", [False, True])
def test_panel_weights_match_jax(vertical):
    tm, tp, vals, errs, assim, lats, lons, radii, verts, vrad = _panel(seed=3)
    pob_j = jcore.ObsArrays(*(jnp.asarray(x) for x in
                              (vals, errs, lats, lons, radii, assim, verts,
                               vrad)))
    xyz = jcore.latlon_to_unit(pob_j.lats, pob_j.lons)
    want = jcore.chordal_gc_weights(xyz[None, :, :], xyz[:, None, :],
                                    pob_j.radii[:, None])
    if vertical:
        want = want * jcore.gaspari_cohn(
            jnp.abs(pob_j.verts[:, None] - pob_j.verts[None, :]),
            pob_j.vert_radii[:, None])
    pob_t = tcore.ObsArrays(*(_t(x) for x in
                              (vals, errs, lats, lons, radii, assim, verts,
                               vrad)))
    got = tcore.panel_weights(tcore.latlon_to_unit(pob_t.lats, pob_t.lons),
                              pob_t, vertical, F64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_b1_sizing_takes_every_reference_panel(monkeypatch):
    """The JAX package takes panels up to 1024 obs to its kernel at any
    ensemble; the cluster sizing holds 1024 x 80, 512 x 256 and 1024 x
    256 (B1 and B1h, sub-panels of 8 and 16) within a CTA's shared memory,
    plans 512 x 257 (the shape the kernel refused before) in shared memory
    and 1024 x 512 with its slab in device memory, and the CUDA path
    refuses a panel over 1024 obs before it asks for the library, and
    launches 512 x 257 and 1024 x 512 (the latter with its device ring)."""
    for p, m in ((1024, 80), (512, 256), (1024, 256), (512, 257)):
        for sub in tail_solve.SUBS:
            for hybrid in (False, True):
                c = tail_solve.pick_cluster(p, m, sub, hybrid)
                pp = tail_solve.padded_panel(p, sub, c)
                assert pp == p and c in tail_solve.CLUSTERS
                assert not tail_solve.in_device_memory(pp, m, sub, c, hybrid)
                assert (tail_solve.smem_bytes(pp // c, m, sub, hybrid)
                        <= tail_solve.MAX_SMEM_BYTES)
    assert tail_solve.smem_bytes(1024, 80) > tail_solve.MAX_SMEM_BYTES
    assert tail_solve.pick_cluster(1024, 80) > 1
    c = tail_solve.pick_cluster(1024, 512)
    assert c == tail_solve.CLUSTERS[-1]
    assert tail_solve.in_device_memory(1024, 512, 8, c)
    assert (tail_solve.smem_bytes(1024 // c, 512, device_slab=True)
            <= tail_solve.MAX_SMEM_BYTES)

    def no_build():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(tail_solve._build, "lib", no_build)
    x = torch.zeros(1025, 80)
    with pytest.raises(ValueError, match="B1 takes"):
        tail_solve.tail_panel_solve_cuda(x[:, 0], x, x[:, 0], x[:, 0],
                                         x[:, 0] > 0)
    assert tail_solve.launches == 0
    # The wrapper's path past its checks, on a library that records.
    calls = []

    class Library:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(tail_solve._build, "lib", lambda: Library())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=None))
    monkeypatch.setattr(tail_solve, "launches", 0)
    for p, m, ring in ((512, 257, False), (1024, 512, True)):
        x = torch.zeros(p, m)
        out = tail_solve.tail_panel_solve_cuda(x[:, 0], x, x[:, 0],
                                               x[:, 0], x[:, 0] > 0)
        (name, args), = calls[-1:]
        assert name == "efa_tail_launch" and args[11:16] == (p, m, 0, 8, 8)
        assert (args[9] is not None) == ring
        assert tuple(out[1].shape) == (p, m)
    assert tail_solve.launches == 2
