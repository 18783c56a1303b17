"""The LETKF with nothing read back inside an update, on the CPU: the
Newton-Schulz exit test as the kernel NS runs it (every iteration up to
the cap launched, each masked by the test on the device) against the JAX
package's ``while_loop``, the kernel's iteration tallies folded in only
when asked, and the host top-k on a mesh whose shards pick different
bundle sizes (one layout for every shard, the exact analysis)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import letkf_core as jl
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu_torch import LETKF, FilterConfig
from efa_xray_tpu_torch.assimilation import letkf as tletkf
from efa_xray_tpu_torch.assimilation import letkf_core as tl
from efa_xray_tpu_torch.ops import newton_schulz
from efa_xray_tpu_torch.parallel import make_mesh
from test_torch_letkf import _close, _jax_ns_iterations, _to_port


def _spd(cond, seed=None, nbatch=5, m=10):
    """The batches of ``test_newton_schulz_exits_where_jax_exits``."""
    rng = np.random.default_rng(int(cond) if seed is None else seed)
    q, _ = np.linalg.qr(rng.normal(size=(nbatch, m, m)))
    ev = np.exp(rng.uniform(0.0, np.log(cond), (nbatch, m)))
    return np.einsum("bij,bj,bkj->bik", q, ev, q)


@pytest.mark.parametrize("cond", [1.0, 30.0, 1e4])
def test_device_exit_newton_schulz_exits_where_jax_exits(cond):
    """The kernel's control flow in torch runs every iteration up to the
    cap and masks each by the test on the device: the same iteration
    count and ``A^{-1/2}``, ``A^{-1}`` as the JAX ``while_loop`` and as the
    plain loop that reads each error back, with no read of its own."""
    amat = _spd(cond)
    tl.reset_counts()
    got = newton_schulz.newton_schulz_device_exit(torch.from_numpy(amat),
                                                  200)
    assert tl.host_syncs == 0 and tl.ns_calls == 0
    assert int(got[2]) == _jax_ns_iterations(amat)
    want = jl._invsqrt_newton_schulz(jnp.asarray(amat), 200)
    plain = tl._invsqrt_newton_schulz_plain(torch.from_numpy(amat), 200)
    assert plain[2] == int(got[2])
    for a, b, c in zip(got[:2], want, plain[:2]):
        _close(a, b)
        _close(a, c)


@pytest.mark.parametrize("cond", [1.0, 30.0, 1e4])
def test_device_exit_equals_the_host_loop_in_float32(cond):
    """In float32 the masked iterations are the host loop's own products:
    the same count and, bit for bit, the same result."""
    amat = torch.from_numpy(_spd(cond).astype(np.float32))
    got = newton_schulz.newton_schulz_device_exit(amat, 30)
    plain = tl._invsqrt_newton_schulz_plain(amat, 30)
    assert int(got[2]) == plain[2]
    for a, b in zip(got[:2], plain[:2]):
        assert torch.equal(a, b)


def test_device_exit_stops_at_the_cap_and_on_nan():
    """A cap below the exit is the cap; a NaN error stops the loop after
    the iteration that made it, as ``err > tol`` fails on NaN."""
    amat = torch.from_numpy(_spd(1e4))
    assert int(newton_schulz.newton_schulz_device_exit(amat, 3)[2]) == 3
    bad = amat.clone()
    bad[0, 0, 0] = float("nan")
    got = newton_schulz.newton_schulz_device_exit(bad, 30)
    plain = tl._invsqrt_newton_schulz_plain(bad, 30)
    assert int(got[2]) == plain[2] == 1


def test_kernel_tallies_fold_in_when_asked():
    """The kernel's iteration counts stay on their device until
    ``ns_counts`` folds them in: summed, and the most in one solve."""
    tl.reset_counts()
    for n in (4, 9, 2):
        t = tl._tally(torch.device("cpu"))
        t[0] += n  # what the kernel's end does on the card
        t[1] = max(int(t[1]), n)
    assert tl.ns_calls == 3 and tl.ns_iterations == 0
    counts = tl.ns_counts()
    assert counts == dict(calls=3, iterations=15, max_iterations=9,
                          host_syncs=0)
    assert tl.ns_counts()["iterations"] == 15  # folded once
    tl.reset_counts()


def test_ns_wrapper_refuses_before_building(monkeypatch):
    """The kernel's wrapper raises on what the kernel does not take
    (float64, CPU tensors; 257 members on the CPU for the device alone)
    without asking for the library; past 136 members the systems run in
    device memory, whose width no shared memory bounds."""
    def no_build():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(newton_schulz._build, "lib", no_build)
    for a in (torch.eye(4, dtype=torch.float64)[None],
              torch.eye(4)[None], torch.eye(257)[None]):
        with pytest.raises(ValueError, match="on a CUDA device"):
            newton_schulz.invsqrt_newton_schulz_cuda(a, 30)
    assert newton_schulz.launches == 0
    assert newton_schulz.smem_bytes(136) <= newton_schulz.MAX_SMEM_BYTES
    assert newton_schulz.smem_bytes(140) > newton_schulz.MAX_SMEM_BYTES


# A grid on which 4 shards' own host selections pick different bundle
# sizes (64, 64, 64 and 4 patches): found by building each shard's
# candidates at these settings.
C4_GRID = dict(ny=20, nx=40, nobs=60, seed=14, k=6, chunk=128)


def _c4_pair():
    g = C4_GRID
    jstate = make_demo_state(ntimes=1, ny=g["ny"], nx=g["nx"], nmems=10,
                             seed=g["seed"])
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=g["nobs"],
                                         seed=g["seed"], radius=800.0))
    return _to_port(jstate, jbatch)


def test_host_topk_mesh_takes_one_group_layout():
    """Over 4 shards whose own picks differ, the sharded host selection
    rebuilds the shards that picked otherwise at the smallest pick, so
    every shard has one layout, and the mesh analysis equals the
    single-device exact top-k."""
    tstate, tbatch = _c4_pair()
    st, g = tstate.structure, C4_GRID
    from efa_xray_tpu_torch.parallel.mesh import pad_to_multiple

    ndev, patch = 4, 1
    glat = np.asarray(st.lat.ravel(), np.float64)
    glon = np.asarray(st.lon.ravel(), np.float64)
    g_local = pad_to_multiple(st.ngrid, ndev * patch) // ndev
    picks = [tl.host_select_candidates(
        glat[s * g_local:(s + 1) * g_local],
        glon[s * g_local:(s + 1) * g_local], g_local, patch, tbatch.lats,
        tbatch.lons, g["k"], chunk=min(g["chunk"], g_local))[2]
        for s in range(ndev)]
    assert len(set(picks)) > 1
    cand, mask, group = tletkf._host_selection_cached(
        st, tbatch.lats, tbatch.lons, g["k"], patch, g["chunk"], "cpu",
        ndev=ndev)
    assert group == min(picks)
    assert cand.shape[0] == ndev * (-(-g_local // g["chunk"])
                                    * g["chunk"] // group)
    kw = dict(localization="GC", dtype="float64", letkf_patch_size=patch,
              letkf_k_obs=g["k"], letkf_chunk=g["chunk"])
    exact, _ = LETKF(tstate, tbatch, config=FilterConfig(**kw)).update()
    host, _ = LETKF(tstate, tbatch, config=FilterConfig(
        **kw, letkf_topk="host"), mesh=make_mesh(["cpu"] * ndev)).update()
    _close(host.data, exact.data.numpy(), 1e-9)
