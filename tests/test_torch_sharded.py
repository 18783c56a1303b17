"""The port's ``parallel/`` against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices that ``conftest.py`` forces;
the port's mesh is ``[cpu] * 8`` (a device may repeat in a
``parallel.mesh.Mesh``).  Float64, same NumPy inputs: each sharded result
is held at 1e-10 against the JAX package's sharded result and against the
port's single-device one.  Each test of ``tests/test_sharded.py`` has its
counterpart here, plus ``tests/test_inflation.py``'s RTPP on a mesh and
the plain body's hybrid and cross-variable inputs (``KernelRoute.
_body_apply``); the LETKF's, the EnKF's, the hybrid and the cross-variable
mesh cases sit beside their single-device tests, and the 13 dry-run cases
of ``MULTICHIP_r05.json`` in ``tests/test_torch_sharded_dryrun.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import ensrf_core as jcore
from efa_xray_tpu.assimilation.ensrf import EnSRF as JEnSRF
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu.parallel import make_mesh as jmake_mesh
from efa_xray_tpu.parallel.sharded import (
    ensrf_update_sharded as j_ensrf_sharded,
)
from efa_xray_tpu_torch import EnSRF, EnsembleState, FilterConfig, interop
from efa_xray_tpu_torch.assimilation import ensrf as tensrf
from efa_xray_tpu_torch.assimilation import ensrf_core as tcore
from efa_xray_tpu_torch.ops import ensrf_grid, tail_solve
from efa_xray_tpu_torch.parallel import mesh as tmesh
from efa_xray_tpu_torch.parallel import sharded
from efa_xray_tpu_torch.state.structure import StateStructure

TOL = 1e-10
NDEV = 8
_BATCH_FIELDS = ("values", "errors", "lats", "lons", "times_s", "obtypes",
                 "localize_radius", "assimilate_flags", "verts",
                 "descriptions", "vert_radius")
_DIAGS = ("prior_mean", "prior_var", "post_mean", "post_var")


def cpu_mesh(n=NDEV):
    return tmesh.make_mesh(["cpu"] * n)


def to_port(jstate, jbatch):
    """The port's state and batch of a JAX state and batch."""
    s = jstate.structure
    tstate = EnsembleState(torch.tensor(np.asarray(jstate.data)),
                           StateStructure.build(
                               s.var_names, s.times64(), s.lat, s.lon,
                               s.nmems, var_verts=s.var_verts))
    tbatch = interop.obs_batch_from_numpy(
        {k: getattr(jbatch, k) for k in _BATCH_FIELDS})
    return tstate, tbatch


def close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               rtol=tol, atol=tol, err_msg=msg)


def diags(batch):
    if hasattr(batch, "materialize_diagnostics"):
        batch.materialize_diagnostics()
    return {k: np.array(getattr(batch, k)) for k in _DIAGS}


def mesh_runs(jcls, tcls, jstate, jbatch, cfg_kw, **ctor):
    """``(jax mesh, port single, port mesh)``, each ``(posterior data,
    diagnostics)``: the JAX class on its 8-device mesh and the port's
    class on one device and on ``[cpu] * 8``, same config."""
    tstate, tbatch = to_port(jstate, jbatch)
    out = []
    for cls, state, batch, cfg, mesh in (
            (jcls, jstate, jbatch, JConfig(**cfg_kw), jmake_mesh()),
            (tcls, tstate, tbatch, FilterConfig(**cfg_kw), None),
            (tcls, tstate, tbatch, FilterConfig(**cfg_kw), cpu_mesh())):
        post, obs = cls(state, batch, config=cfg, verbose=False, mesh=mesh,
                        **ctor).update()
        out.append((np.array(post.data), diags(obs)))
    return out


def assert_mesh_agrees(runs, tol=TOL):
    """The port's mesh result against the JAX mesh result and against the
    port's single-device one: posterior and diagnostics."""
    (jdata, jd), (tdata, td), (mdata, md) = runs
    close(mdata, jdata, tol, "port mesh vs JAX mesh")
    close(mdata, tdata, tol, "port mesh vs port single device")
    for k in _DIAGS:
        close(md[k], jd[k], tol, k)
        close(md[k], td[k], tol, k)


def _problem(nmems=20, seed=5, ny=7, nx=9):
    """``tests/test_sharded.py``'s problem: nstate = 189, not a multiple
    of 8, so the padding path runs."""
    jstate = make_demo_state(ntimes=3, ny=ny, nx=nx, nmems=nmems, seed=seed)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=11, seed=seed + 1,
                                         radius=900.0))
    return jstate, jbatch


def test_jax_side_has_eight_devices():
    assert len(jax.devices()) == NDEV


@pytest.mark.parametrize("method", ["serial", "blocked"])
def test_sharded_matches_single_device(method):
    jstate, jbatch = _problem()
    assert_mesh_agrees(mesh_runs(
        JEnSRF, EnSRF, jstate, jbatch,
        dict(localization="GC", method=method, dtype="float64")))


def test_sharded_diags_match_single():
    jstate, jbatch = _problem(seed=11)
    runs = mesh_runs(JEnSRF, EnSRF, jstate, jbatch,
                     dict(localization="GC", dtype="float64"))
    assert_mesh_agrees(runs)
    assert np.isfinite(runs[2][1]["post_mean"]).all()


def test_sharded_padding_rows_are_inert():
    """189 rows over 8 shards: 3 pad rows, carrying zero perturbations at
    (0, 0); they never touch a real row (the equality above) and come back
    zero (the driver's own padded output, seen through a spy)."""
    jstate, jbatch = _problem()
    tstate, tbatch = to_port(jstate, jbatch)
    ns = tstate.structure.nstate
    assert ns % NDEV != 0
    seen = []
    orig = sharded._ensrf_local

    def spy(*a, **k):
        out = orig(*a, **k)
        seen.append((out[0].clone(), out[1].clone()))
        return out

    sharded._ensrf_local = spy
    try:
        post, _ = EnSRF(tstate, tbatch, verbose=False, mesh=cpu_mesh(),
                        config=FilterConfig(localization="GC",
                                            dtype="float64")).update()
    finally:
        sharded._ensrf_local = orig
    assert np.isfinite(post.data.numpy()).all()
    pad = NDEV * len(seen[-1][0]) - ns
    assert pad == 3 and len(seen) == NDEV
    torch.testing.assert_close(seen[-1][0][-pad:], torch.zeros(pad,
                               dtype=torch.float64), rtol=0, atol=0)
    assert not seen[-1][1][-pad:].any()


def test_state_shard_placement():
    """``shard`` places the state whole on the mesh's first device;
    ``shard_state_array`` splits it along y (8 rows over 8 devices) as the
    JAX placement does, and the chunks rebuild the state."""
    jstate = make_demo_state(ny=8, nx=8, ntimes=2)
    tstate, _ = to_port(jstate, JBatch.coerce([]))
    placed = tstate.shard(cpu_mesh())
    assert placed.device == torch.device("cpu")
    close(placed.data, np.asarray(jstate.data), 0.0)
    jsharded = jstate.shard(jmake_mesh())
    jshape = jsharded.data.sharding.shard_shape(jsharded.data.shape)
    chunks, axis = tmesh.shard_state_array(tstate.data, cpu_mesh())
    assert axis == 2 and len(chunks) == NDEV
    assert all(tuple(c.shape) == tuple(jshape) for c in chunks)
    close(torch.cat(chunks, dim=axis), np.asarray(jsharded.data), 0.0)
    # no dimension divides 3 devices but the member axis: replication
    whole, axis3 = tmesh.shard_state_array(tstate.data[:1, :1, :2],
                                           cpu_mesh(3))
    assert axis3 is None and all(c.shape == (1, 1, 2, 8, 20) for c in whole)


def _arrays(filt):
    """A JAX filter's formatted prior and obs as NumPy, for both
    packages' drivers."""
    bm, bp, tm, tp = filt.format_prior_state()
    oarr = filt.obs_arrays().with_default_verts()
    lat, lon = filt.prior.structure.row_latlon()
    rows = [np.array(x) for x in (bm, bp, tm, tp, lat, lon)]
    obs = {k: np.array(v) for k, v in oarr._asdict().items()}
    return rows, obs


def _driver_pair(seed, calls, **kw):
    """The port's single-device ``EnSRF.update()`` vectors, then (with
    ``calls`` cleared) ``ensrf_update_sharded`` of both packages on the
    same inputs: the JAX one on its 8-device mesh with its Pallas kernels
    in interpret mode, the port's on ``[cpu] * 8`` along its kernel
    route."""
    jstate, jbatch = _problem(seed=seed)
    cfg = dict(localization="GC", dtype="float64", block_size=8,
               fast_geometry=kw.get("fast_geometry", False))
    tstate, tbatch = to_port(jstate, jbatch)
    single, _ = EnSRF(tstate, tbatch, config=FilterConfig(**cfg),
                      verbose=False).update()
    calls.clear()
    rows, obs = _arrays(JEnSRF(jstate, jbatch, config=JConfig(**cfg),
                               verbose=False))
    jout = j_ensrf_sharded(
        *(jnp.asarray(r) for r in rows),
        jcore.ObsArrays(**{k: jnp.asarray(v) for k, v in obs.items()}),
        mesh=jmake_mesh(), localize=True, method="blocked", block_size=8,
        use_pallas=True, interpret=True, **kw)
    tobs = interop.obs_arrays_from_numpy(**obs, dtype="float64",
                                         device="cpu")
    tout = sharded.ensrf_update_sharded(
        *(torch.from_numpy(r) for r in rows), tobs, mesh=cpu_mesh(),
        localize=True, method="blocked", block_size=8, **kw)
    return jout, tout, single.to_vect()


def _spy(monkeypatch, mod, name, calls):
    fn = getattr(mod, name)

    def wrapped(*a, **k):
        calls.append(name)
        return fn(*a, **k)

    monkeypatch.setattr(mod, name, wrapped)


def test_sharded_pallas_matches_single_device(monkeypatch):
    """The default config's kernel route on every shard (B1 tail, B4
    body; their plain versions on CPU tensors) against the JAX sharded
    Pallas route (B4, interpret mode)."""
    calls = []
    _spy(monkeypatch, ensrf_grid, "blocked_body", calls)
    _spy(monkeypatch, tail_solve, "tail_panel_solve", calls)
    jout, tout, single = _driver_pair(21, calls)
    assert calls.count("blocked_body") == NDEV
    assert calls.count("tail_panel_solve") == 1  # one distinct device
    for i in range(4):
        close(tout[i], jout[i])
    close(tout[0][:, None] + tout[1], single.numpy())


def test_sharded_fused_v4_matches_single_device(monkeypatch):
    """``fast_geometry``: B2 on every shard (the JAX sharded fused
    kernel's route), held against the JAX result and the single-device
    update."""
    calls = []
    _spy(monkeypatch, tensrf, "fused_body", calls)
    jout, tout, single = _driver_pair(23, calls, fast_geometry=True)
    assert calls.count("fused_body") == NDEV
    for i in range(4):
        close(tout[i], jout[i])
    close(tout[0][:, None] + tout[1], single.numpy())


@pytest.mark.parametrize("hybrid", [False, True])
def test_sharded_obs_loop_issues_no_collectives(monkeypatch, hybrid):
    """The counterpart of the JAX HLO check: no shard's solve sees another
    shard's rows, the tail is solved once per distinct device, and every
    copy between devices happens before the first shard's solve or after
    the last one's."""
    jstate, jbatch = _problem(ny=8, nx=8)  # 192 rows: 24 a shard
    tstate, tbatch = to_port(jstate, jbatch)
    kw = (dict(hybrid_alpha=0.5, static_b_sigma=1.5, static_b_length=1000.0)
          if hybrid else {})
    events = []
    orig_local, orig_to = sharded._ensrf_local, sharded._to
    orig_tail = tensrf.KernelRoute._kernel_tail

    def local(solver, route, tail, bm, bp, *rest):
        events.append(("local", bm.clone()))
        return orig_local(solver, route, tail, bm, bp, *rest)

    def to(x, device):
        events.append(("copy", None))
        return orig_to(x, device)

    def tail(self, *a):
        events.append(("tail", None))
        return orig_tail(self, *a)

    monkeypatch.setattr(sharded, "_ensrf_local", local)
    monkeypatch.setattr(sharded, "_to", to)
    monkeypatch.setattr(tensrf.KernelRoute, "_kernel_tail", tail)
    cfg = FilterConfig(localization="GC", dtype="float64", tail_panel=8,
                       block_size=8, **kw)
    filt = EnSRF(tstate, tbatch, config=cfg, verbose=False, mesh=cpu_mesh())
    prior_mean = filt.prior.to_vect().mean(dim=1)
    filt.update()
    kinds = [k for k, _ in events]
    first = kinds.index("local")
    last = len(kinds) - 1 - kinds[::-1].index("local")
    assert kinds.count("local") == NDEV
    assert kinds.count("tail") == 1 and kinds.index("tail") < first
    assert "copy" not in kinds[first:last + 1]
    shards = [bm for k, bm in events if k == "local"]
    for s, bm in enumerate(shards):
        assert bm.shape == (24,)
        close(bm, prior_mean[24 * s:24 * (s + 1)].numpy(), 0.0)


def test_mesh_refuses_explicit_obs_chunk():
    """The sharded driver has no chunked mode: a positive ``obs_chunk``
    with ``mesh=`` raises the JAX package's ValueError, word for word.
    (The JAX package's refusal of more than 131072 obs on a mesh guards a
    TPU worker crash and is not carried over.)"""
    jstate = make_demo_state(nmems=8)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=6, radius=2000.0))
    tstate, tbatch = to_port(jstate, jbatch)
    kw = dict(localization="GC", dtype="float64", obs_chunk=2)
    with pytest.raises(ValueError, match="single-device") as jerr:
        JEnSRF(jstate, jbatch, config=JConfig(**kw), mesh=jmake_mesh(),
               verbose=False).update()
    with pytest.raises(ValueError, match="single-device") as terr:
        EnSRF(tstate, tbatch, config=FilterConfig(**kw), mesh=cpu_mesh(),
              verbose=False).update()
    assert str(terr.value) == str(jerr.value)


def test_rtpp_sharded_matches_single_device():
    """RTPP on a mesh: the prior perturbations are copied before the body
    kernels update them in place (``tests/test_inflation.py``)."""
    jstate = make_demo_state()
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=6, radius=2000.0))
    assert_mesh_agrees(mesh_runs(
        JEnSRF, EnSRF, jstate, jbatch,
        dict(localization="GC", dtype="float64", rtpp_alpha=0.6)))


@pytest.mark.parametrize("fast_geometry", [True, False])
def test_mesh_of_one_device_is_the_single_device_update(fast_geometry):
    """``make_mesh`` over one device on a state of one (var, time) group,
    which the single-device update also runs as flat rows (B2, or B4):
    the update bit for bit."""
    jstate = make_demo_state(ntimes=1, ny=7, nx=9, seed=31)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=11, seed=32,
                                         radius=900.0))
    tstate, tbatch = to_port(jstate, jbatch)
    cfg = FilterConfig(localization="GC", dtype="float64",
                       fast_geometry=fast_geometry)
    one, _ = EnSRF(tstate, tbatch, config=cfg, verbose=False).update()
    mesh1, _ = EnSRF(tstate, tbatch, config=cfg, verbose=False,
                     mesh=tmesh.make_mesh(["cpu"])).update()
    assert torch.equal(one.data, mesh1.data)


def test_make_mesh_defaults_to_the_card(monkeypatch):
    """Without a card and without ``devices``, ``make_mesh`` raises as
    ``default_device`` does; the CPU only when listed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tmesh.make_mesh()
    m = tmesh.make_mesh(["cpu", "cpu"])
    assert m.shape == {"state": 2} and m.distinct_devices() == [
        torch.device("cpu")]
    assert tmesh.pad_to_multiple(189, 8) == 192
    padded = tmesh.pad_rows(torch.ones(5, 3), 8)
    assert padded.shape == (8, 3) and not padded[5:].any()


@pytest.mark.parametrize("extra", ["hybrid", "varloc"])
def test_plain_body_apply_carries_hybrid_and_varloc(extra):
    """``KernelRoute._body_apply`` on the plain route hands the hybrid
    (``body_sigma``, ``static_length``) and cross-variable (``varloc``,
    ``row_var``, ``ob_var``) inputs to ``ensrf_blocked_body``: tail + body
    equals ``ensrf_blocked`` at 1e-10."""
    rng = np.random.default_rng(3)
    ns, m, no = 90, 10, 9
    lat, lon = rng.uniform(-50, 50, ns), rng.uniform(0, 90, ns)
    prior = rng.normal(280, 3, (ns, m))
    rows = rng.integers(0, ns, no)
    ye = prior[rows]
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    bm, bp = t(prior.mean(1)), t(prior - prior.mean(1, keepdims=True))
    tm, tp = t(ye.mean(1)), t(ye - ye.mean(1, keepdims=True))
    obs = interop.obs_arrays_from_numpy(
        ye.mean(1) + rng.normal(0, 1, no), np.ones(no), lat[rows],
        lon[rows], np.full(no, 2500.0), np.ones(no, bool), dtype="float64",
        device="cpu")
    if extra == "hybrid":
        hkw = dict(hybrid_alpha=0.5, body_sigma=t(rng.uniform(1, 3, ns)),
                   tail_sigma=t(rng.uniform(1, 3, no)), static_length=800.0)
        vl = {}
        cfg = FilterConfig(localization="GC", dtype="float64", block_size=4,
                           hybrid_alpha=0.5, static_b_sigma=1.0,
                           static_b_length=800.0)
    else:
        hkw = {}
        vl = dict(varloc=t([[1.0, 0.3], [0.6, 1.0]]),
                  row_var=torch.arange(ns) % 2, ob_var=torch.arange(no) % 2)
        cfg = FilterConfig(localization="GC", dtype="float64", block_size=4,
                           variable_localization={"a:b": 0.3})
    route = tensrf.FlatRoute(cfg, "cpu")
    assert route._route(ns) == "plain"
    tail = route._kernel_tail(tm, tp, obs, False, hkw, vl)
    got = route._body_apply("plain", bm.clone(), bp.clone(), t(lat), t(lon),
                            tail, obs, None, False, hkw, vl)
    want = tcore.ensrf_blocked(bm, bp, tm, tp, t(lat), t(lon), obs,
                               block_size=4, **hkw, **vl)
    close(got[0], want[0].numpy())
    close(got[1], want[1].numpy())
    # without them the body differs: the inputs are not ignored
    bare = route._body_apply("plain", bm.clone(), bp.clone(), t(lat),
                             t(lon), tail, obs, None, False, {}, {})
    assert (bare[1] - want[1]).abs().max() > 1e-6
