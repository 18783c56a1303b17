"""The mesh's schedule (``parallel.sharded``), on the CPU.

The sharded drivers solve the EnSRF's and the EnKF's tail once, on the
mesh's first device, copy it to the other distinct devices, and issue
every shard from the calling thread in mesh order (``run_shards``), with
no synchronize between shards, so that the cards run them at once.  On
the CPU two distinct devices are "cpu" and "cpu:0" (two names of the one
CPU), so that the copies between devices run here.  Checked: the
schedule's order and thread; the drivers on two distinct devices bit for
bit the same shards on one, and against the JAX package's 8-device mesh;
the tail solved once; the tail's copies keep their types; the launch and
sync counters under threads."""

import collections
import sys
import threading

import numpy as np
import pytest
import torch

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation.ensrf import EnSRF as JEnSRF
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu.parallel import make_mesh as jmake_mesh
from efa_xray_tpu_torch import (
    EnKF,
    EnSRF,
    EnsembleState,
    FilterConfig,
    LETKF,
    interop,
)
from efa_xray_tpu_torch.assimilation import enkf, ensrf, letkf_core
from efa_xray_tpu_torch.assimilation import ensrf_core as core
from efa_xray_tpu_torch.ops import (
    ensrf_fused,
    ensrf_grid,
    newton_schulz,
    precision_probe,
    tail_solve,
)
from efa_xray_tpu_torch.parallel import make_mesh, sharded
from efa_xray_tpu_torch.state.structure import StateStructure

TWO = ["cpu", "cpu:0"]  # two distinct devices
_BATCH_FIELDS = ("values", "errors", "lats", "lons", "times_s", "obtypes",
                 "localize_radius", "assimilate_flags", "verts",
                 "descriptions", "vert_radius")


def test_run_shards_issues_every_shard_in_mesh_order_from_the_caller():
    """Shards of interleaved devices run in mesh order, in the calling
    thread, and come back in mesh order."""
    seen = []

    def work(s):
        seen.append((s, threading.current_thread()))
        return 10 * s
    mesh = make_mesh(["cpu", "cpu:0", "cpu", "cpu:0", "cpu"])
    assert sharded.run_shards(mesh, work) == [0, 10, 20, 30, 40]
    assert seen == [(s, threading.current_thread()) for s in range(5)]


def _to_port(jstate, jbatch):
    s = jstate.structure
    tstate = EnsembleState(torch.tensor(np.asarray(jstate.data)),
                           StateStructure.build(
                               s.var_names, s.times64(), s.lat, s.lon,
                               s.nmems, var_verts=s.var_verts))
    tbatch = interop.obs_batch_from_numpy(
        {k: getattr(jbatch, k) for k in _BATCH_FIELDS})
    return tstate, tbatch


def _port_problem(ny=7, nx=9, nmems=12, nobs=11, seed=5):
    """A float64 state on the CPU and its batch (the port's only)."""
    jstate = make_demo_state(ntimes=1, ny=ny, nx=nx, nmems=nmems, seed=seed)
    return _to_port(jstate, JBatch.coerce(make_demo_obs(
        jstate, nobs=nobs, seed=seed + 1, radius=900.0)))


SOLVERS = {
    "ensrf B4": (EnSRF, dict(localization="GC"), {}),
    "ensrf B2": (EnSRF, dict(localization="GC", fast_geometry=True), {}),
    "ensrf serial": (EnSRF, dict(localization="GC", method="serial"), {}),
    "enkf": (EnKF, dict(localization="GC", block_size=4), dict(seed=3)),
    "letkf host": (LETKF, dict(localization="GC", letkf_patch_size=2,
                               letkf_k_obs=6, letkf_chunk=4,
                               letkf_topk="host"), {}),
}


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_distinct_devices_give_one_devices_result_bit_for_bit(name):
    """Each sharded driver on two distinct devices (the tail copied to
    the second) against the same four shards on one device: the
    posterior and the diagnostics are equal bit for bit."""
    cls, cfg_kw, ctor = SOLVERS[name]
    state, batch = _port_problem()
    runs = {}
    for label, devices in (("one", ["cpu"] * 4), ("two", TWO * 2)):
        post, obs = cls(state, batch, config=FilterConfig(**cfg_kw),
                        verbose=False, mesh=make_mesh(devices),
                        **ctor).update()
        runs[label] = (post.data, np.array(obs.post_mean),
                       np.array(obs.post_var))
    assert torch.equal(runs["two"][0], runs["one"][0])
    for i in (1, 2):
        np.testing.assert_array_equal(runs["two"][i], runs["one"][i])


def test_distinct_devices_match_the_jax_mesh():
    """The EnSRF's kernel route (the B1 tail once, B4 shards; their plain
    versions here) on two distinct devices against the JAX package's
    sharded update on its 8 virtual devices, float64 at 1e-10."""
    jstate = make_demo_state(ntimes=3, ny=7, nx=9, nmems=20, seed=5)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=11, seed=6,
                                         radius=900.0))
    kw = dict(localization="GC", dtype="float64")
    jpost, jobs = JEnSRF(jstate, jbatch, config=JConfig(**kw), verbose=False,
                         mesh=jmake_mesh()).update()
    tstate, tbatch = _to_port(jstate, jbatch)
    tpost, tobs = EnSRF(tstate, tbatch, config=FilterConfig(**kw),
                        verbose=False, mesh=make_mesh(TWO * 4)).update()
    np.testing.assert_allclose(tpost.data.numpy(), np.asarray(jpost.data),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.array(tobs.post_var),
                               np.array(jobs.post_var), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("devices", [["cpu"] * 4, TWO * 2],
                         ids=["one device", "two devices"])
def test_the_tail_is_solved_once_per_update(monkeypatch, devices):
    """The EnSRF's and the EnKF's tails are solved once per update, on
    the mesh's first device, however many distinct devices the mesh
    has."""
    calls = collections.Counter()
    # The EnKF's tail is tail_scan_blocked with its draws (eps); the
    # EnSRF's reaches it through _kernel_tail, without.
    for owner, name in ((ensrf.KernelRoute, "_kernel_tail"),
                        (core, "tail_scan_blocked")):
        orig = getattr(owner, name)

        def spy(*a, _orig=orig, _name=name, **k):
            out = _orig(*a, **k)
            if _name == "_kernel_tail" or k.get("eps") is not None:
                calls[_name, str(out.ye.device)] += 1
            return out
        monkeypatch.setattr(owner, name, spy)
    state, batch = _port_problem()
    mesh = make_mesh(devices)
    EnSRF(state, batch, config=FilterConfig(localization="GC"),
          verbose=False, mesh=mesh).update()
    EnKF(state, batch, config=FilterConfig(localization="GC", block_size=4),
         verbose=False, seed=3, mesh=mesh).update()
    assert calls == {("_kernel_tail", "cpu"): 1,
                     ("tail_scan_blocked", "cpu"): 1}


def test_tail_copies_keep_their_types():
    """``_to`` copies a ``TailSolution`` (its diagnostics nested) and the
    EnKF's ``(tail, z)`` field by field, None staying None."""
    state, batch = _port_problem()
    filt = EnSRF(state, batch, config=FilterConfig(localization="GC"),
                 verbose=False)
    _, _, tm, tp = filt.format_prior_state()
    tail = core.tail_scan(tm, tp, filt.obs_arrays())
    for x in (tail, (tail, tail.ye)):
        y = sharded._to(x, torch.device("cpu", 0))
        assert type(y) is type(x)
        flat_x = [v for v in torch.utils._pytree.tree_leaves(x)]
        flat_y = [v for v in torch.utils._pytree.tree_leaves(y)]
        assert len(flat_x) == len(flat_y)
        for a, b in zip(flat_x, flat_y):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)
    assert type(sharded._to(tail, "cpu").diags) is core.ObsDiagnostics
    assert sharded._to(None, "cpu") is None


def _bump_read():
    letkf_core._read(torch.tensor(1.0))


COUNTERS = {
    "B1": (lambda: tail_solve._count("B1"),
           lambda: (tail_solve.launches,)),
    "B1h": (lambda: tail_solve._count("B1h"),
            lambda: (tail_solve.hybrid_launches,)),
    "B1e": (lambda: tail_solve._count("B1e"),
            lambda: (tail_solve.enkf_launches,)),
    "B2e": (ensrf_fused._count_enkf, lambda: (ensrf_fused.enkf_launches,)),
    "B4e": (ensrf_grid._count_enkf, lambda: (ensrf_grid.b4e_launches,)),
    "NS": (lambda: newton_schulz._count(1),
           lambda: (newton_schulz.launches,)),
    "B2": (lambda: ensrf_fused._count(False, "ieee"),
           lambda: (ensrf_fused.launches,
                    ensrf_fused.launches_by_mode["B2"]["ieee"])),
    "B2h": (lambda: ensrf_fused._count(True, "bf16"),
            lambda: (ensrf_fused.hybrid_launches,
                     ensrf_fused.launches_by_mode["B2h"]["bf16"])),
    "B3": (lambda: ensrf_grid._count("B3", "tf32"),
           lambda: (ensrf_grid.b3_launches,
                    ensrf_grid.launches_by_mode["B3"]["tf32"])),
    "B4": (lambda: ensrf_grid._count("B4", "ieee"),
           lambda: (ensrf_grid.b4_launches,
                    ensrf_grid.launches_by_mode["B4"]["ieee"])),
    "B4 weight source": (lambda: ensrf_grid._count_weights("kernel"),
                         lambda: (ensrf_grid.b4_weight_source["kernel"],)),
    "P": (lambda: precision_probe._count("ieee"),
          lambda: (precision_probe.launches,
                   precision_probe.launches_by_mode["ieee"])),
    "newton-schulz": (lambda: letkf_core._count_ns(1),
                      lambda: (letkf_core.ns_calls,
                               letkf_core.ns_iterations)),
    "host syncs": (_bump_read, lambda: (letkf_core.host_syncs,)),
}


@pytest.mark.parametrize("name", sorted(COUNTERS))
def test_counters_stay_exact_under_threads(monkeypatch, name):
    """4 threads bump a counter 10,000 times each, with the interpreter
    switching threads as often as it can: no update is lost."""
    for mod, attrs in (
            (tail_solve, ("launches", "hybrid_launches", "enkf_launches")),
            (ensrf_fused, ("launches", "hybrid_launches", "enkf_launches")),
            (ensrf_grid, ("b3_launches", "b4_launches", "b4e_launches")),
            (precision_probe, ("launches",)),
            (newton_schulz, ("launches",)),
            (letkf_core, ("ns_calls", "ns_iterations", "ns_max_iterations",
                          "host_syncs"))):
        for attr in attrs:
            monkeypatch.setattr(mod, attr, 0)
    for mod in (ensrf_fused, ensrf_grid):
        monkeypatch.setattr(mod, "launches_by_mode", {
            k: dict.fromkeys(v, 0) for k, v in mod.launches_by_mode.items()})
    monkeypatch.setattr(precision_probe, "launches_by_mode",
                        dict.fromkeys(precision_probe.launches_by_mode, 0))
    monkeypatch.setattr(ensrf_grid, "b4_weight_source",
                        dict.fromkeys(ensrf_grid.b4_weight_source, 0))
    bump, read = COUNTERS[name]
    nthreads, reps = 4, 10_000

    def hammer():
        for _ in range(reps):
            bump()
    threads = [threading.Thread(target=hammer) for _ in range(nthreads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert read() == (nthreads * reps,) * len(read())
    if name == "newton-schulz":
        assert letkf_core.ns_max_iterations == 1
