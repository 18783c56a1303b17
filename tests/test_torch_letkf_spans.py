"""The LETKF route's profiler spans (``utils/profiling.py``): under
``torch.profiler`` one ``efa.route.letkf`` an update, with
``efa.ops.letkf_select`` once a body chunk and once for the obs space and
``efa.ops.letkf_solve`` once a chunk (body and obs), nested in it; the
outputs bit for bit the same with and without the profiler; and with no
profiler the spans are the shared no-op.  Also through ``LETKF.update``
and on a mesh."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from efa_xray_tpu_torch import LETKF, FilterConfig, interop
from efa_xray_tpu_torch.assimilation import letkf_core as tl
from efa_xray_tpu_torch.parallel import make_mesh
from efa_xray_tpu_torch.state.ensemble import EnsembleState
from efa_xray_tpu_torch.observation.observation import ObservationBatch
from efa_xray_tpu_torch.utils import profiling, timeutil

ROUTE, SELECT, SOLVE = ("efa.route.letkf", "efa.ops.letkf_select",
                        "efa.ops.letkf_solve")


def _inputs(npts=600, nobs=70, nmems=10, seed=0):
    rng = np.random.default_rng(seed)
    lat = torch.as_tensor(rng.uniform(-70, 70, npts), dtype=torch.float32)
    lon = torch.as_tensor(rng.uniform(0, 360, npts), dtype=torch.float32)
    bp = torch.as_tensor(rng.normal(0, 3, (npts, nmems)),
                         dtype=torch.float32)
    bp -= bp.mean(1, keepdim=True)
    bm = 280 + torch.as_tensor(rng.normal(0, 1, npts), dtype=torch.float32)
    rows = torch.as_tensor(rng.choice(npts, nobs, replace=False))
    obs = interop.obs_arrays_from_numpy(
        (bm[rows] + 0.5).numpy(), np.ones(nobs), lat[rows].numpy(),
        lon[rows].numpy(), np.full(nobs, 1500.0), np.ones(nobs, bool),
        dtype="float32", device="cpu")
    return bm, bp, rows, lat, lon, obs


def _update(patch, chunk, **kw):
    bm, bp, rows, lat, lon, obs = _inputs(**kw)
    return lambda: tl.letkf_update(bm, bp, bm[rows], bp[rows], lat, lon,
                                   obs, ngrid=lat.shape[0], patch_size=patch,
                                   k_obs=12, chunk=chunk)


def _spans(prof):
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("efa.")
                  and e.device_type() == DeviceType.CPU)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


@pytest.mark.parametrize("patch,chunk,nobs", [(1, 128, 70), (4, 64, 70),
                                              (8, 512, 200)])
def test_one_route_span_and_a_select_and_solve_span_a_chunk(patch, chunk,
                                                            nobs):
    update = _update(patch, chunk, nobs=nobs)
    _, spans = _traced(lambda: (update(), update()))
    routes = [(b, e) for b, e, n in spans if n == ROUTE]
    assert len(routes) == 2
    npatch = -(-600 // patch)
    body = -(-npatch // min(chunk, npatch))
    obs_chunks = -(-nobs // min(chunk, nobs))
    count = lambda name: sum(n == name for _, _, n in spans)
    assert count(SELECT) == 2 * (body + 1)
    assert count(SOLVE) == 2 * (body + obs_chunks)
    assert {n for _, _, n in spans} == {ROUTE, SELECT, SOLVE}
    for b, e, n in spans:
        if n != ROUTE:
            assert sum(b0 <= b and e <= e0 for b0, e0 in routes) == 1, n


def test_outputs_equal_with_and_without_the_profiler():
    update = _update(4, 64)
    plain = update()
    traced, _ = _traced(update)
    for a, b in zip(plain[:4], traced[:4]):
        assert torch.equal(a, b)
    for a, b in zip(plain[4], traced[4]):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


def test_spans_without_a_profiler_are_the_shared_noop(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) constructed")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.annotate(profiling.ROUTE_LETKF) is profiling.annotate(
        profiling.OPS_LETKF_SELECT)
    assert profiling.annotate(profiling.OPS_LETKF_SOLVE) is profiling._NOOP
    _update(8, 64)()


def _api_case(ny=10, nx=20, nmems=8, nobs=25, seed=2):
    rng = np.random.default_rng(seed)
    lat1d = np.linspace(-60.0, 60.0, ny)
    lon1d = np.arange(nx) * (360.0 / nx)
    lon, lat = np.meshgrid(lon1d, lat1d)
    times = np.array([np.datetime64("2020-01-01T00")])
    field = 280.0 + 2.0 * rng.standard_normal((1, ny, nx, nmems))
    state = EnsembleState.from_vardict(
        {"T": field.astype(np.float32)},
        {"validtime": times, "lat": lat, "lon": lon,
         "mem": np.arange(nmems)}, device="cpu")
    batch = ObservationBatch(
        values=280.0 + rng.standard_normal(nobs), errors=np.ones(nobs),
        lats=rng.uniform(-50.0, 50.0, nobs),
        lons=rng.uniform(0.0, 360.0, nobs),
        times_s=timeutil.to_epoch_seconds(np.repeat(times, nobs)),
        obtypes=["T"] * nobs, localize_radius=np.full(nobs, 3000.0),
        assimilate_flags=np.ones(nobs, dtype=bool),
        verts=np.full(nobs, np.nan), descriptions=[None] * nobs)
    return state, batch


@pytest.mark.parametrize("mesh", [None, 2], ids=["single", "mesh2"])
def test_letkf_update_nests_the_route_in_the_entry(mesh):
    """``LETKF.update`` (and each shard of a mesh of 2) records the route
    span inside ``efa.entry.update``, once a shard."""
    state, batch = _api_case()
    config = FilterConfig(letkf_patch_size=2, letkf_k_obs=8, letkf_chunk=16)
    m = None if mesh is None else make_mesh(["cpu"] * mesh)
    _, spans = _traced(lambda: LETKF(state, batch, config=config,
                                     mesh=m).update())
    entry = [(b, e) for b, e, n in spans if n == "efa.entry.update"]
    routes = [(b, e) for b, e, n in spans if n == ROUTE]
    assert len(entry) == 1 and len(routes) == (mesh or 1)
    assert all(entry[0][0] <= b and e <= entry[0][1] for b, e in routes)
    assert any(n == SOLVE for _, _, n in spans)
