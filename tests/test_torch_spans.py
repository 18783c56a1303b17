"""The port's own profiler spans (``utils/profiling.py``): each layer
boundary of an ``EnSRF.update()`` and a ``FlatRoute.solve`` is recorded
under ``torch.profiler``, nested in its update; the counts the spans carry
(taps builds, tail panels); and with no profiler a span is a shared no-op
that changes nothing."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from efa_xray_tpu_torch import EnSRF, FilterConfig
from efa_xray_tpu_torch.assimilation.ensrf import FlatRoute
from efa_xray_tpu_torch.assimilation.ensrf_core import ObsArrays
from efa_xray_tpu_torch.observation.observation import ObservationBatch
from efa_xray_tpu_torch.state.ensemble import EnsembleState
from efa_xray_tpu_torch.utils import profiling, timeutil

NY, NX, NMEMS = 12, 24, 8
ENTRY = ("efa.entry.init", "efa.entry.update", "efa.entry.format_prior",
         "efa.entry.obs_arrays", "efa.entry.outlier_check",
         "efa.entry.diagnostics", "efa.entry.inflation",
         "efa.entry.format_posterior")
OBS = ("efa.obs.taps", "efa.obs.taps_build", "efa.obs.priors")
ROUTE = ("efa.route.solve", "efa.route.tail", "efa.route.tail_panel",
         "efa.route.body")
# The operands each body route builds: B4's per block (exact haversine),
# B2's once (fast geometry); the panel weights on both.
OPS = {False: ("efa.ops.panel_weights", "efa.ops.block_operands"),
       True: ("efa.ops.panel_weights", "efa.ops.prepare")}


def _state(seed=0):
    rng = np.random.default_rng(seed)
    lat1d = np.linspace(-80.0, 80.0, NY)
    lon1d = np.arange(NX) * (360.0 / NX)
    lon, lat = np.meshgrid(lon1d, lat1d)
    times = np.array([np.datetime64("2020-01-01T00")])
    field = 280.0 + 2.0 * rng.standard_normal((1, NY, NX, NMEMS))
    return EnsembleState.from_vardict(
        {"T": field.astype(np.float32)},
        {"validtime": times, "lat": lat, "lon": lon,
         "mem": np.arange(NMEMS)}, device="cpu"), times


def _batch(times, nobs, seed=1):
    rng = np.random.default_rng(seed)
    return ObservationBatch(
        values=280.0 + rng.standard_normal(nobs),
        errors=np.ones(nobs), lats=rng.uniform(-70.0, 70.0, nobs),
        lons=rng.uniform(0.0, 360.0, nobs),
        times_s=timeutil.to_epoch_seconds(np.repeat(times, nobs)),
        obtypes=["T"] * nobs, localize_radius=np.full(nobs, 3000.0),
        assimilate_flags=np.ones(nobs, dtype=bool),
        verts=np.full(nobs, np.nan), descriptions=[None] * nobs)


def _config(fast, panel=8):
    return FilterConfig(localization="GC", fast_geometry=fast, block_size=8,
                        tail_panel=panel)


def _spans(prof):
    """``[(start_ns, end_ns, name)]`` of the port's spans, in start order."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("efa.")
                  and e.device_type() == DeviceType.CPU)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _nested_in(spans, roots):
    """Every span not in ``roots`` (and not the constructor's) lies inside
    a span named in ``roots``."""
    outer = [(b, e) for b, e, n in spans if n in roots]
    return all(any(b0 <= b and e <= e0 for b0, e0 in outer)
               for b, e, n in spans
               if n not in roots and n != "efa.entry.init")


def _flat_solve(fast, nobs, panel=8):
    state, times = _state()
    batch = _batch(times, nobs)
    lat, lon = state.structure.row_latlon_device(torch.float32, "cpu")
    vect = state.to_vect()
    bm = vect.mean(1)
    bp = vect - bm[:, None]
    rows = torch.randint(0, vect.shape[0], (nobs,),
                         generator=torch.Generator().manual_seed(3))
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
    obs = ObsArrays(values=f(batch.values), errors=f(batch.errors),
                    lats=f(batch.lats), lons=f(batch.lons),
                    radii=f(batch.localize_radius),
                    assim=torch.ones(nobs, dtype=torch.bool))
    route = FlatRoute(_config(fast, panel), "cpu", max_radius_km=3000.0)
    return lambda: route.solve(bm.clone(), bp.clone(), bm[rows].clone(),
                               bp[rows].clone(), lat, lon, obs)


@pytest.mark.parametrize("fast", [False, True], ids=["B4", "B2"])
def test_update_records_each_layer_span_nested_in_it(fast):
    state, times = _state()
    batch = _batch(times, 30)
    _, spans = _traced(lambda: EnSRF(state, batch, config=_config(fast),
                                     verbose=False).update())
    names = {n for _, _, n in spans}
    assert set(ENTRY + OBS + ROUTE + OPS[fast]) <= names
    assert _nested_in(spans, ("efa.entry.update",))


@pytest.mark.parametrize("fast", [False, True], ids=["B4", "B2"])
def test_flat_solve_records_route_and_ops_spans_nested_in_it(fast):
    _, spans = _traced(_flat_solve(fast, 30))
    names = {n for _, _, n in spans}
    assert set(ROUTE + OPS[fast]) <= names
    assert not any(n.startswith(("efa.entry.", "efa.obs.")) for n in names)
    assert _nested_in(spans, ("efa.route.solve",))


def test_taps_build_span_only_on_a_cache_miss():
    state, times = _state()
    batch = _batch(times, 30)
    update = lambda: EnSRF(state, batch, config=_config(False),
                           verbose=False).update()
    _, first = _traced(update)
    _, second = _traced(update)
    count = lambda spans, name: sum(n == name for _, _, n in spans)
    assert count(first, "efa.obs.taps_build") == 1
    assert count(second, "efa.obs.taps_build") == 0
    assert count(second, "efa.obs.taps") >= 1


@pytest.mark.parametrize("nobs,panel", [(30, 8), (5, 8), (24, 8)])
def test_one_tail_panel_span_per_panel(nobs, panel):
    _, spans = _traced(_flat_solve(True, nobs, panel))
    tail = [(b, e) for b, e, n in spans if n == "efa.route.tail"]
    panels = [(b, e) for b, e, n in spans if n == "efa.route.tail_panel"]
    assert len(tail) == 1
    assert len(panels) == -(-nobs // panel)
    assert all(tail[0][0] <= b and e <= tail[0][1] for b, e in panels)


def test_annotate_without_a_profiler_is_a_shared_noop(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) constructed")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    noop = profiling.annotate(profiling.ENTRY_UPDATE)
    assert noop is profiling.annotate(profiling.OPS_PREPARE)
    with noop:
        pass
    state, times = _state()
    EnSRF(state, _batch(times, 20), config=_config(False),
          verbose=False).update()
    _flat_solve(True, 20)()


def test_annotate_under_a_profiler_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        span = profiling.annotate(profiling.ROUTE_BODY)
        assert isinstance(span, torch.profiler.record_function)


@pytest.mark.parametrize("fast", [False, True], ids=["B4", "B2"])
def test_outputs_equal_with_and_without_the_profiler(fast):
    state, times = _state()
    batch = _batch(times, 30)
    update = lambda: EnSRF(state, dataclasses.replace(batch),
                           config=_config(fast), verbose=False).update()
    (post_a, obs_a) = update()
    (post_b, obs_b), _ = _traced(update)
    assert torch.equal(post_a.data, post_b.data)
    for k in ("prior_mean", "prior_var", "post_mean", "post_var",
              "assimilated"):
        np.testing.assert_array_equal(getattr(obs_a, k), getattr(obs_b, k))
    solve = _flat_solve(fast, 30)
    plain, (traced, _) = solve(), _traced(solve)
    for a, b in zip(plain[:4], traced[:4]):
        assert torch.equal(a, b)
    for a, b in zip(plain[4], traced[4]):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
