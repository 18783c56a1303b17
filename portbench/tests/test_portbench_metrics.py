"""The metric arithmetic on synthetic events: the rate, p90, the idle
union, the per-layer readers and the breakdown."""

from __future__ import annotations

import pytest

from portbench import harness, readers, spec, trace, work

KERNEL = "void (anonymous namespace)::fused_body_kernel<false, 0, false>(x)"
B1 = "void (anonymous namespace)::tail_solve_kernel<false, false, 8>(Args)"
ATEN = "void at::native::vectorized_elementwise_kernel<4, add>(int)"


def _trace():
    # Two updates in a window of 0..100 us; the second ends 90 us.
    ev = [trace.DeviceEvent(B1, 1, 11), trace.DeviceEvent(KERNEL, 11, 31),
          trace.DeviceEvent(ATEN, 30, 35),  # overlaps the kernel by 1 us
          trace.DeviceEvent("Memcpy DtoD (Device -> Device)", 40, 45),
          trace.DeviceEvent(B1, 51, 61), trace.DeviceEvent(KERNEL, 61, 81),
          trace.DeviceEvent(ATEN, 95, 99)]  # between updates: harness work
    host = [(0, 100, trace.WINDOW_SPAN), (0, 48, trace.UPDATE_SPAN),
            (50, 90, trace.UPDATE_SPAN), (36, 40, "aten::copy_"),
            (82, 89, "cudaDeviceSynchronize")]
    return trace.Trace(events=ev, host=host, window=(0.0, 100.0),
                       updates=[(0, 48), (50, 90)])


def _ctx(pairs=None):
    pairs = pairs or dict(nmems=80, nobs=2, nstate=10, panel_sizes=[2],
                          panel_pairs=3, tail_pairs=1, body_pairs=15)
    return readers.Context(trace=_trace(), updates=2, pairs=pairs,
                           own=frozenset({"fused_body_kernel",
                                          "tail_solve_kernel"}))


def test_union_busy_and_idle():
    tr = _trace()
    assert trace.union_us([(0, 10), (5, 12), (20, 25)]) == 17
    assert tr.busy_s == pytest.approx((10 + 24 + 5 + 10 + 20 + 4) / 1e6)
    idle = spec.load_module("metrics", "device_idle_pct").read(_ctx())
    assert idle == pytest.approx(100.0 * (1 - 73 / 100))


def test_readers_count_the_updates_work_only(monkeypatch):
    # Edges of 2 us: the event at 95 us (the harness's, 5 us after the
    # second update) falls outside, the one at 30 us inside.
    monkeypatch.setattr(trace, "EDGE_US", 2.0)
    ctx = _ctx()
    launches = spec.load_module("metrics", "launches_per_update").read(ctx)
    assert launches == 5 / 2  # the copy is no launch; 95-99 is outside
    aten = spec.load_module("metrics", "aten_device_ms").read(ctx)
    assert aten == pytest.approx(1e3 * (5 + 5) / 1e6 / 2)
    b2 = spec.load_module("metrics", "B2_roofline").read(ctx)
    ops = (1 + 15) * work.ops_per_pair(80)
    nbytes = work.apply_bytes(ctx.pairs)
    want = 100 * max(ops / 67e12, nbytes / 3.35e12) * 2 / (40 / 1e6)
    assert b2 == pytest.approx(want)
    assert spec.load_module("metrics", "B4_roofline").read(ctx) is None


def test_a_split_metric_is_read_by_its_quantity():
    ctx = _ctx()
    split = spec.metric_reader("launches_per_update.host_paced")
    assert split is spec.load_module("metrics", "launches_per_update")
    assert split.read(ctx) == spec.metric_reader(
        "launches_per_update").read(ctx)
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric.host_paced")


def test_rate_and_p90():
    times = [0.30 + 0.001 * i for i in range(100)]
    assert harness.p90(times) == pytest.approx(0.389)
    assert harness.p90([1.0]) == 1.0


def test_breakdown(monkeypatch):
    monkeypatch.setattr(trace, "SHORT_GAP_US", 1.0)
    b = trace.breakdown(_trace(), top=3)
    assert b["device_ops"][0] == [KERNEL, pytest.approx(40e-6)]
    names = dict(b["idle_gaps"])
    assert names["aten::copy_"] == pytest.approx(5e-6)  # 35..40
    assert names["cudaDeviceSynchronize"] == pytest.approx(14e-6)  # 81..95
    assert len(b["idle_gaps"]) <= 3


def test_own_kernels_from_the_program():
    from conftest import ROOT

    own = readers.own_kernels(ROOT / "efa_xray_tpu_torch" / "csrc")
    assert {"tail_solve_kernel", "fused_body_kernel",
            "grid_body_kernel"} <= own
    assert readers.base_name(KERNEL) == "fused_body_kernel"
    assert readers.base_name(ATEN) == "vectorized_elementwise_kernel"


def test_update_events_follow_the_launch_where_the_trace_links_it():
    tr = trace.Trace(
        events=[trace.DeviceEvent(KERNEL, 49.5, 60, launch_us=50.5),
                trace.DeviceEvent(ATEN, 91, 92, launch_us=89.0),
                trace.DeviceEvent(ATEN, 89.5, 90.5, launch_us=95.0),
                trace.DeviceEvent(ATEN, 90.4, 91)],
        host=[], window=(0.0, 100.0), updates=[(50, 90)])
    # Launched inside the span, whatever the device's clock says; the
    # last, unlinked, within EDGE_US of the span.
    assert [e.start_us for e in tr.update_events] == [49.5, 91, 90.4]
