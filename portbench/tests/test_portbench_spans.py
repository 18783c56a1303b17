"""The readers of the program's own spans (``portbench/spans.py`` and its
five metrics) on synthetic traces: self time by the layer of the innermost
program span, the host's waits on the card taken out, and its
synchronizations counted inside program spans only; and on the CPU, every cell's traced run at a small size reports each
metric it lists."""

from __future__ import annotations

import time

import pytest

from portbench import harness, readers, spans, spec, trace

from conftest import ROOT, SMALL, SMALL_FIELDS

METRICS = ("entry_host_ms", "taps_ms", "route_host_ms", "operands_host_ms",
           "host_syncs_per_update")


def _ctx(host, updates, n=None):
    tr = trace.Trace(events=[], host=host, window=(0.0, 1000.0),
                     updates=updates)
    return readers.Context(trace=tr, updates=len(updates) if n is None
                           else n, pairs={}, own=frozenset())


def _read(name, ctx):
    return spec.metric_reader(name).read(ctx)


def _one_update():
    # One update 0..100 us: the entry 2..98 holds the taps 5..15 and the
    # route 20..80, which holds the operands 30..40 (with an aten op and a
    # launch inside, not program spans) and a synchronize 50..60; the
    # harness's own wait 98..100 lies outside every program span.
    return [(0, 100, trace.UPDATE_SPAN), (2, 98, "efa.entry.update"),
            (5, 15, "efa.obs.taps"), (20, 80, "efa.route.solve"),
            (30, 40, "efa.ops.block_operands"), (31, 35, "aten::mul"),
            (36, 38, "cudaLaunchKernel"),
            (50, 60, "cudaStreamSynchronize"),
            (98, 100, "cudaDeviceSynchronize")]


def test_self_time_by_innermost_program_span():
    ctx = _ctx(_one_update(), [(0, 100)])
    assert _read("entry_host_ms", ctx) == pytest.approx((96 - 10 - 60) / 1e3)
    assert _read("taps_ms", ctx) == pytest.approx(10 / 1e3)
    assert _read("route_host_ms", ctx) == pytest.approx((60 - 10 - 10)
                                                        / 1e3)
    assert _read("operands_host_ms", ctx) == pytest.approx(10 / 1e3)
    assert _read("host_syncs_per_update", ctx) == 1


def test_waits_are_taken_out_of_every_layer_and_syncs_counted_in_spans():
    host = [(0, 1000, trace.UPDATE_SPAN), (0, 1000, "efa.entry.update"),
            (100, 300, "cudaStreamSynchronize"),
            (400, 900, "efa.route.body"),
            # A blocking copy: the copy waits, the synchronize returns.
            (500, 700, "cudaMemcpyAsync"),
            (700, 710, "cudaStreamSynchronize"),
            (750, 760, "cudaLaunchKernel"),  # a launch: host work
            (800, 880, "cudaLaunchKernel"),  # waited for the queue
            (1120, 1130, "efa.entry.init"),  # outside the update: not read
            (1125, 1128, "cudaStreamSynchronize"),
            (1200, 1300, trace.UPDATE_SPAN),
            (1210, 1220, "cudaDeviceSynchronize")]  # in no program span
    s = spans.split(host, [(0, 1000), (1200, 1300)])
    assert s.host_us == pytest.approx({"entry": 1000 - 200 - 500,
                                       "route": 500 - 210 - 80})
    assert s.syncs == 2
    ctx = _ctx(host, [(0, 1000), (1200, 1300)])
    assert _read("host_syncs_per_update", ctx) == 1
    assert _read("entry_host_ms", ctx) == pytest.approx(300 / 2e3)


def test_which_runtime_calls_wait():
    host = [(0, 10, "cudaMemcpyAsync"), (10, 20, "cudaLaunchKernel"),
            (30, 40, "cudaMemcpyAsync"), (40, 41, "cudaDeviceSynchronize"),
            (50, 200, "cudaLaunchKernelExC"), (210, 260, "cudaMemsetAsync"),
            (300, 900, "cudaMalloc"), (1000, 1100, "aten::copy_"),
            (1001, 1090, "cudaMemcpyAsync"),
            (1090, 1095, "cudaStreamSynchronize")]
    # A copy before a launch, or before the harness's device-wide
    # synchronize, returned at once; a launch of 150 us waited for the
    # queue, a set of 50 us did not; an allocation is host work.
    assert spans.waits(host) == [(40, 41, True), (50, 200, False),
                                 (1001, 1090, False), (1090, 1095, True)]


def test_layers_add_up_to_the_program_time_less_its_waits():
    host = _one_update()
    s = spans.split(host, [(0, 100)])
    assert sum(s.host_us.values()) == pytest.approx(96 - 10)


def test_a_child_running_past_its_parent_is_cut_at_the_parent_end():
    host = [(0, 100, trace.UPDATE_SPAN), (10, 50, "efa.route.tail"),
            (40, 55, "efa.ops.panel_weights")]
    s = spans.split(host, [(0, 100)])
    assert s.host_us == pytest.approx({"route": 30, "ops": 10})


def test_no_program_span_reads_nothing():
    # The parent commit's program has no spans: every reader is silent.
    host = [(0, 100, trace.UPDATE_SPAN), (10, 20, "aten::mul"),
            (30, 40, "cudaStreamSynchronize")]
    ctx = _ctx(host, [(0, 100)])
    assert spans.split(host, [(0, 100)]) is None
    assert all(_read(m, ctx) is None for m in METRICS)
    # A layer with no span in the window is silent too.
    ctx = _ctx([(0, 100, trace.UPDATE_SPAN), (10, 20, "efa.route.solve")],
               [(0, 100)])
    assert _read("entry_host_ms", ctx) is None
    assert _read("route_host_ms", ctx) == pytest.approx(0.01)
    assert _read("host_syncs_per_update", ctx) == 0


@pytest.mark.parametrize("cell", ["grid1024-exact", "grid1024-fast",
                                  "pod1e7-flat"])
def test_traced_run_reports_each_span_metric_it_lists(cell):
    listed = [n for n, _ in spec.load_cell(ROOT, cell).per_layer
              if n.split(".", 1)[0] in METRICS]
    assert listed
    r = harness.run(ROOT, cell, 5, 0.3, True, "cpu", time.perf_counter(),
                    size=SMALL[cell], fields=SMALL_FIELDS)
    assert r["correct"], r["checks"]
    for name in listed:
        value = r["metrics"][name]["value"]
        if name.startswith("host_syncs_per_update"):
            assert value == 0  # no card, no waits on it
        else:
            assert value > 0, name
