"""The LETKF cell ``letkf-c7`` on the CPU: its files found by name; the
pair counter against the chunks the route solves; the NS and LG counts'
arithmetic; ``select_device_ms`` on a synthetic trace; and whole small
runs, sound and with faults planted underneath, at the cell's limits."""

from __future__ import annotations

import json
import time

import pytest
import torch

from efa_xray_tpu_torch.assimilation import letkf_core
from portbench import check, generate, harness, peaks, readers, spec, trace

from conftest import ROOT

CELL = "letkf-c7"
# A small deployment of the cell's kind: 4,096 points (512 patches of 8),
# 300 obs; chunks of 64 units, so the body has 8 and the obs 5, the last
# padded.
SMALL = dict(nstate=4096, nmems=16, obs={
    "count": 300, "placement": "state_rows", "order": "hilbert",
    "error_var": 1.0, "radius_km": 2000.0})
FIELDS = {"letkf_chunk": 64}
NS_KERNEL = "void (anonymous namespace)::ns_smem_kernel<5>(float const*)"
ATEN = "void at::native::vectorized_elementwise_kernel<4, mul>(int)"


def test_the_cells_files_are_found_by_name():
    cell = spec.load_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.config["kind"] == "scattered"
    assert cell.traffic["entry"] == "letkf" and cell.traffic["pairs"] == "letkf"
    ref = spec.load_module("reference", cell.config["reference"])
    assert set(cell.check["limits"]) == set(check.names(ref))
    for kind, name in (("entries", "letkf"), ("pairs", "letkf"),
                       ("generators", cell.config["kind"]),
                       ("counts", "NS"), ("counts", "LG")):
        spec.load_module(kind, name)
    assert ("obs_pts_per_s", "obs_pts/s") in cell.end_to_end
    names = {n for n, _ in cell.per_layer}
    assert names == {"NS_roofline", "LG_roofline", "select_device_ms",
                     "route_host_ms.letkf", "operands_host_ms.letkf",
                     "launches_per_update.letkf", "device_idle_pct.letkf",
                     "host_syncs_per_update.letkf", "aten_device_ms.letkf"}
    for name in names:
        assert callable(spec.metric_reader(name).read)
    # The configuration's geometry is the filter's.
    for key in ("letkf_patch_size", "letkf_k_obs"):
        assert cell.config[key] == cell.traffic["filter"][key]
    generate.check_keys(cell.config, cell.traffic,
                        spec.load_module("generators", "scattered").CHOICES)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if CELL in m.get("workloads", []):
            assert m["workloads"] == [CELL] and m["moves"] == "obs_pts_per_s"


def _inputs(seed=3, **size):
    cell = spec.load_cell(ROOT, CELL)
    cfg = {**cell.config, **SMALL, **size}
    return generate.make_inputs(cfg, cell.traffic, seed, "cpu"), \
        {**cell.traffic["filter"], **FIELDS}


@pytest.mark.parametrize("nstate,nobs,chunk", [(4096, 300, 64),
                                               (4000, 256, 64),
                                               (2048, 120, 512)])
def test_pair_counter_matches_the_chunks_the_route_solves(
        monkeypatch, nstate, nobs, chunk):
    """Every chunk the route solves (a spy on ``_ChunkSolver.__call__``):
    the units with their padding, ``k``, the chunks, and the distinct obs
    each chunk gathers."""
    inputs, fields = _inputs(nstate=nstate, obs={**SMALL["obs"],
                                                 "count": nobs})
    fields["letkf_chunk"] = chunk
    seen = []
    call = letkf_core._ChunkSolver.__call__

    def spy(self, px, ii, *a, **kw):
        seen.append(ii.clone())
        return call(self, px, ii, *a, **kw)

    monkeypatch.setattr(letkf_core._ChunkSolver, "__call__", spy)
    entry = spec.load_module("entries", "letkf").Entry(inputs, fields, "cpu")
    out = entry.update(0)
    p = spec.load_module("pairs", "letkf").count(inputs, fields)
    assert p["chunks"] == len(seen)
    assert p["units"] == sum(ii.shape[0] for ii in seen)
    assert {ii.shape[1] for ii in seen} == {p["k"]} == {min(64, nobs)}
    assert p["gathered_rows"] == sum(int(torch.unique(ii).numel())
                                     for ii in seen)
    assert p["rows"] == out[0].shape[0] + out[2].shape[0] == nstate + nobs
    assert p["body_chunks"] == -(-(-(-nstate // 8)) // min(chunk,
                                                          -(-nstate // 8)))


def _pairs(units=534528, k=64, m=80, gathered=150_000):
    return dict(nmems=m, k=k, units=units, gathered_rows=gathered)


def test_ns_count_at_config_7(monkeypatch):
    ns = spec.load_module("counts", "NS")
    it, m = ns.ITERATIONS, 80
    ops, nbytes = ns.ops_bytes(_pairs(units=512))
    assert ops == 512 * (6 * it * m ** 3 + 4 * m * m)
    assert nbytes == 512 * 4 * (2 * m * m + 2 * m)
    # One chunk of config 7 at 11 iterations: the bound chip_smoke.py
    # states (0.2584 ms).
    monkeypatch.setattr(ns, "ITERATIONS", 11)
    ops, nbytes = ns.ops_bytes(_pairs(units=512))
    assert 1e3 * peaks.bound_s(ops, nbytes) == pytest.approx(0.2584, abs=1e-4)


def test_lg_count():
    lg = spec.load_module("counts", "LG")
    ops, nbytes = lg.ops_bytes(_pairs(units=512, gathered=150))
    assert ops == 512 * 64 * (80 * 81 + 160 + 60)
    assert nbytes == 150 * (320 + 32) + 512 * (64 * 8 + 12 + 4 * (6400 + 80))
    # A alone, both triangles, is most of a chunk's bytes (13.1 MB).
    assert 512 * 6400 * 4 / nbytes > 0.9


def _ctx(events, host, updates=((0, 100), (200, 300))):
    tr = trace.Trace(events=events, host=host, window=(0.0, 400.0),
                     updates=list(updates))
    return readers.Context(trace=tr, updates=len(updates),
                           pairs=_pairs(units=8, m=4, k=2, gathered=3),
                           own=frozenset({"ns_smem_kernel"}))


def test_select_device_ms_reads_the_events_launched_in_its_spans():
    sel = "efa.ops.letkf_select"
    host = [(0, 100, trace.UPDATE_SPAN), (200, 300, trace.UPDATE_SPAN),
            (5, 20, sel), (50, 60, "efa.ops.letkf_solve"), (210, 230, sel)]
    ev = [trace.DeviceEvent(ATEN, 21, 31, launch_us=6),    # 10 us
          trace.DeviceEvent(ATEN, 31, 34, launch_us=19.5),  # 3 us
          trace.DeviceEvent(NS_KERNEL, 60, 90, launch_us=51),
          trace.DeviceEvent(ATEN, 240, 245, launch_us=229),  # 5 us
          trace.DeviceEvent(ATEN, 250, 260, launch_us=231),
          trace.DeviceEvent(ATEN, 215, 216)]  # unlinked: not attributed
    got = spec.metric_reader("select_device_ms").read(_ctx(ev, host))
    assert got == pytest.approx(1e-3 * (10 + 3 + 5) / 2)
    no_span = [h for h in host if h[2] != sel]
    assert spec.metric_reader("select_device_ms").read(
        _ctx(ev, no_span)) is None


def test_ns_roofline_reads_its_kernel():
    ev = [trace.DeviceEvent(NS_KERNEL, 10, 60, launch_us=5),
          trace.DeviceEvent(NS_KERNEL, 210, 260, launch_us=205)]
    ctx = _ctx(ev, [])
    ops, nbytes = spec.load_module("counts", "NS").ops_bytes(ctx.pairs)
    want = 100 * peaks.bound_s(ops, nbytes) * 2 / 100e-6
    assert spec.metric_reader("NS_roofline").read(ctx) == pytest.approx(want)
    assert spec.metric_reader("LG_roofline").read(ctx) is None
    parts = ("launches_per_update.letkf", "device_idle_pct.letkf")
    assert spec.metric_reader(parts[0]).read(ctx) == 1.0
    assert spec.metric_reader(parts[1]).read(ctx) == pytest.approx(75.0)


def _run(fields=None, seed=2**31 + 5):
    return harness.run(ROOT, CELL, seed, 0.3, False, "cpu",
                       time.perf_counter(), size=SMALL,
                       fields={**FIELDS, **(fields or {})})


def test_sound_run_is_correct_and_the_control_is_not():
    r = _run()
    assert r["correct"], r["checks"]
    want = {n for n, _ in spec.load_cell(ROOT, CELL).end_to_end}
    assert set(r["metrics"]) == want
    # The cell's control (the reference in TF32 products) and bf16.
    control = spec.load_cell(ROOT, CELL).check["control"]
    assert control == {"reference_products": "tf32"}
    for fields in (control, {"reference_products": "bf16"}):
        c = _run(fields)
        assert not c["correct"], c["checks"]
    with pytest.raises(ValueError, match="reference_products"):
        _run({"reference_products": "float64"})


_solve = letkf_core.letkf_update


def _unchanged(bm, bp, *args, **kw):
    """An update that returns the state it was given."""
    _, _, tm, tp, diags = _solve(bm, bp, *args, **kw)
    return bm.clone(), bp.clone(), tm, tp, diags


def _half_batch(bm, bp, tm, tp, lat, lon, obs, **kw):
    """Every other ob left out."""
    keep = torch.ones_like(obs.assim)
    keep[1::2] = False
    return _solve(bm, bp, tm, tp, lat, lon,
                  obs._replace(assim=obs.assim & keep), **kw)


def _fewer_neighbours(*args, **kw):
    """Each patch over a quarter of the filter's ``k`` obs (16: at this
    size ~30 obs lie within a patch's support)."""
    return _solve(*args, **{**kw, "k_obs": kw["k_obs"] // 4})


def _altered(*args, **kw):
    """One answer altered where it is produced: one state row's mean."""
    bm, bp, tm, tp, diags = _solve(*args, **kw)
    bm[bm.shape[0] // 2] += 0.5
    return bm, bp, tm, tp, diags


@pytest.mark.parametrize("fault", [_unchanged, _half_batch,
                                   _fewer_neighbours, _altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_fault_underneath_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(letkf_core, "letkf_update", fault)
    r = _run()
    assert not r["correct"], r["checks"]
