#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``efa_xray_tpu_torch``) once on one NVIDIA GPU.

Usage, from the root of a checkout::

    python3 chip_smoke.py             # phases 0-5
    python3 chip_smoke.py --profile   # phases 0-1, then the profile phase

Phases, each printing one line of results:

0. environment: versions, the card (``nvidia-smi`` name and power limit);
   TF32 off for every torch product;
1. build the CUDA kernels from ``efa_xray_tpu_torch/csrc``;
2. B1 (tail panel solve) against its plain-torch version at 512 x 80;
3. B2 (fused body) against its plain version at 262,144 rows x 80 x 2048
   obs: cull on and off, both angle forms, an odd row count;
4. the public API: ``EnSRF(...).update()`` on a 1024 x 1024 global grid x
   80 members with 10,000 obs, through both kernels (launch counts), held
   against the plain blocked update on the same tensors;
5. the headline workload: 1e7 Hilbert-ordered rows x 80 x 10,000 obs at
   2000 km through the B1/B2 tail and the B2 body, timed with CUDA events,
   a 20,000-row sample held against the plain body.

Then one JSON line describing each kernel and, last, the device line.

``--profile`` replaces phases 2-5 with one warm headline update and one warm
``EnSRF.update()`` under ``torch.profiler``: wall and device-busy time, the
busy share, the device ops that take the most time, and the share of the
headline's (row tile, obs block) pairs and 8-ob panels that the cull keeps
alive.  Any
failure raises and exits non-zero; without a GPU the script exits non-zero
before doing anything.  It never imports JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

RTOL, ATOL = 2e-5, 2e-4  # the f32 tolerances of tests/test_pallas_kernel.py


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def compare(name: str, got, want) -> float:
    """Max abs error of ``got`` against ``want`` (NaNs must coincide);
    raises when outside rtol 2e-5 / atol 2e-4."""
    import torch

    g = got.double()
    w = want.double()
    gn, wn = torch.isnan(g), torch.isnan(w)
    check(bool(torch.equal(gn, wn)), f"{name}: NaN pattern differs")
    g, w = g[~gn], w[~wn]
    if g.numel() == 0:
        return 0.0
    err = (g - w).abs()
    bad = err > ATOL + RTOL * w.abs()
    check(not bool(bad.any()),
          f"{name}: {int(bad.sum())} elements outside rtol {RTOL} / atol "
          f"{ATOL}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------


def phase0():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        nvcc = subprocess.run(["nvcc", "--version"], capture_output=True,
                              text=True).stdout.strip().splitlines()[-1]
    except FileNotFoundError:
        nvcc = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"],
                              capture_output=True,
                              text=True).stdout.strip().splitlines()[-1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"phase 0: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc '{nvcc}' "
        f"device '{torch.cuda.get_device_name(0)}' "
        f"count {torch.cuda.device_count()} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    print(smi, flush=True)
    return smi


def phase1():
    from efa_xray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.lib()
    check(lib is not None, "kernel library did not load")
    log(f"phase 1: built {_build.library_path().name} from "
        f"{[s.name for s in _build.sources()]}: nvcc "
        f"{_build.last_build_seconds:.2f} s, load {time.perf_counter() - t0:.2f} s")


def phase2():
    """B1 against its plain version on a 512-ob panel."""
    import torch

    from efa_xray_tpu_torch.assimilation import ensrf_core as core
    from efa_xray_tpu_torch.observation.localization import (
        hilbert3d_np,
        latlon_to_unit,
    )
    from efa_xray_tpu_torch.ops import tail_solve

    dev = torch.device("cuda")
    f32 = torch.float32
    p, m = 512, 80
    rng = np.random.default_rng(11)
    lat = rng.uniform(20.0, 60.0, p)
    lon = rng.uniform(200.0, 280.0, p)
    o = np.argsort(hilbert3d_np(lat, lon), kind="stable")
    lat, lon = lat[o], lon[o]
    ye = rng.normal(280.0, 5.0, (p, m))
    tm = torch.tensor(ye.mean(1), dtype=f32, device=dev)
    tp = torch.tensor(ye - ye.mean(1, keepdims=True), dtype=f32, device=dev)
    vals = tm + torch.tensor(rng.normal(0, 1.5, p), dtype=f32, device=dev)
    errs = torch.tensor(rng.uniform(0.5, 2.0, p), dtype=f32, device=dev)
    assim = torch.tensor(rng.random(p) > 0.1, device=dev)
    pob = core.ObsArrays(
        values=vals, errors=errs,
        lats=torch.tensor(lat, dtype=f32, device=dev),
        lons=torch.tensor(lon, dtype=f32, device=dev),
        radii=torch.full((p,), 2000.0, dtype=f32, device=dev), assim=assim,
    ).with_default_verts()
    wmat = core.panel_weights(latlon_to_unit(pob.lats, pob.lons), pob,
                              False, f32)
    errs_max = 0.0
    times = {}
    for name, w in (("localized", wmat), ("unlocalized", None)):
        args = (tm, tp, vals, errs, assim, w)
        got = tail_solve.tail_panel_solve(*args)
        want = tail_solve.tail_panel_solve_plain(*args)
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(got, want)):
            errs_max = max(errs_max, compare(f"B1 {name} out{k}", a, b))
        times[name] = (cuda_ms(lambda: tail_solve.tail_panel_solve(*args), 10),
                       cuda_ms(lambda: tail_solve.tail_panel_solve_plain(*args), 3))
    k_ms, p_ms = times["localized"]
    log(f"phase 2: B1 [512 x 80] f32 matches plain (max abs err "
        f"{errs_max:.3e}); localized kernel {k_ms:.3f} ms plain {p_ms:.3f} "
        f"ms; unlocalized kernel {times['unlocalized'][0]:.3f} ms plain "
        f"{times['unlocalized'][1]:.3f} ms")
    return dict(max_abs_err=errs_max, ms=k_ms, plain_ms=p_ms)


def _scattered(n, nobs, seed, dev):
    """Hilbert-ordered scattered rows and obs drawn from the rows, drawn
    as bench.py's build_workload draws them; also returns the generator
    for the draws that follow there."""
    import torch

    from efa_xray_tpu_torch.observation.localization import hilbert3d_np

    rng = np.random.default_rng(seed)
    lat = rng.uniform(-88.0, 88.0, n)
    lon = rng.uniform(0.0, 360.0, n)
    ro = np.argsort(hilbert3d_np(lat, lon), kind="stable")
    lat, lon = lat[ro], lon[ro]
    rows = rng.integers(0, n, nobs)
    olat, olon = lat[rows], lon[rows]
    oo = np.argsort(hilbert3d_np(olat, olon), kind="stable")
    f32 = torch.float32
    t = lambda x: torch.tensor(x, dtype=f32, device=dev)
    return t(lat), t(lon), t(olat[oo]), t(olon[oo]), rng


def phase3():
    """B2 against its plain version at 262,144 rows x 80 x 2048 obs."""
    import torch

    from efa_xray_tpu_torch.assimilation import ensrf_core as core
    from efa_xray_tpu_torch.ops import ensrf_fused

    dev = torch.device("cuda")
    f32 = torch.float32
    n, m, nobs = 262_144, 80, 2048
    lat, lon, olat, olon, _ = _scattered(n, nobs, 21, dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    bm = 280.0 + 0.5 * torch.randn(n, generator=gen, device=dev)
    bp = 5.0 * torch.randn(n, m, generator=gen, device=dev)
    tp0 = 5.0 * torch.randn(nobs, m, generator=gen, device=dev)
    tm = tp0.mean(1) + 280.0
    tp = tp0 - tp0.mean(1, keepdim=True)
    vals = tm + torch.randn(nobs, generator=gen, device=dev)
    obs = core.ObsArrays(values=vals, errors=torch.ones(nobs, device=dev),
                         lats=olat, lons=olon,
                         radii=torch.full((nobs,), 2000.0, device=dev),
                         assim=torch.ones(nobs, dtype=torch.bool, device=dev))
    tail = core.tail_scan_blocked(tm, tp, obs, localize=True,
                                  fast_geometry=True, panel=512, kernels=True,
                                  max_radius_km=2000.0)
    results = []
    for rows, cull, radius in ((n, True, 2000.0), (n, False, 2000.0),
                               (n, True, 6000.0), (n - 1, True, 2000.0)):
        o = obs._replace(radii=torch.full((nobs,), radius, device=dev))
        ops = ensrf_fused.prepare(bp[:rows], lat[:rows], lon[:rows], tail, o,
                                  block_size=128, cull=cull,
                                  max_radius_km=radius)
        args = (bm[:rows], bp[:rows], ops["geom"], ops["y_b"], ops["ggt_b"],
                ops["tab_b"], ops["bits"], ops["tile"], True, False,
                ops["series"])
        got = ensrf_fused.fused_apply(*args)
        want = ensrf_fused.fused_apply_plain(*args)
        torch.cuda.synchronize()
        err = max(compare(f"B2 rows={rows} cull={cull} r={radius} mean",
                          got[0], want[0]),
                  compare(f"B2 rows={rows} cull={cull} r={radius} perts",
                          got[1], want[1]))
        alive = (float((ops["bits"] != 0).float().mean())
                 if ops["bits"] is not None else 1.0)
        k_ms = cuda_ms(lambda: ensrf_fused.fused_apply(*args), 3)
        p_ms = cuda_ms(lambda: ensrf_fused.fused_apply_plain(*args), 1)
        results.append(dict(rows=rows, cull=cull, radius=radius,
                            form="series" if ops["series"] else "arccos",
                            alive_tile_blocks=alive, max_abs_err=err,
                            ms=k_ms, plain_ms=p_ms))
    log("phase 3: B2 matches plain: " + "; ".join(
        f"rows {r['rows']} cull {r['cull']} {r['form']} (alive tile-blocks "
        f"{r['alive_tile_blocks']:.3f}): err {r['max_abs_err']:.3e} kernel "
        f"{r['ms']:.2f} ms plain {r['plain_ms']:.2f} ms" for r in results))
    head = results[0]
    return dict(max_abs_err=max(r["max_abs_err"] for r in results),
                ms=head["ms"], plain_ms=head["plain_ms"])


def _api_workload(nmems=80, nobs=10_000, seed=1):
    """The public-API workload of bench.py's phase_api: a 1024 x 1024
    global grid, random obs with 2000 km radii."""
    from efa_xray_tpu_torch.observation.observation import ObservationBatch
    from efa_xray_tpu_torch.utils import timeutil

    rng = np.random.default_rng(seed)
    ny = nx = 1024
    lat1d = np.linspace(-88, 88, ny)
    lon1d = np.arange(0, 360, 360 / nx)
    lon, lat = np.meshgrid(lon1d, lat1d)
    times = np.datetime64("2026-08-01T00") + np.arange(1) * np.timedelta64(6, "h")
    field = rng.normal(280, 5, (1, ny, nx, nmems)).astype(np.float32)
    batch = ObservationBatch(
        values=rng.normal(280, 5, nobs), errors=np.ones(nobs),
        lats=rng.uniform(-85, 85, nobs), lons=rng.uniform(0, 360, nobs),
        times_s=timeutil.to_epoch_seconds(np.repeat(times[0], nobs)),
        obtypes=["T2m"] * nobs, localize_radius=np.full(nobs, 2000.0),
        assimilate_flags=np.ones(nobs, bool), verts=np.full(nobs, np.nan),
        descriptions=[None] * nobs)
    coords = {"validtime": times, "lat": lat, "lon": lon,
              "mem": np.arange(nmems)}
    return {"T2m": field}, coords, batch


def phase4():
    """EnSRF.update() through the public API on the card."""
    import torch

    from efa_xray_tpu_torch import EnSRF, EnsembleState, FilterConfig
    from efa_xray_tpu_torch.assimilation import ensrf_core as core
    from efa_xray_tpu_torch.ops import ensrf_fused, tail_solve

    dev = torch.device("cuda")
    vardict, coords, batch = _api_workload()
    state = EnsembleState.from_vardict(
        {k: torch.from_numpy(v).to(dev) for k, v in vardict.items()}, coords,
        dtype="float32")
    check(state.device.type == "cuda", "state is not on the card")
    cfg = FilterConfig(localization="GC", dtype="float32", fast_geometry=True)

    tail_solve.launches = 0
    ensrf_fused.launches = 0
    post, obs = EnSRF(state, batch, config=cfg, verbose=False,
                      device="cuda").update()
    torch.cuda.synchronize()
    b1, b2 = tail_solve.launches, ensrf_fused.launches
    nobs = batch.nobs
    check(b1 == -(-nobs // cfg.tail_panel), f"B1 launched {b1} times")
    check(b2 >= -(-nobs // cfg.tail_panel) + 1, f"B2 launched {b2} times")

    # The plain blocked update on the same tensors.
    ref = EnSRF(state, batch, config=cfg, verbose=False, device="cuda")
    bm, bp, tm, tp = ref.format_prior_state()
    oa = ref.obs_arrays()
    blat, blon = state.structure.row_latlon_device(torch.float32, dev)
    pbm, pbp, *_ = core.ensrf_blocked(
        bm, bp, tm, tp, blat, blon, oa, localize=True,
        block_size=cfg.block_size, fast_geometry=True,
        tail_panel=cfg.tail_panel)
    prior_mean = bm
    post_mean = post.to_vect().mean(dim=1)
    incr_rms = float(torch.sqrt(torch.mean((pbm - prior_mean) ** 2)))
    mean_err = float((post_mean - pbm).abs().max())
    check(torch.isfinite(post.data).all().item(), "posterior not finite")
    check(mean_err <= 1e-3 * incr_rms,
          f"posterior mean differs from the plain update by {mean_err:.3e} "
          f"> 1e-3 x increment RMS {incr_rms:.3e}")
    pm, pv = obs.prior_mean, obs.prior_var
    om, ov = obs.post_mean, obs.post_var
    a = obs.assimilated
    check(bool(a.all()), "not every ob was assimilated")
    check(all(np.isfinite(x[a]).all() for x in (pm, pv, om, ov)),
          "diagnostics not finite")
    check(bool((ov[a] <= pv[a]).all()), "post_var > prior_var")
    inn_prior = float(np.mean(np.abs(batch.values - pm)))
    inn_post = float(np.mean(np.abs(batch.values - om)))
    check(inn_post < inn_prior, "innovations did not shrink")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    post2, _ = EnSRF(state, batch, config=cfg, verbose=False,
                     device="cuda").update()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    log(f"phase 4: EnSRF.update() 1024x1024x80, {nobs} obs on the card: "
        f"B1 launches {b1}, B2 launches {b2}; posterior mean vs plain "
        f"blocked: max abs diff {mean_err:.3e} (increment RMS "
        f"{incr_rms:.3e}); mean |innov| {inn_prior:.4f} -> {inn_post:.4f}; "
        f"warm update wall {warm:.3f} s")
    return dict(b1=b1, b2=b2)


def _headline():
    """The headline workload of bench.py's build_workload (1e7
    Hilbert-ordered rows x 80 x 10k obs at 2000 km), drawn on the card.
    Returns ``(tail_phase, body_phase, w)``: the B1/B2 tail, the B2 body
    on a tail, and a dict of the workload's tensors."""
    import torch

    from efa_xray_tpu_torch.assimilation import ensrf_core as core
    from efa_xray_tpu_torch.ops import ensrf_fused

    dev = torch.device("cuda")
    f32 = torch.float32
    nstate, nmems, nobs, radius = 10_000_000, 80, 10_000, 2000.0
    lat, lon, olat, olon, rng = _scattered(nstate, nobs, 4, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    bm = 280.0 + 0.5 * torch.randn(nstate, generator=gen, device=dev)
    bp = 5.0 * torch.randn(nstate, nmems, generator=gen, device=dev)
    tp0 = 5.0 * torch.randn(nobs, nmems, generator=gen, device=dev)
    tm = tp0.mean(1) + 280.0
    tp = tp0 - tp0.mean(1, keepdim=True)
    del tp0
    obs = core.ObsArrays(
        values=torch.tensor(280.0 + rng.normal(0, 1.0, nobs), dtype=f32,
                            device=dev),
        errors=torch.ones(nobs, device=dev), lats=olat, lons=olon,
        radii=torch.full((nobs,), radius, device=dev),
        assim=torch.ones(nobs, dtype=torch.bool, device=dev))

    def tail_phase():
        return core.tail_scan_blocked(tm, tp, obs, localize=True,
                                      fast_geometry=True, panel=512,
                                      kernels=True, max_radius_km=radius)

    def body_phase(tail):
        return ensrf_fused.fused_body(bm, bp, lat, lon, tail, obs,
                                      localize=True, block_size=128,
                                      max_radius_km=radius)

    w = dict(bm=bm, bp=bp, lat=lat, lon=lon, obs=obs, gen=gen,
             nstate=nstate, nobs=nobs, radius=radius)
    return tail_phase, body_phase, w


def phase5():
    """The headline workload: 1e7 rows x 80 x 10k obs."""
    import torch

    from efa_xray_tpu_torch.ops import ensrf_fused

    t0 = time.perf_counter()
    tail_phase, body_phase, w = _headline()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    nstate, nobs = w["nstate"], w["nobs"]

    body_phase(tail_phase())  # warm-up
    torch.cuda.synchronize()
    runs, tails, bodies = [], [], []
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        tail = tail_phase()
        ev[1].record()
        bm2, bp2 = body_phase(tail)
        ev[2].record()
        ev[2].synchronize()
        tails.append(ev[0].elapsed_time(ev[1]) / 1e3)
        bodies.append(ev[1].elapsed_time(ev[2]) / 1e3)
        runs.append(ev[0].elapsed_time(ev[2]) / 1e3)
    sec = statistics.median(runs)

    sample = torch.randperm(nstate, generator=w["gen"],
                            device=bm2.device)[:20_000]
    ops = ensrf_fused.prepare(w["bp"][sample], w["lat"][sample],
                              w["lon"][sample], tail, w["obs"],
                              block_size=128, cull=False,
                              max_radius_km=w["radius"])
    pm, pp = ensrf_fused.fused_apply_plain(
        w["bm"][sample], w["bp"][sample], ops["geom"], ops["y_b"],
        ops["ggt_b"], ops["tab_b"], None, ops["tile"], True, False,
        ops["series"])
    err = max(compare("headline sample mean", bm2[sample], pm),
              compare("headline sample perts", bp2[sample], pp))
    check(bool(torch.isfinite(bm2).all()), "headline posterior not finite")
    log(f"phase 5: 1e7 x 80 x 10k obs at 2000 km: update {sec:.4f} s "
        f"(runs {', '.join(f'{r:.4f}' for r in runs)} s; tail B1+B2 "
        f"{', '.join(f'{t:.4f}' for t in tails)} s; body B2 "
        f"{', '.join(f'{b:.4f}' for b in bodies)} s), "
        f"{nobs * nstate / sec:.4e} obs*points/s; setup {setup:.1f} s; "
        f"20k-row sample vs plain body max abs err {err:.3e}")
    return dict(seconds=sec)


def _profiled(label: str, fn, top: int = 8) -> None:
    """One warm run of ``fn`` under ``torch.profiler``: prints the wall
    time, the device time (union of the CUDA kernel and copy intervals),
    their ratio (the busy share) and the ``top`` device ops by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, per_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        n, us = per_name.get(e.name, (0, 0.0))
        per_name[e.name] = (n + 1, us + (end - start))
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    check(busy_us > 0, f"profile {label}: no device time was traced")
    log(f"profile {label}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms, busy share {busy_us / 1e3 / wall_ms:.3f}")
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:top]
    for name, (n, us) in ranked:
        log(f"  {us / 1e3:10.3f} ms {n:5d}x  {name[:100]}")


def profile_phase():
    """Where the time goes: one warm headline update and one warm API
    update under ``torch.profiler``, and the headline's cull shares."""
    import torch

    from efa_xray_tpu_torch import EnSRF, EnsembleState, FilterConfig
    from efa_xray_tpu_torch.ops import ensrf_fused

    tail_phase, body_phase, w = _headline()
    tail = tail_phase()
    ops = ensrf_fused.prepare(w["bp"], w["lat"], w["lon"], tail, w["obs"],
                              block_size=128, cull=True,
                              max_radius_km=w["radius"])
    bits = ops["bits"].to(torch.int64) & 0xFFFFFFFF
    npanels = 128 // ensrf_fused.PANEL
    panels = sum(int(((bits >> q) & 1).sum()) for q in range(npanels))
    log(f"profile headline: tile {ops['tile']}, bits {list(bits.shape)}; "
        f"alive tile-blocks {float((bits != 0).double().mean()):.4f}, "
        f"alive 8-ob panels {panels / (bits.numel() * npanels):.4f}")
    del ops, bits, tail
    _profiled("headline (1e7 x 80 x 10k obs)",
              lambda: body_phase(tail_phase()))
    del tail_phase, body_phase, w

    dev = torch.device("cuda")
    vardict, coords, batch = _api_workload()
    state = EnsembleState.from_vardict(
        {k: torch.from_numpy(v).to(dev) for k, v in vardict.items()}, coords,
        dtype="float32")
    cfg = FilterConfig(localization="GC", dtype="float32", fast_geometry=True)
    _profiled("API EnSRF.update() (1024 x 1024 x 80, 10k obs)",
              lambda: EnSRF(state, batch, config=cfg, verbose=False,
                            device="cuda").update())


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    smi = phase0()
    phase1()
    if "--profile" in sys.argv[1:]:
        profile_phase()
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    b1 = phase2()
    b2 = phase3()
    api = phase4()
    phase5()
    kernels = [
        dict(name="B1 tail panel solve", route="cuda",
             source="efa_xray_tpu_torch/csrc/tail_solve.cu",
             replaces="efa_xray_tpu/ops/tail_solve_pallas.py:46",
             launches=api["b1"], **b1),
        dict(name="B2 fused body", route="cuda",
             source="efa_xray_tpu_torch/csrc/ensrf_fused.cu",
             replaces="efa_xray_tpu/ops/ensrf_pallas_fused.py:117",
             launches=api["b2"], **b2),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
