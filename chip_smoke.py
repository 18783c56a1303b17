#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``efa_xray_tpu_torch``) once on one NVIDIA GPU.

Usage, from the root of a checkout::

    python3 chip_smoke.py             # phases 0-28
    python3 chip_smoke.py --profile   # phases 0-1, then the profile phase
    python3 chip_smoke.py --steps     # phases 0-1, then B1 at each sub-panel
                                      # width and cluster, B2 with parts of
                                      # its design switched off, the grid
                                      # kernel (B3, B4) at each tile, and
                                      # B2-B4's product modes part by part,
                                      # beside the parent commit's kernels

Phases, each printing one line of results:

0. environment: versions, the card (``nvidia-smi`` name and power limit);
   TF32 off for every torch product;
1. build the CUDA kernels from ``efa_xray_tpu_torch/csrc``;
2. B1 (tail panel solve) and B1h (its hybrid instantiation) against the
   serial plain-torch version over 14 edge cases: 512 x 80 chordal,
   haversine + vertical, varloc, hybrid, unlocalized; 1024 x 80, 512 x
   128, 512 x 256, 1024 x 256 (and hybrid), 30 members, a padded 300-ob
   panel, unbiased, all obs skipped; kernel and plain ms, us per ob, the
   bound, and the shared memory the wrapper plans against the kernel's
   layout; then B1e (the stochastic EnKF's instantiation, with draws
   ``eps``) over 9 cases: config 11's 512 x 40 panel (timed), haversine
   + vertical, varloc, half assimilated, 1024 x 80, 512 x 256, 1024 x
   256, a padded 300-ob panel unbiased, all obs skipped;
3. B2 (fused body) against its plain version at 262,144 rows x 80 x 2048
   obs: cull on and off, both angle forms, an odd row count; then at
   20,001 rows x 300 obs over the edges of its tiling (12, 21, 30, 50,
   80, 128 and 256 members, blocks of 128, 100 and 50 obs, one alive
   panel per block, cull off, unlocalized, vertical, the arccos form, in
   place); then B2e (departure rows ``z`` applied, the chordal form) on
   the same workload (cull on and off) and edge cases;
4. the public API: ``EnSRF(...).update()`` on a 1024 x 1024 global grid x
   80 members with 10,000 obs, through both kernels (launch counts), held
   against the plain blocked update on the same tensors;
5. the headline workload: 1e7 Hilbert-ordered rows x 80 x 10,000 obs at
   2000 km through the B1/B2 tail and the B2 body, timed with CUDA events,
   a 20,000-row sample held against the plain body; (c) one warm update
   each with the body's two products in TF32 and in bf16, their posterior
   against the fp32 one;
6. B3 (grid body) against its plain version at BASELINE config 3's shape
   (a 90 x 180 global 2-degree grid, 80 groups, 30 members, 5,000 obs at
   2000 km, a vertical table at 300 hPa), with and without a
   cross-variable group factor, and at 80 members on a 45 x 90 grid, with
   the CTAs per SM and the weight bytes the launch reads; then over the
   edges of its tiling at small grids (grids of 527, 60 and 21 points, 12
   to 256 members, blocks of 8 to 256 obs, no weights, no table, one
   group, one block, in place, weight chunks);
7. B4 (one obs block per launch) against its plain version at config 3's
   shape and on a 1024 x 1024 grid x 80 members with 10,000 obs (vt = 1),
   the torch build of a block's operands timed apart, and B4e over two
   blocks of each; then phase 6's edge cases through B4;
8. the public API on config 3 as users build it (80 level-stacked
   variables with their levels in ``var_verts``): (a) the default
   ``FilterConfig``: tail B1 + B4, body B4; (b) ``fast_geometry`` with
   cross-variable localization: tail B1 + B4, body B3; each held against
   the plain blocked update, with the tail's seconds;
9. phase 4's workload at the default ``FilterConfig``: tail B1 + B4, body
   B4;
10. B2h (B2's hybrid static-column instantiation) against its plain version
    at phase 3's shape with ``hybrid_alpha`` 0.5 and a per-row sigma: (a)
    ``static_length`` 1000 km under 2000 km radii (and an odd row count),
    (b) 3000 km, where the widened cull is live, (c) unlocalized, (d)
    vertical localization; then phase 3's edge cases in hybrid mode;
11. the hybrid path through the public API: phase 4's workload and config
    3 (80 level variables) with ``fast_geometry``, ``hybrid_alpha`` 0.5, a
    per-row ``static_b_sigma`` and ``static_b_length`` 1000 km: tail B1h
    and the plain hybrid apply, body B2h, held against the plain blocked
    hybrid update;
12. P, the precision probe: ``probe()`` (each mode against a float64
    oracle), each mode's kernel against its plain version at 512^2, [528,
    144] @ [144, 272], 1024^2 and [2064, 144] @ [144, 1296] (the size that
    reaches the 128 x 128 tiles timed at 4096^3), the tf32 mode against the
    product of inputs rounded to nearest, and ``torch.matmul`` timed beside
    each mode at 1024^3 and 4096^3;
13. a ``fast_geometry`` update at 128 members (B1 over a cluster, then B2);
14. a float64 update on the card at a small shape: the plain route, no
    kernel, near the float32 kernel update;
15. the options of ROADMAP A7 on the card: phase 4's workload with and
    without ``obs_order="hilbert"`` (B2's body launch timed alone, and the
    shares of (row tile, obs block) pairs and 8-ob panels the cull keeps
    alive; the batch back in the caller's order), ``spatial_sort`` on a
    flat state of 262,144 shuffled rows (B2 with a row order) against the
    same update without it, and ``rtps_alpha`` / ``rtpp_alpha`` 0.5 against
    the plain update relaxed by the plain formula;
16. ``obs_chunk`` on the card: chunked against one-shot through B2 (phase
    4's workload, chunks of 4,096), B3 (config 3 with ``fast_geometry``)
    and B4 (config 3 at the default config), with the launches and the
    peak memory, and one-shot batches of 40,000 and 160,000 obs on phase
    4's grid beside a chunked one;
17. the production cycle of BASELINE config 13 at the published defaults
    of ``benchmarks/cycled_production.py`` (320 x 320 L96-2d, 40 members,
    8,000 off-grid obs at 500 km with a 0.3 network bias, 20 cycles, float32):
    the forecast, the obs, online bias correction, ``EnSRF.update()`` with
    ``fast_geometry``, the outlier check and adaptive inflation (evolved
    std, damping 0.7, cap 1.7), and the verification, each cycle's phase
    seconds and its B1/B2 launches; cycle 0 held against the plain update,
    the colored Anderson update against the per-ob scan in color order, and
    the forecast against float64 on the CPU; every cycle's analysis finite,
    below its forecast's RMSE, and its inflation within its bounds;
18. the stochastic EnKF at BASELINE config 11 through ``EnKF(...).update()``
    (a 361 x 720 0.5-degree grid, 40 members, 2,000 obs at grid points,
    2000 km, ``fast_geometry``, blocks of 128, seed 6): the warm blocked
    update on its kernel route (B1e once per panel, B2e; no synchronizing
    call inside) with its tail/body split, held against the plain route
    (the per-ob tail and the plain body), the serial update and a float64
    one with the same draws (RMS gaps gated at 1e-3 of the increment
    RMS), the default config (B1e + B4e); B2e and B4e against their plain
    versions on the update's own operands, timed;
19. the LETKF through ``LETKF(...).update()`` at BASELINE config 6 (the
    same grid, patches of 8, k 64, chunks of 512): top-k exact and host
    (the host build timed; the same analysis), Newton-Schulz and eigh,
    float32 and float64 (the max gap gated outside the few patches whose
    k-th ob differs between the two), the unlocalized LETKF against the
    unlocalized EnSRF (mean and per-row variance), and NS against the
    plain Newton-Schulz loop on config 6's first chunk and on 64
    systems of 200 members (the device-memory variant; the same
    iterations, timed), LG against its plain version on config 6's first
    and padded last chunk; then config 9 (config 3's 80 level variables,
    30 members, 5,000 obs, 300 hPa vertical), LG on its first chunk and
    on it with a cross-variable table.  For each: seconds split into
    select, solve and apply, Newton-Schulz iterations per chunk, host
    syncs per update (none where NS runs), peak memory, LG and NS once
    a chunk, and where NS runs the aten operations and host ms a chunk
    and the device's busy seconds (NS's and LG's shares) under
    ``torch.profiler``;
20. the LETKF at BASELINE config 7's full size through
    ``letkf_core.letkf_update``: 4,194,304 scattered points x 80 members x
    10,000 obs in the port's Hilbert order, top-k exact and host (the same
    analysis), seconds, obs x points per second and peak memory, LG's
    and NS's launches (one each a chunk), no host read and no
    synchronizing call inside the update; the aten operations and host
    ms a chunk and the device's busy seconds of one warm update (NS's and
    LG's shares); NS and LG against their plain versions on the first
    chunk;
21. BASELINE config 1 through the port's ``CyclingHarness``
    (``benchmarks/run_benchmarks.py:195-253``: Lorenz-96, 40 variables, 20
    members, 4 steps a cycle, obs at every 2nd variable, 8000 km, float32,
    blocks of 8, adaptive inflation with sd 0.6 evolved, sd_min 0.15; 20
    warm-up cycles, then 60 with ``resume=True``): cycles per second, the
    mean analysis RMSE and spread over the last 30 and 10 cycles, B1/B4
    launches a cycle; every cycle finite, the last-30 RMSE below 1.0,
    cycle 0's analysis against the plain ``ensrf_blocked`` on the same
    tensors, a checkpoint saved halfway and loaded into a fresh harness
    reproducing the uninterrupted run bit for bit; then 5 cycles each of
    the LETKF and the EnKF, finite and below the free run's RMSE;
22. the multivariate shallow-water OSSE of ``examples/multivariate_swe.py``
    on a 128 x 256 channel (98,304 rows of eta, u, v), 40 members, eta obs
    at every 2nd point (16,384 obs, R 1e-4), 500 km, RTPS 0.5, 10 steps a
    cycle, 10 cycles, float32: spin-up seconds, per-cycle forecast and
    analysis seconds, B1/B4 launches a cycle, background and analysis
    RMSE per variable; cycle 0 against the plain ``ensrf_blocked``, every
    analysis finite, the never-observed u and v improved on cycle 0, the
    forecast against float64 on the CPU for 3 steps;
23. the observation pipeline of ``examples/obs_pipeline.py`` on phase 4's
    grid: 100,000 raw obs of a smooth truth as a DataFrame (20%
    duplicates), ``from_dataframe``, ``superob`` at 0.25 deg,
    ``thin_by_distance`` at 25 km, ``sort_spatially``, ``EnSRF`` with
    ``fast_geometry`` and ``spatial_sort`` (B1 + B2) with one custom
    forward operator in the batch, then ``obs_assimilation_statistics``,
    ``desroziers_diagnostics``, ``field_verification`` and ``interpolate``
    / ``nearest_points`` / ``isel`` / ``sel`` on the posterior, each held
    against NumPy on the host copy; the host seconds of each step and the
    obs count after each thinning step;
24. what ``cli target`` runs once a state is read, on phase 4's workload
    in float64 (the CLI's default there): ``region_mean_metric`` over a
    lat/lon box, ``ensemble_sensitivity`` with a 95% significance mask,
    ``observation_impact`` on 2,000 candidates and a greedy network of 10,
    each held against NumPy float64 on the host copy (greedy's first pick
    the ranking's best), no kernel launched; host seconds of each step.
    Its line says whether h5py is installed: the CLI's netCDF steps
    need it, and without it they do not run here (the tests hold the CLI
    against the JAX package's on the CPU);
25. the mesh on the card (``mesh=``, ``parallel/``): a mesh of 2-4
    repeats of the one card, each case held against the single-device
    update on the same inputs: (a) phase 4's workload on 4 shards (B1 +
    B2), (b) phase 9's on 3 (1,048,576 rows are not a multiple of 3: the
    padding runs; B1 + B4), (c) phase 11 (a)'s hybrid config on 2 (B1h +
    B2h), (d) the EnKF at config 11 (B1e + B2e) and the LETKF at config
    6 with ``letkf_topk="host"`` on 2 (NS; the host selection rebuilt for
    2 shards), at the f32 kernel gate; (e) ``make_mesh()`` with its
    defaults, one device here, bit for bit; the launches (B1 once per
    panel, on the mesh's first device, B2, B4 and B2h once per shard in
    the body plus the tail's applies), the max abs error and whether it
    is bitwise, and host seconds of the single-device update and of the
    mesh update's parts (pad, split, replicate, tail, shards, gather);
26. the body kernels' product modes (``matmul_precision``, ``mxu_bf16``;
    ``ops/precision.py``): (a) B2 and B2h at phase 3's shape, B3 at
    config 3's (with a group factor) and B4 at one block of config 3 and
    of the 1024 x 1024 x 80 grid, each in fp32 against its plain version
    and in TF32 and bf16 at gate (a) (``hold_mode``: one obs block at a
    time against the plain version in float64, per entry with a flip
    allowance and per member column as a share of the mode's effect,
    beside planted faults that must fail), every tensor-core output
    unlike the fp32 one, kernel ms, plain ms and the bound (the products
    at the mode's tensor-core peak), then phases 3, 6, 7 and 10's edge
    cases in TF32 and bf16 at gate (a); (b)
    ``EnSRF.update()`` on phase 4's workload (B2, B4, B2h) and on config
    3 (B4, B3) at ``matmul_precision`` None, "highest", "tensorfloat32",
    "bfloat16" and at ``mxu_bf16``: wall, the launches (the fp32 update's
    counts; the body's in its mode, every other one in fp32), and the
    posterior mean and perturbations against the fp32 update as a share
    of the increment RMS (``API_MODE_GATE``: 2e-3 TF32, 1e-2 bf16; a
    setting whose mode is fp32 gives the fp32 posterior bit for bit),
    and ``mxu_bf16`` on a mesh of 2 shards of the card against the
    single-device update, one B2 body per shard in bf16.
27. the port's examples (``efa_xray_tpu_torch/examples``): (a) each at
    its default arguments through its compute steps on the card
    (``gridded_assimilation`` with the EnSRF, the LETKF and ``--mesh``,
    ``obs_pipeline`` with each solver, ``sensitivity_targeting``,
    ``cycling_adaptive``, ``cycling_smoother`` with and without ``--iau
    4``, ``multivariate_swe``, ``efa_demo``): wall, launches and the
    numbers the script prints, its own assertions holding, held against
    the same example on the CPU in the same process (float32 at the f32
    gate, float64 at 1e-9; the cyclers at their first analysis, the rest
    of the chaotic run reported; the float32 LETKF at phase 19's gate
    against the CPU's and the float64 one); (b) ``gridded_assimilation`` at
    BASELINE config 2's size (361 x 720 x 8 lead times, 40 members, 2,000
    obs) through the EnSRF (B1 + B4, held against the plain blocked
    update), the LETKF and a mesh of the card (bit for bit the EnSRF),
    cold and warm walls, launches, peak memory and the obs-space and
    field RMSE; (c) ``real_data_ingest``'s in-process part (the station
    CSV through ``cli.read_obs_csv``, the CLI's update and its RMSE
    check), against the CPU;
28. BASELINE config 4 through ``mesh=`` at full size, and the overlap of
    the shards on distinct cards: (a) the headline's 1e7 rows x 80 x
    10,000 obs through ``ensrf_update_sharded`` on ``make_mesh()`` (every
    card; one here) against the single-device B1/B2 tail and B2 body,
    bit for bit on one card, at the f32 gate on several; B1 once per
    panel, B2 once per panel and once per card; (b) with several cards,
    the EnKF at config 11 (B1e + B2e), the LETKF at config 6 (top-k exact
    and host) and at config 7 (``letkf_update_sharded``, top-k exact; NS
    on every card), over every card against the single-device update.
    Each update warm, timed with no synchronize inside it (every card
    synchronized around it), its peak memory per card; the mesh update
    once more by parts; and on the card one more mesh update traced by
    ``torch.profiler``: each card's busy seconds and first and last
    device event, the device window and the effective parallelism (busy
    seconds summed over the window); and one more with the shards' issue
    watched for synchronizing calls (none allowed).

Then one JSON line describing each kernel (its launches on the main path,
its time, its plain version's, the least time the card could take for the
same work and, for P, the library call's) and, last, the device line.

``--profile`` replaces phases 2-28 with one warm headline update, the
warm ``EnSRF.update()`` of phase 4 and the hybrid one of phase 11 (a) on
phase 4's workload, and the two config-3 updates of phase 8 under
``torch.profiler`` (the profiler walks every traced event): wall and
device-busy time, the busy share, the device ops that take the most time,
and the share of the headline's (row tile, obs block) pairs and 8-ob
panels that the cull keeps alive.

``--steps`` replaces phases 2-28 with B1 at 512 x 80 and 1024 x 256 at
sub-panels of 8 and 16 on one CTA and on each cluster that holds the
panel, the parent commit's B1 beside them where
``build/efa_xray_tpu_torch/parent/tail_solve.cu`` exists, and B1 at 512 x
80 with parts compiled out (``-DEFA_TAIL_SKIP``); then B2 timed on phase
3's workload and
on the headline body with parts of its design switched off (dead panels
solved instead of skipped, a tile of 64 rows instead of 32 rows with two
CTAs per SM), each held against the kernel's own result; then with the
grid kernel (B3 at config 3's shape and at 80 members, B4 at phase 7's
shapes) at tiles of 32 and 64 points, with parts of it compiled out
(``-DEFA_GRID_SKIP``: what the chain, the trailing update, D0 and the apply
cost) and, where ``build/efa_xray_tpu_torch/parent/ensrf_grid.cu`` exists,
the kernel of that file on the same operands; then the product modes
(``mode_steps_phase``): B2 and B2h on phase 3's workload, B3 at config 3's
shape and B4 at one block of config 3 and of the 1024 x 1024 x 80 grid,
each in fp32 (bit for bit the parent's), TF32 and bf16 beside the kernel
of ``build/efa_xray_tpu_torch/parent/ensrf_fused.cu`` / ``ensrf_grid.cu``
where those exist, with the mode kernels' parts compiled out
(``-DEFA_FUSED_SKIP``, ``-DEFA_GRID_SKIP``: the rounding of L, D0, the
apply; ``-DEFA_MMA_PROBE``: the mma instructions, the fragment loads),
each kernel's modes at both tiles, and whether the fp32
instantiations compile to the parent's machine code; then NS on config
6's and 7's first chunks and at 200 members beside the plain loop and the
kernel of ``build/efa_xray_tpu_torch/parent/newton_schulz.cu`` where that
exists (``ns_steps_phase``).  Put the parent
commit's sources there with ``git show
<commit>:efa_xray_tpu_torch/csrc/<file>`` (``mma_modes.cuh`` too; the
directory is git-ignored).

Any failure raises and exits non-zero; without a GPU the script exits
non-zero before doing anything.  It never imports JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
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


def compare_sum(name: str, got, want, scale) -> float:
    """:func:`compare` for entries that are sums of terms which cancel:
    each entry within atol 2e-4 + rtol 2e-5 x (its value + ``scale``, the
    summed magnitude of its terms).  Returns the max abs error."""
    import torch

    g, w = got.double(), want.double()
    check(bool(torch.equal(torch.isnan(g), torch.isnan(w))),
          f"{name}: NaN pattern differs")
    err = (g - w).abs().nan_to_num(0.0)
    bad = err > ATOL + RTOL * (w.abs().nan_to_num(0.0) + scale.double())
    check(not bool(bad.any()),
          f"{name}: {int(bad.sum())} elements outside atol {ATOL} + rtol "
          f"{RTOL} x (|value| + the terms' magnitude); max abs err "
          f"{float(err.max()):.3e}")
    return float(err.max())


def cuda_ms(fn, reps: int, inner: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events;
    each run is ``inner`` calls back to back (for calls so short that one
    alone would time the host's launch path)."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, reps: int, inner: int = 10) -> float:
    """Median device milliseconds of one ``fn()`` over ``reps`` runs of
    ``inner`` calls, each run queued behind a spin of the card
    (``torch.cuda._sleep``) so that the host has issued all of its calls
    before the card starts on them: the events time the card alone, not
    the host's pace (for kernels shorter than their own issue)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def cuda_timed(fn):
    """``fn()`` once: ``(its result, its milliseconds by CUDA events)``
    (a plain version, slow enough that one run times it, is timed on the
    run that is compared)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# TFLOP/s by operand type, and the HBM rate in TB/s.
PEAK_TFLOPS = {"fp32": 67.0, "tf32": 495.0, "bf16": 989.0}
HBM_TBPS = 3.35
# Operations per (ob, row) pair of B2's weight chain (chordal angle,
# Gaspari-Cohn, vertical factor), and what B2h's static column adds (its
# Gaspari-Cohn and the sigma, mean and V terms), counted from
# csrc/ensrf_fused.cu.
B2_PAIR_OPS = 40
B2H_PAIR_OPS = 25


def nbytes(*tensors) -> int:
    """Bytes of the tensors, None skipped, a tuple (B4's ``Geometry``)
    by its tensors."""
    return sum(nbytes(*t) if isinstance(t, tuple) else
               t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flop: float, nbyte: float, peak: str = "fp32") -> dict:
    """The least time the card could take: the larger of ``flop`` at the
    peak rate of ``peak`` and ``nbyte`` at the HBM rate."""
    ops_ms = flop / (PEAK_TFLOPS[peak] * 1e12) * 1e3
    bytes_ms = nbyte / (HBM_TBPS * 1e12) * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def body_flop(rows: int, nblocks: int, bsz: int, nmems: int,
              part: str = "all", sub: int | None = None) -> float:
    """Operations of the dense body sweep (B3, B4) over ``rows`` rows and
    ``nblocks`` blocks of ``bsz`` obs: D0 and the rank-B apply (4 M per
    (ob, row); ``part="products"``), the forward substitution (S per (ob,
    row) on average, S the ``sub`` obs a launch solves at a time: the
    block, or the plan's sub-block of it) and the weight and mean terms
    (3 per (ob, row); ``part="rest"``)."""
    s = bsz if sub is None else min(sub, bsz)
    per_pair = {"all": 4 * nmems + s + 3, "products": 4 * nmems,
                "rest": s + 3}[part]
    return float(rows) * nblocks * bsz * per_pair


def mode_bound(products: float, rest: float, nbyte: float,
               mode: str) -> dict:
    """:func:`bound` for a body kernel whose two large products run in
    ``mode`` ("ieee", "tf32", "bf16"): the products at that mode's peak
    (fp32 in "ieee"), the rest at the fp32 peak.  The tensor cores and the
    fp32 units run side by side, so the operations take at least the
    longer of the two times."""
    if mode == "ieee":
        return bound(products + rest, nbyte)
    ops_ms = max(products / (PEAK_TFLOPS[mode] * 1e12),
                 rest / (PEAK_TFLOPS["fp32"] * 1e12)) * 1e3
    bytes_ms = nbyte / (HBM_TBPS * 1e12) * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def b2_flop(ops: dict, nrows: int, nmems: int, localize: bool,
            hybrid: bool, part: str = "all", sub: int | None = None) -> float:
    """Operations B2/B2h need on prepared operands ``ops``: as
    :func:`body_flop` (and its ``part`` and ``sub``), but only over the
    8-ob panels the cull keeps alive, plus the per-pair weight chain (and
    B2h's static column) in the rest."""
    import torch

    from efa_xray_tpu_torch.ops import ensrf_fused

    nblocks, bsz, _ = ops["y_b"].shape
    tile = ops["tile"]
    gtiles = -(-nrows // tile)
    npanels = -(-bsz // ensrf_fused.PANEL)
    if ops["bits"] is None:
        alive = gtiles * nblocks * npanels
    else:
        bits = ops["bits"].to(torch.int64) & 0xFFFFFFFF
        alive = sum(int(((bits >> q) & 1).sum()) for q in range(npanels))
    pair = ((B2_PAIR_OPS if localize or hybrid else 0)
            + (B2H_PAIR_OPS if hybrid else 0))
    s = bsz if sub is None else min(sub, bsz)
    per_pair = {"all": 4 * nmems + s + 3 + pair, "products": 4 * nmems,
                "rest": s + 3 + pair}[part]
    return alive * ensrf_fused.PANEL * (nrows / gtiles) * per_pair


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


# B1's edge cases in phase 2: label, panel, members, geometry ("chordal",
# "haversine", "unlocalized"), vertical, varloc, hybrid, unbiased, share of
# obs assimilated.
B1_CASES = (
    ("512 x 80 chordal", 512, 80, "chordal", False, False, False, False, 0.9),
    ("512 x 80 haversine + vertical", 512, 80, "haversine", True, False,
     False, False, 0.9),
    ("512 x 80 haversine + varloc", 512, 80, "haversine", False, True, False,
     False, 0.9),
    ("512 x 80 hybrid (B1h)", 512, 80, "haversine", False, False, True,
     False, 0.9),
    ("512 x 80 unlocalized", 512, 80, "unlocalized", False, False, False,
     False, 0.9),
    ("1024 x 80", 1024, 80, "chordal", False, False, False, False, 0.9),
    ("512 x 128", 512, 128, "chordal", False, False, False, False, 0.9),
    ("512 x 256", 512, 256, "chordal", False, False, False, False, 0.9),
    ("1024 x 256", 1024, 256, "chordal", False, False, False, False, 0.9),
    ("512 x 30", 512, 30, "chordal", False, False, False, False, 0.9),
    ("1024 x 256 hybrid (B1h)", 1024, 256, "haversine", True, False, True,
     False, 0.9),
    ("300 x 50 (padded)", 300, 50, "haversine", False, False, False, False,
     0.9),
    ("512 x 80 unbiased", 512, 80, "chordal", False, False, False, True,
     0.9),
    ("512 x 80 all obs skipped", 512, 80, "chordal", False, False, False,
     False, 0.0),
    ("1024 x 512, slab in device memory", 1024, 512, "chordal", False,
     False, False, False, 0.9),
    ("1024 x 512 hybrid (B1h), slab in device memory", 1024, 512,
     "haversine", False, False, True, False, 0.9),
)


def _b1_case(p, m, geometry, vertical, varloc, hybrid, assim_share, seed):
    """One panel on the card: the B1 (B1h) arguments, weights built as
    ``tail_scan_blocked`` builds them.  Returns ``(args, kwargs)``."""
    import torch

    from efa_xray_tpu_torch.assimilation import ensrf_core as core
    from efa_xray_tpu_torch.observation.localization import (
        hilbert3d_np,
        latlon_to_unit,
    )

    dev = torch.device("cuda")
    f32 = torch.float32
    rng = np.random.default_rng(seed)
    lat = rng.uniform(20.0, 60.0, p)
    lon = rng.uniform(200.0, 280.0, p)
    o = np.argsort(hilbert3d_np(lat, lon), kind="stable")
    lat, lon = lat[o], lon[o]
    ye = rng.normal(280.0, 5.0, (p, m))
    t = lambda x: torch.tensor(x, dtype=f32, device=dev)
    tm = t(ye.mean(1))
    tp = t(ye - ye.mean(1, keepdims=True))
    pob = core.ObsArrays(
        values=tm + t(rng.normal(0, 1.5, p)), errors=t(rng.uniform(0.5, 2, p)),
        lats=t(lat), lons=t(lon), radii=torch.full((p,), 2000.0, device=dev),
        assim=torch.tensor(rng.random(p) < assim_share, device=dev),
        verts=t(rng.uniform(200.0, 1000.0, p)),
        vert_radii=torch.full((p,), 300.0, device=dev))
    vkw = {}
    if varloc:
        vkw = dict(varloc=t(rng.choice([0.0, 0.3, 1.0], (5, 4))),
                   ob_var=torch.tensor(rng.integers(0, 4, p), device=dev))
    pxyz = (latlon_to_unit(pob.lats, pob.lons) if geometry == "chordal"
            else None)
    w = core.panel_weights(pxyz, pob, vertical, f32,
                           localize=geometry != "unlocalized", **vkw)
    kw = {}
    if hybrid:
        kw = dict(alpha=0.5, sigma=t(rng.uniform(2.0, 4.0, p)),
                  static_gc=core.static_weights(pob, 1000.0, f32))
    return (tm, tp, pob.values, pob.errors, pob.assim, w), kw


def b1_flop(p: int, m: int, hybrid: bool) -> float:
    """Operations of a serial solve of ``p`` obs on ``p`` rows: per step
    the [P, M] covariance product and rank-1 update (4 P M), the weight,
    mean and coefficient terms (4 P; B1h's static column 4 P more) and
    the variance (6 M)."""
    return float(p) * (4 * p * m + (8 if hybrid else 4) * p + 6 * m)


def phase2():
    """B1 and B1h against the serial plain version over the edge cases of
    ``B1_CASES``, with the shared memory the wrapper plans checked against
    the kernel's own layout."""
    import torch

    from efa_xray_tpu_torch.ops import _build, tail_solve

    rows, out = [], {}
    for n, (label, p, m, geometry, vertical, varloc, hybrid, unbiased,
            share) in enumerate(B1_CASES):
        args, kw = _b1_case(p, m, geometry, vertical, varloc, hybrid, share,
                            11 + n)
        c = tail_solve.pick_cluster(p, m, tail_solve.DEFAULT_SUB, hybrid)
        pp = tail_solve.padded_panel(p, tail_solve.DEFAULT_SUB, c)
        planned = tail_solve.smem_bytes(
            pp // c, m, hybrid=hybrid, device_slab=tail_solve.in_device_memory(
                pp, m, tail_solve.DEFAULT_SUB, c, hybrid))
        built = _build.lib().efa_tail_solve_smem(
            pp // c, m, tail_solve.DEFAULT_SUB, int(hybrid))
        check(planned == built, f"B1 {label}: the wrapper plans {planned} B "
              f"of shared memory, the kernel lays out {built}")
        got = tail_solve.tail_panel_solve(*args, unbiased=unbiased, **kw)
        want, p_ms = cuda_timed(lambda: tail_solve.tail_panel_solve_plain(
            *args, unbiased=unbiased, **kw))
        torch.cuda.synchronize()
        check(len(got) == len(want) == (11 if hybrid else 9),
              f"B1 {label}: {len(got)} outputs")
        err = max(compare(f"B1 {label} out{k}", a, b)
                  for k, (a, b) in enumerate(zip(got, want)))
        moved = (float((want[1] - args[1]).abs().max())
                 if share > 0 else 1.0)
        check(moved > 1e-3 if share > 0 else
              bool(torch.equal(got[1], args[1])),
              f"B1 {label}: the tail did not move as it should")
        k_ms = cuda_ms(lambda: tail_solve.tail_panel_solve(
            *args, unbiased=unbiased, **kw), 10)
        r = dict(label=label, cluster=c, max_abs_err=err, ms=k_ms,
                 plain_ms=p_ms, us_per_ob=1e3 * k_ms / p,
                 **bound(b1_flop(p, m, hybrid),
                         nbytes(*args, kw.get("sigma"),
                                kw.get("static_gc")) + nbytes(*got)))
        rows.append(r)
        if label == "512 x 80 chordal":
            out["B1"] = r
        if label == "512 x 80 hybrid (B1h)":
            out["B1h"] = r
        del args, kw, got, want
    log("phase 2: B1/B1h match the serial plain version: " + "; ".join(
        f"{r['label']} ({r['cluster']} CTA{'s' if r['cluster'] > 1 else ''})"
        f": err {r['max_abs_err']:.3e} kernel {r['ms']:.3f} ms "
        f"({r['us_per_ob']:.3f} us per ob) plain {r['plain_ms']:.1f} ms bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']})" for r in rows))
    worst = max(r["max_abs_err"] for r in rows)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    res = {name: dict(max_abs_err=worst, **{k: r[k] for k in keys})
           for name, r in out.items()}
    res["B1e"] = _b1e_cases()
    return res


# B1e's edge cases in phase 2 (the EnKF's panel solve): label, panel,
# members, geometry, vertical, varloc, unbiased, share of obs assimilated.
# The first is config 11's panel (phase 18's main path).
B1E_CASES = (
    ("512 x 40 chordal (config 11's panel)", 512, 40, "chordal", False,
     False, False, 1.0),
    ("512 x 80 haversine + vertical", 512, 80, "haversine", True, False,
     False, 0.9),
    ("512 x 80 haversine + varloc", 512, 80, "haversine", False, True,
     False, 0.9),
    ("512 x 80 unlocalized, half assimilated", 512, 80, "unlocalized",
     False, False, False, 0.5),
    ("1024 x 80", 1024, 80, "chordal", False, False, False, 0.9),
    ("512 x 256", 512, 256, "chordal", False, False, False, 0.9),
    ("1024 x 256", 1024, 256, "chordal", False, False, False, 0.9),
    ("300 x 50 (padded), unbiased", 300, 50, "haversine", False, False,
     True, 0.9),
    ("512 x 40 all obs skipped", 512, 40, "chordal", False, False, False,
     0.0),
    ("1024 x 512, slab in device memory", 1024, 512, "chordal", False,
     False, False, 0.9),
)


def _b1e_cases():
    """B1e against its serial plain version over :data:`B1E_CASES`, each
    with draws ``eps`` of the obs' error variance, the wrapper's shared
    memory against the kernel's layout; kernel and plain ms of the first
    case.  Returns its kernels-line entry."""
    import torch

    from efa_xray_tpu_torch.ops import _build, tail_solve

    rows = []
    for n, (label, p, m, geometry, vertical, varloc, unbiased,
            share) in enumerate(B1E_CASES):
        args, _ = _b1_case(p, m, geometry, vertical, varloc, False, share,
                           41 + n)
        gen = torch.Generator(device="cuda").manual_seed(51 + n)
        eps = torch.randn((p, m), generator=gen, device="cuda")
        eps = (eps - eps.mean(1, keepdim=True)) * torch.sqrt(args[3])[:, None]
        c = tail_solve.pick_cluster(p, m, enkf=True)
        pp = tail_solve.padded_panel(p, tail_solve.DEFAULT_SUB, c)
        planned = tail_solve.smem_bytes(
            pp // c, m, enkf=True, device_slab=tail_solve.in_device_memory(
                pp, m, tail_solve.DEFAULT_SUB, c, enkf=True))
        built = _build.lib().efa_tail_solve_smem(
            pp // c, m, tail_solve.DEFAULT_SUB, 2)
        check(planned == built, f"B1e {label}: the wrapper plans {planned} "
              f"B of shared memory, the kernel lays out {built}")
        got = tail_solve.tail_panel_solve(*args, unbiased=unbiased, eps=eps)
        want, p_ms = cuda_timed(lambda: tail_solve.tail_panel_solve_plain(
            *args, unbiased=unbiased, eps=eps))
        torch.cuda.synchronize()
        check(len(got) == len(want) == 10, f"B1e {label}: {len(got)} "
              "outputs")
        err = max(compare(f"B1e {label} out{k}", a, b)
                  for k, (a, b) in enumerate(zip(got, want)))
        check(float((want[1] - args[1]).abs().max()) > 1e-3 if share > 0
              else bool(torch.equal(got[1], args[1])),
              f"B1e {label}: the tail did not move as it should")
        r = dict(label=label, cluster=c, max_abs_err=err)
        if n == 0:
            r["ms"] = cuda_ms(lambda: tail_solve.tail_panel_solve(
                *args, unbiased=unbiased, eps=eps), 10)
            r["plain_ms"] = p_ms
            r.update(bound(b1_flop(p, m, False) + 4.0 * p * m,
                           nbytes(*args, eps) + nbytes(*got)))
        rows.append(r)
    head = rows[0]
    log("phase 2: B1e matches the serial plain version: " + "; ".join(
        f"{r['label']} ({r['cluster']} CTAs): err {r['max_abs_err']:.3e}"
        for r in rows) + f"; {head['label']}: kernel {head['ms']:.3f} ms "
        f"plain {head['plain_ms']:.1f} ms bound {head['bound_ms']:.4f} ms "
        f"({head['bound_by']})")
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                **{k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")})


@functools.lru_cache(maxsize=None)
def _scattered_np(n, nobs, seed):
    """:func:`_scattered`'s host arrays and the state of its generator
    after them, drawn once per ``(n, nobs, seed)`` (the Hilbert sort of
    1e7 rows takes seconds; phases 5 and 28 draw the same rows)."""
    from efa_xray_tpu_torch.observation.localization import hilbert3d_np

    rng = np.random.default_rng(seed)
    lat = rng.uniform(-88.0, 88.0, n)
    lon = rng.uniform(0.0, 360.0, n)
    ro = np.argsort(hilbert3d_np(lat, lon), kind="stable")
    lat, lon = lat[ro], lon[ro]
    rows = rng.integers(0, n, nobs)
    olat, olon = lat[rows], lon[rows]
    oo = np.argsort(hilbert3d_np(olat, olon), kind="stable")
    return lat, lon, olat[oo], olon[oo], rng.bit_generator.state


def _scattered(n, nobs, seed, dev):
    """Hilbert-ordered scattered rows and obs drawn from the rows, drawn
    as bench.py's build_workload draws them; also returns the generator
    for the draws that follow there."""
    import torch

    *arrays, state = _scattered_np(n, nobs, seed)
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    f32 = torch.float32
    return (*(torch.tensor(x, dtype=f32, device=dev) for x in arrays), rng)


@functools.lru_cache(maxsize=None)
def _b2_edge_base(hybrid: bool, dev):
    """:func:`_b2_edge_inputs`'s rows, obs, states and their plain tails
    (seven per-ob scans), made once per ``(hybrid, dev)``: phases 3, 10
    and 26 hold B2, B2e and B2h on them.  Nothing that takes them
    updates them in place."""
    import torch

    from efa_xray_tpu_torch.assimilation import ensrf_core as core

    n, nobs = 20_001, 300
    lat, lon, olat, olon, _ = _scattered(n, nobs, 31 + hybrid, dev)
    gen = torch.Generator(device=dev).manual_seed(32 + hybrid)
    rnd = lambda *shape: torch.rand(*shape, generator=gen, device=dev)
    bm = 280.0 + 0.5 * torch.randn(n, generator=gen, device=dev)
    body_sigma = 2.0 + 2.0 * rnd(n)
    body_vert = 100.0 + 900.0 * rnd(n)
    obs = core.ObsArrays(
        values=280.0 + torch.randn(nobs, generator=gen, device=dev),
        errors=torch.ones(nobs, device=dev), lats=olat, lons=olon,
        radii=torch.full((nobs,), 2000.0, device=dev),
        assim=rnd(nobs) > 0.1, verts=100.0 + 900.0 * rnd(nobs),
        vert_radii=torch.full((nobs,), 300.0, device=dev))
    tail_sigma = 2.0 + 2.0 * rnd(nobs)
    slen = 1000.0
    state, tails = {}, {}
    for m in (12, 21, 30, 50, 80, 128, 256):
        state[m] = 5.0 * torch.randn(n, m, generator=gen, device=dev)
        tp0 = 5.0 * torch.randn(nobs, m, generator=gen, device=dev)
        tails[m] = core.tail_scan_blocked(
            tp0.mean(1) + 280.0, tp0 - tp0.mean(1, keepdim=True), obs,
            localize=True, fast_geometry=True, panel=512,
            **(dict(hybrid_alpha=0.5, tail_sigma=tail_sigma,
                    static_length=slen) if hybrid else {}))
    return (lat, lon, bm, body_sigma, body_vert, obs, slen, state, tails)


def _b2_edge_inputs(hybrid: bool, dev="cuda"):
    """B2's (B2h's with ``hybrid``) small shapes chosen for the edges of
    the kernel's tiling: 20,001 rows (a ragged last tile), 300 obs (a
    padded last block), ensembles of 12, 21, 30, 50, 80, 128 (the tile of
    64 rows, 8 members per thread in the apply) and 256 (one CTA of 32
    rows per SM, 16 members per thread), block sizes 128, 100 and 50 (a
    last panel narrower than 8 obs, copies of 4 bytes), cull words with
    one alive panel, cull off, unlocalized, vertical localization, the
    arccos form, and an in-place update.  Yields ``(label, bm, bp, args,
    donate)``: ``args`` follow ``bm, bp`` in ``fused_apply``."""
    import torch

    from efa_xray_tpu_torch.ops import ensrf_fused

    dev = torch.device(dev)
    nobs = 300
    (lat, lon, bm, body_sigma, body_vert, obs, slen, state,
     tails) = _b2_edge_base(hybrid, dev)
    for label, m, bsz, localize, vertical, radius, cull, one, donate in (
            ("12 members", 12, 128, True, False, 2000.0, True, False, False),
            ("21 members", 21, 128, True, False, 2000.0, True, False, False),
            ("30 members", 30, 128, True, False, 2000.0, True, False, False),
            ("50 members", 50, 128, True, False, 2000.0, True, False, False),
            ("128 members, tile 64", 128, 128, True, False, 2000.0, True,
             False, False),
            ("256 members, one CTA per SM", 256, 128, True, False, 2000.0,
             True, False, False),
            ("80 members, blocks of 100", 80, 100, True, False, 2000.0, True,
             False, False),
            ("30 members, blocks of 50", 30, 50, True, False, 2000.0, True,
             False, False),
            ("one alive panel per block", 80, 128, True, False, 2000.0, True,
             True, False),
            ("cull off", 80, 128, True, False, 2000.0, False, False, False),
            ("unlocalized", 80, 128, False, False, None, False, False, False),
            ("vertical", 80, 128, True, True, 2000.0, True, False, False),
            ("arccos form", 80, 128, True, False, 6000.0, True, False, False),
            ("in place", 80, 128, True, False, 2000.0, True, False, True)):
        o = obs if radius is None else obs._replace(
            radii=torch.full((nobs,), radius, device=dev))
        ops = ensrf_fused.prepare(
            state[m], lat, lon, tails[m], o,
            body_vert=body_vert if vertical else None, localize=localize,
            block_size=bsz, cull=cull, max_radius_km=radius, hybrid=hybrid,
            body_sigma=body_sigma if hybrid else None,
            static_length=slen if hybrid else None)
        bits = ops["bits"]
        check(ops["tile"] == (64 if m == 128 else 32),
              f"edge case {label}: tile {ops['tile']}")
        if one:
            tiles, blocks = bits.shape
            npanels = -(-bsz // ensrf_fused.PANEL)
            q = (torch.arange(tiles, device=dev)[:, None]
                 + torch.arange(blocks, device=dev)[None, :]) % npanels
            bits = (torch.ones_like(q) << q).to(torch.int32)
        yield label, bm, state[m], (
            ops["geom"], ops["y_b"], ops["ggt_b"], ops["tab_b"], bits,
            ops["tile"], localize, vertical, ops["series"], hybrid), donate


def _b2_edge_cases(hybrid: bool):
    """B2 (B2h with ``hybrid``) against its plain version at each of
    :func:`_b2_edge_inputs`'s shapes.  Returns ``(max abs err, labels)``."""
    import torch

    from efa_xray_tpu_torch.ops import ensrf_fused

    worst, labels = 0.0, []
    for label, bm, bp, args, donate in _b2_edge_inputs(hybrid):
        want = ensrf_fused.fused_apply_plain(bm, bp, *args)
        gm, gp = (bm.clone(), bp.clone()) if donate else (bm, bp)
        got = ensrf_fused.fused_apply(gm, gp, *args, donate=donate)
        torch.cuda.synchronize()
        name = f"{'B2h' if hybrid else 'B2'} edge case {label}"
        if donate:
            check(got[0].data_ptr() == gm.data_ptr()
                  and got[1].data_ptr() == gp.data_ptr(),
                  f"{name}: not updated in place")
        check(float((want[1] - bp).abs().max()) > 1e-2,
              f"{name}: the plain version did not move the state")
        worst = max(worst, compare(f"{name} mean", got[0], want[0]),
                    compare(f"{name} perts", got[1], want[1]))
        labels.append(label)
    return worst, labels


def _b2_workload(dev="cuda", n=262_144, m=80, nobs=2048):
    """Phase 3's workload on the card: 262,144 Hilbert-ordered rows x 80
    members, 2048 obs at 2000 km, and their pre-solved sequence from the
    B1/B2 tail.  Returns a dict of tensors."""
    import torch

    from efa_xray_tpu_torch.assimilation import ensrf_core as core

    dev = torch.device(dev)
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
    return dict(n=n, m=m, nobs=nobs, lat=lat, lon=lon, bm=bm, bp=bp, obs=obs,
                tail=tail, tm=tm, tp=tp, gen=gen)


def phase3():
    """B2 against its plain version at 262,144 rows x 80 x 2048 obs."""
    import torch

    from efa_xray_tpu_torch.ops import ensrf_fused

    dev = torch.device("cuda")
    w = _b2_workload()
    n, m, nobs = w["n"], w["m"], w["nobs"]
    lat, lon, bm, bp, obs, tail = (w[k] for k in ("lat", "lon", "bm", "bp",
                                                  "obs", "tail"))
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
        want, p_ms = cuda_timed(lambda: ensrf_fused.fused_apply_plain(*args))
        torch.cuda.synchronize()
        err = max(compare(f"B2 rows={rows} cull={cull} r={radius} mean",
                          got[0], want[0]),
                  compare(f"B2 rows={rows} cull={cull} r={radius} perts",
                          got[1], want[1]))
        alive = (float((ops["bits"] != 0).float().mean())
                 if ops["bits"] is not None else 1.0)
        k_ms = cuda_ms(lambda: ensrf_fused.fused_apply(*args), 3)
        results.append(dict(
            rows=rows, cull=cull, radius=radius,
            form="series" if ops["series"] else "arccos",
            alive_tile_blocks=alive, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
            **bound(b2_flop(ops, rows, m, True, False),
                    nbytes(*args[:7]) + nbytes(*got))))
    log("phase 3: B2 matches plain: " + "; ".join(
        f"rows {r['rows']} cull {r['cull']} {r['form']} (alive tile-blocks "
        f"{r['alive_tile_blocks']:.3f}): err {r['max_abs_err']:.3e} kernel "
        f"{r['ms']:.2f} ms plain {r['plain_ms']:.2f} ms bound "
        f"{r['bound_ms']:.3f} ms ({r['bound_by']})" for r in results))
    edge_err, edge_labels = _b2_edge_cases(hybrid=False)
    log(f"phase 3: B2 matches plain at 20,001 rows x 300 obs (max abs err "
        f"{edge_err:.3e}): " + ", ".join(edge_labels))
    _b2e_cases(w)
    head = results[0]
    return dict(max_abs_err=max([edge_err] + [r["max_abs_err"]
                                              for r in results]),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"])


def _draws(ye, seed):
    """Centred draws ``eps`` shaped like ``ye`` (unit variance), on its
    device."""
    import torch

    gen = torch.Generator(device=ye.device).manual_seed(seed)
    eps = torch.randn(ye.shape, generator=gen, device=ye.device)
    return eps - eps.mean(dim=-1, keepdim=True)


def _with_z(args, seed):
    """B2's prepared operands (``fused_apply``'s after ``bm, bp``) turned
    into B2e's: departure rows ``z_b = y_b - eps``, the Gram tables from
    them, the chordal angle form.  Returns ``(args, z_b)``."""
    import torch

    from efa_xray_tpu_torch.ops import ensrf_fused

    geom, y_b, _, tab_b, bits, tile, localize, vertical, _, hybrid = args
    z_b = (y_b - _draws(y_b, seed)).contiguous()
    gram = torch.bmm(z_b, y_b.transpose(1, 2))
    ggt_b = (gram * tab_b[:, 1, :, None]).transpose(1, 2).contiguous()
    return (geom, y_b, ggt_b, tab_b, bits, tile, localize, vertical,
            ensrf_fused.CHORDAL_FORM, hybrid), z_b


def _b2e_cases(w):
    """B2e against its plain version: phase 3's workload (cull on, 2000
    km, and the cull off) and phase 3's edge cases, each with departure
    rows ``z = ye - eps`` (the chordal form).  Returns the max abs
    error."""
    import torch

    from efa_xray_tpu_torch.ops import ensrf_fused

    worst, labels = 0.0, []
    cases = []
    for cull in (True, False):
        ops = ensrf_fused.prepare(w["bp"], w["lat"], w["lon"], w["tail"],
                                  w["obs"], block_size=128, cull=cull,
                                  max_radius_km=2000.0)
        cases.append((f"262,144 x 80 x 2048, cull {cull}", w["bm"], w["bp"],
                      (ops["geom"], ops["y_b"], ops["ggt_b"], ops["tab_b"],
                       ops["bits"], ops["tile"], True, False, ops["series"],
                       False), False))
    cases += list(_b2_edge_inputs(False))
    for n, (label, bm, bp, args, donate) in enumerate(cases):
        args, z_b = _with_z(args, 61 + n)
        want = ensrf_fused.fused_apply_plain(bm, bp, *args, z_b=z_b)
        gm, gp = (bm.clone(), bp.clone()) if donate else (bm, bp)
        got = ensrf_fused.fused_apply(gm, gp, *args, donate=donate, z_b=z_b)
        torch.cuda.synchronize()
        check(float((want[1] - bp).abs().max()) > 1e-2,
              f"B2e {label}: the plain version did not move the state")
        worst = max(worst, compare(f"B2e {label} mean", got[0], want[0]),
                    compare(f"B2e {label} perts", got[1], want[1]))
        labels.append(label)
    log(f"phase 3: B2e matches plain (max abs err {worst:.3e}): "
        + ", ".join(labels))
    return worst


@functools.lru_cache(maxsize=None)
def _api_draws(nmems, nobs, seed, ny):
    """:func:`_api_workload`'s random draws (the field, the obs' values,
    lats and lons, in that order), made once per argument set: nine
    phases build the same workload, its 84M normals seconds each time.
    Callers take copies."""
    rng = np.random.default_rng(seed)
    field = rng.normal(280, 5, (1, ny, ny, nmems)).astype(np.float32)
    return (field, rng.normal(280, 5, nobs), rng.uniform(-85, 85, nobs),
            rng.uniform(0, 360, nobs))


def _api_workload(nmems=80, nobs=10_000, seed=1, ny=1024):
    """The public-API workload of bench.py's phase_api: a 1024 x 1024
    global grid (``ny`` x ``ny``), random obs with 2000 km radii."""
    from efa_xray_tpu_torch.observation.observation import ObservationBatch
    from efa_xray_tpu_torch.utils import timeutil

    field, values, olat, olon = (x.copy() for x in
                                 _api_draws(nmems, nobs, seed, ny))
    nx = ny
    lat1d = np.linspace(-88, 88, ny)
    lon1d = np.arange(0, 360, 360 / nx)
    lon, lat = np.meshgrid(lon1d, lat1d)
    times = np.datetime64("2026-08-01T00") + np.arange(1) * np.timedelta64(6, "h")
    batch = ObservationBatch(
        values=values, errors=np.ones(nobs), lats=olat, lons=olon,
        times_s=timeutil.to_epoch_seconds(np.repeat(times[0], nobs)),
        obtypes=["T2m"] * nobs, localize_radius=np.full(nobs, 2000.0),
        assimilate_flags=np.ones(nobs, bool), verts=np.full(nobs, np.nan),
        descriptions=[None] * nobs)
    coords = {"validtime": times, "lat": lat, "lon": lon,
              "mem": np.arange(nmems)}
    return {"T2m": field}, coords, batch


def _plain_update(state, batch, cfg, inflation=None, rows=None):
    """The plain blocked update (``ensrf_core.ensrf_blocked``) of what
    ``EnSRF(state, batch, inflation=inflation, config=cfg).update()``
    computes, on the same tensors, the outlier check included: ``(prior
    mean, prior perturbations, posterior mean, posterior
    perturbations)``.  ``rows`` (indices) restricts the body to those
    state rows, the tail whole: the body is row-local, so they are the
    whole update's rows."""
    import torch

    from efa_xray_tpu_torch import EnSRF
    from efa_xray_tpu_torch.assimilation import ensrf_core as core

    dev = state.device
    ref = EnSRF(state, batch, inflation=inflation, config=cfg, verbose=False)
    bm, bp, tm, tp = ref.format_prior_state()
    oa = ref.apply_outlier_check(ref.obs_arrays(), tm, tp)
    blat, blon = state.structure.row_latlon_device(torch.float32, dev)
    vertical = cfg.localize and ref._vertical_active()
    bvert = (torch.tensor(state.structure.row_vert(), dtype=torch.float32,
                          device=dev) if vertical else None)
    vkw, hkw = ref.varloc_kwargs(), ref._hybrid_kwargs(bm)
    if rows is not None:
        take = lambda x: None if x is None else x[rows]
        bm, bp, blat, blon, bvert = (take(x) for x in (bm, bp, blat, blon,
                                                       bvert))
        if "row_var" in vkw:
            vkw["row_var"] = take(vkw["row_var"])
        if "body_sigma" in hkw and hkw["body_sigma"].dim() > 0:
            hkw["body_sigma"] = take(hkw["body_sigma"])
    pbm, pbp, *_ = core.ensrf_blocked(
        bm, bp, tm, tp, blat, blon, oa, localize=cfg.localize,
        block_size=cfg.block_size, fast_geometry=cfg.fast_geometry,
        body_vert=bvert, vertical=vertical, tail_panel=cfg.tail_panel,
        **vkw, **hkw)
    return bm, bp, pbm, pbp


# Plain updates kept for a later phase on the same workload and config:
# {key: (cfg, (bm, bp, pbm, pbp) on the CPU)}.
_PLAIN_KEPT = {}


def _plain_kept(key, state, batch, cfg):
    """:func:`_plain_update` of ``cfg`` on the workload named ``key``,
    computed once and kept on the host: phases 4 and 15 hold the same
    update of phase 4's workload against it."""
    kept = _PLAIN_KEPT.get(key)
    if kept is None or kept[0] != cfg:
        kept = (cfg, tuple(x.cpu() for x in _plain_update(state, batch,
                                                           cfg)))
        _PLAIN_KEPT[key] = kept
    return tuple(x.to(state.device) for x in kept[1])


def _check_api(label, state, batch, cfg, post, obs, inflation=None,
               plain=None, rows=None):
    """Hold an ``EnSRF.update()`` result against the plain blocked update
    (:func:`_plain_update`, or ``plain`` when it is given) on the same
    tensors (on the state rows ``rows`` where given), and check its
    diagnostics: every ob assimilated but those the outlier check flagged.
    Returns ``(mean_err, incr_rms, inn_prior, inn_post)``."""
    import torch

    bm, _, pbm, _ = plain or _plain_update(state, batch, cfg, inflation,
                                           rows=rows)
    post_mean = post.to_vect().mean(dim=1)
    if rows is not None:
        post_mean = post_mean[rows]
    incr_rms = float(torch.sqrt(torch.mean((pbm - bm) ** 2)))
    mean_err = float((post_mean - pbm).abs().max())
    check(torch.isfinite(post.data).all().item(), f"{label}: posterior not "
          "finite")
    check(mean_err <= 1e-3 * incr_rms,
          f"{label}: posterior mean differs from the plain update by "
          f"{mean_err:.3e} > 1e-3 x increment RMS {incr_rms:.3e}")
    pm, pv = obs.prior_mean, obs.prior_var
    om, ov = obs.post_mean, obs.post_var
    a = obs.assimilated
    rejected = (np.zeros(batch.nobs, bool) if obs.qc_outlier is None
                else np.asarray(obs.qc_outlier, bool))
    check(bool((a == ~rejected).all()),
          f"{label}: not every ob the outlier check kept was assimilated")
    check(all(np.isfinite(x[a]).all() for x in (pm, pv, om, ov)),
          f"{label}: diagnostics not finite")
    check(bool((ov[a] <= pv[a]).all()), f"{label}: post_var > prior_var")
    inn_prior = float(np.mean(np.abs(batch.values - pm)[a]))
    inn_post = float(np.mean(np.abs(batch.values - om)[a]))
    check(inn_post < inn_prior, f"{label}: innovations did not shrink")
    return mean_err, incr_rms, inn_prior, inn_post


def _reset_counts():
    from efa_xray_tpu_torch.ops import (
        ensrf_fused,
        ensrf_grid,
        letkf_gram,
        newton_schulz,
        precision_probe,
        tail_solve,
    )

    tail_solve.launches = 0
    tail_solve.hybrid_launches = 0
    tail_solve.enkf_launches = 0
    ensrf_fused.launches = 0
    ensrf_fused.hybrid_launches = 0
    ensrf_fused.enkf_launches = 0
    ensrf_grid.b3_launches = 0
    ensrf_grid.b4_launches = 0
    ensrf_grid.b4e_launches = 0
    for source in ensrf_grid.b4_weight_source:
        ensrf_grid.b4_weight_source[source] = 0
    newton_schulz.launches = 0
    letkf_gram.launches = 0
    for by_mode in (ensrf_fused.launches_by_mode,
                    ensrf_grid.launches_by_mode):
        for counts in by_mode.values():
            for mode in counts:
                counts[mode] = 0
    precision_probe.launches = 0
    for mode in precision_probe.MODES:
        precision_probe.launches_by_mode[mode] = 0


def _counts() -> dict:
    """Launches of each kernel since the last :func:`_reset_counts`."""
    from efa_xray_tpu_torch.ops import (
        ensrf_fused,
        ensrf_grid,
        letkf_gram,
        newton_schulz,
        precision_probe,
        tail_solve,
    )

    return {"B1": tail_solve.launches, "B1h": tail_solve.hybrid_launches,
            "B1e": tail_solve.enkf_launches, "B2": ensrf_fused.launches,
            "B2h": ensrf_fused.hybrid_launches,
            "B2e": ensrf_fused.enkf_launches, "B3": ensrf_grid.b3_launches,
            "B4": ensrf_grid.b4_launches, "B4e": ensrf_grid.b4e_launches,
            "NS": newton_schulz.launches, "LG": letkf_gram.launches,
            "P": precision_probe.launches}


def _weight_sources() -> dict:
    """B4 and B4e launches by the source of their weights ("kernel": from
    the geometry, "w", "none") since the last :func:`_reset_counts`."""
    from efa_xray_tpu_torch.ops import ensrf_grid

    return dict(ensrf_grid.b4_weight_source)


def _weights_in_kernel(label: str, counts: dict, sources: dict) -> None:
    """Every B4 and B4e launch of ``counts`` computed its weights in the
    kernel (``sources``: :func:`_weight_sources`)."""
    n = counts["B4"] + counts["B4e"]
    check(sources == dict(kernel=n, w=0, none=0),
          f"{label}: B4 weights by source {sources}, not all {n} in the "
          "kernel")


def _torch_weights(lat, lon, ob_lat, ob_lon, radii):
    """B4's exact haversine weights ``[B, G]`` as torch built them before
    the kernel computed them: ``gaspari_cohn(haversine(...))``."""
    from efa_xray_tpu_torch.observation.localization import (
        gaspari_cohn,
        haversine,
    )

    return gaspari_cohn(haversine((ob_lat[:, None], ob_lon[:, None]),
                                  (lat[None, :], lon[None, :])),
                        radii[:, None])


def _mode_counts() -> dict:
    """Launches of B2, B2h, B3 and B4 by product mode since the last
    :func:`_reset_counts`: ``{kernel: {mode: n}}``."""
    from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid

    return {k: dict(v) for by_mode in (ensrf_fused.launches_by_mode,
                                       ensrf_grid.launches_by_mode)
            for k, v in by_mode.items()}


def _only(**expect):
    """A check of :func:`_counts`: each kernel named launched as many
    times as given (at least once where None), every other kernel
    never."""
    def ok(counts):
        return all(k >= 1 if name in expect and expect[name] is None
                   else k == expect.get(name, 0)
                   for name, k in counts.items())
    return ok


def _tail_counts(nobs: int, panel: int, b4: bool) -> dict:
    """What the kernel tail launches for ``nobs`` obs in panels of
    ``panel``: B1 once per panel, and on the B4 apply one B4 launch per
    block of 128 obs of every panel (a batch in one panel applies
    nothing)."""
    npanels = -(-nobs // panel)
    per_panel = -(-panel // 128) if (b4 and npanels > 1) else 0
    return dict(panels=npanels, b4=npanels * per_panel)


def _enkf_only(nobs: int, route: str, bodies: int = 1, block: int = 128,
               panel: int = 512):
    """:func:`_only` of an EnKF update on the kernel route ``route`` ("B2"
    or "B4") with ``bodies`` shards: B1e once per panel; on B2, B2e once
    per panel out of panel (a batch in one panel applies nothing) and
    once per shard's body; on B4, B4e per 128 obs of each panel and per
    block of each shard's body."""
    t = _tail_counts(nobs, panel, route == "B4")
    if route == "B2":
        return _only(B1e=t["panels"],
                     B2e=(t["panels"] if t["panels"] > 1 else 0) + bodies)
    return _only(B1e=t["panels"], B4e=t["b4"] + bodies * -(-nobs // block))


def _sync_free(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result and the synchronizing calls it made (the host waiting on a
    card: a read back, a copy from pageable memory, a synchronize), by
    warning text."""
    import warnings

    import torch

    old = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(old)
    syncs = [str(w.message).splitlines()[0] for w in seen
             if "called a synchronizing" in str(w.message)]
    return out, syncs


def _syncer(dev):
    import torch

    return (torch.cuda.synchronize if torch.device(dev).type == "cuda"
            else (lambda: None))


def _spans(run, patches, sync):
    """``run()`` with each ``(module, name, key)`` of ``patches`` wrapped
    in a synchronize on both sides: ``(result, wall seconds, {key: summed
    seconds})``."""
    spent = {key: 0.0 for _, _, key in patches}

    def timed(fn, key):
        def wrapped(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            spent[key] += time.perf_counter() - t0
            return out
        return wrapped

    saved = [(mod, name, getattr(mod, name), key)
             for mod, name, key in patches]
    for mod, name, fn, key in saved:
        setattr(mod, name, timed(fn, key))
    try:
        sync()
        t0 = time.perf_counter()
        out = run()
        sync()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, fn, _ in saved:
            setattr(mod, name, fn)
    return out, wall, spent


def _timed_update(make_filter):
    """One ``make_filter().update()``: its result, wall seconds, and a
    dict of the seconds spent in the tail (``tail_scan_blocked``), in the
    body (``fused_body``, ``grid_body`` or ``blocked_body``) and, inside a
    B4 body, in the blocks' torch operands (``block_operands``) and in the
    kernel's launches (``block_apply``), and in the adaptive-inflation
    learning (``maybe_update_adaptive_inflation``), each closed by a
    synchronize."""
    import torch

    from efa_xray_tpu_torch.assimilation import assimilation as assim_mod
    from efa_xray_tpu_torch.assimilation import ensrf as ensrf_mod
    from efa_xray_tpu_torch.assimilation import ensrf_core as core
    from efa_xray_tpu_torch.ops import ensrf_grid

    spent = {"tail": 0.0, "body": 0.0, "operands": 0.0, "kernel": 0.0,
             "learn": 0.0}
    out, wall, timed = _spans(lambda: make_filter().update(), [
        (core, "tail_scan_blocked", "tail"), (ensrf_mod, "fused_body", "body"),
        (ensrf_grid, "grid_body", "body"), (ensrf_grid, "blocked_body", "body"),
        (ensrf_grid, "block_operands", "operands"),
        (ensrf_grid, "block_apply", "kernel"),
        (assim_mod.Assimilation, "maybe_update_adaptive_inflation", "learn")],
        torch.cuda.synchronize)
    spent.update(timed)
    return out, wall, spent


def _api_state(dev, **workload):
    """Phase 4's workload on the card (``workload`` as
    :func:`_api_workload` takes it): ``(state, batch)``."""
    import torch

    from efa_xray_tpu_torch import EnsembleState

    vardict, coords, batch = _api_workload(**workload)
    state = EnsembleState.from_vardict(
        {k: torch.from_numpy(v).to(dev) for k, v in vardict.items()}, coords,
        dtype="float32", device=dev)
    check(state.device.type == torch.device(dev).type,
          f"state is not on {dev}")
    return state, batch


def phase4():
    """EnSRF.update() through the public API on the card."""
    import torch

    from efa_xray_tpu_torch import EnSRF, FilterConfig

    dev = torch.device("cuda")
    state, batch = _api_state(dev)
    cfg = FilterConfig(localization="GC", dtype="float32", fast_geometry=True)

    _reset_counts()
    post, obs = EnSRF(state, batch, config=cfg, verbose=False,
                      device="cuda").update()
    torch.cuda.synchronize()
    counts = _counts()
    b1, b2 = counts["B1"], counts["B2"]
    nobs = batch.nobs
    check(b1 == -(-nobs // cfg.tail_panel), f"B1 launched {b1} times")
    check(b2 >= -(-nobs // cfg.tail_panel) + 1, f"B2 launched {b2} times")
    check(_only(B1=b1, B2=b2)(counts), f"phase 4: launches {counts}")
    mean_err, incr_rms, inn_prior, inn_post = _check_api(
        "phase 4", state, batch, cfg, post, obs,
        plain=_plain_kept(("api", 1024, 10_000, 80), state, batch, cfg))

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


def _headline(dev="cuda", nstate=10_000_000, nobs=10_000):
    """The headline workload of bench.py's build_workload (1e7
    Hilbert-ordered rows x 80 x 10k obs at 2000 km; BASELINE config 4),
    drawn on ``dev`` (``nstate`` and ``nobs`` cut for a rehearsal on the
    CPU).  Returns ``(tail_phase, body_phase, w)``: the B1/B2 tail, the B2
    body on a tail (its two products in a given mode), and a dict of the
    workload's tensors."""
    import torch

    from efa_xray_tpu_torch.assimilation import ensrf_core as core
    from efa_xray_tpu_torch.ops import ensrf_fused

    dev = torch.device(dev)
    f32 = torch.float32
    nmems, radius = 80, 2000.0
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

    def body_phase(tail, precision="ieee"):
        return ensrf_fused.fused_body(bm, bp, lat, lon, tail, obs,
                                      localize=True, block_size=128,
                                      max_radius_km=radius,
                                      precision=precision)

    w = dict(bm=bm, bp=bp, tm=tm, tp=tp, lat=lat, lon=lon, obs=obs, gen=gen,
             nstate=nstate, nobs=nobs, radius=radius)
    return tail_phase, body_phase, w


def phase5():
    """The headline workload: 1e7 rows x 80 x 10k obs; then (c) one warm
    update each with the body's two products in TF32 and in bf16."""
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
    del ops, pm, pp
    ops = ensrf_fused.prepare(w["bp"], w["lat"], w["lon"], tail, w["obs"],
                              block_size=128, max_radius_km=w["radius"])
    body_bound = bound(
        b2_flop(ops, nstate, w["bp"].shape[1], True, False),
        nbytes(w["bm"], w["bp"], ops["geom"], ops["y_b"], ops["ggt_b"],
               ops["tab_b"], ops["bits"], bm2, bp2))
    log(f"phase 5: 1e7 x 80 x 10k obs at 2000 km: update {sec:.4f} s "
        f"(runs {', '.join(f'{r:.4f}' for r in runs)} s; tail B1+B2 "
        f"{', '.join(f'{t:.4f}' for t in tails)} s; body B2 "
        f"{', '.join(f'{b:.4f}' for b in bodies)} s), "
        f"{nobs * nstate / sec:.4e} obs*points/s; the body launch's bound "
        f"{body_bound['bound_ms']:.1f} ms ({body_bound['bound_by']}) at tile "
        f"{ops['tile']}; setup {setup:.1f} s; "
        f"20k-row sample vs plain body max abs err {err:.3e}")
    del ops
    modes = {}
    for mode in ("tf32", "bf16"):
        body_phase(tail_phase(), mode)  # warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        tail = tail_phase()
        ev[1].record()
        bm3, bp3 = body_phase(tail, mode)
        ev[2].record()
        ev[2].synchronize()
        check(bool(torch.isfinite(bm3).all() and torch.isfinite(bp3).all()),
              f"headline {mode} posterior not finite")
        r = dict(seconds=ev[0].elapsed_time(ev[2]) / 1e3,
                 body_s=ev[1].elapsed_time(ev[2]) / 1e3,
                 mean_err_share=_rms_share(bm3, bm2, w["bm"]),
                 perts_err_share=_rms_share(bp3, bp2, w["bp"]))
        gate = API_MODE_GATE[mode]
        check(0.0 < r["perts_err_share"] <= gate
              and r["mean_err_share"] <= gate,
              f"headline {mode}: error shares {r['mean_err_share']:.3e} / "
              f"{r['perts_err_share']:.3e} of the fp32 increment (gate "
              f"{gate})")
        modes[mode] = r
        del bm3, bp3
    log("phase 5 (c): the headline body's two products on the tensor "
        "cores, one warm update each: " + "; ".join(
            f"{mode}: update {r['seconds']:.4f} s (body B2 "
            f"{r['body_s']:.4f} s), {nobs * nstate / r['seconds']:.4e} "
            f"obs*points/s, posterior vs fp32: mean {r['mean_err_share']:.3e}"
            f" perts {r['perts_err_share']:.3e} of the increment RMS"
            for mode, r in modes.items()))
    return dict(seconds=sec, modes=modes)


# Config 3's four quantities, each on 20 pressure levels from 1000 to 100
# hPa (benchmarks/run_benchmarks.py:282-320).
C3_QUANTITIES = ("T", "U", "V", "Q")
C3_LEVELS = np.linspace(1000.0, 100.0, 20)


def _grid_case(ny, nx, vt, nmems, nobs, seed, group_levels=None,
               radius=2000.0, dev="cuda"):
    """Operands of a body sweep over ``vt`` groups on a global ``ny x nx``
    grid: a random state, obs at random places each observing a random
    group (its level, 300 hPa vertical radius), their pre-solved sequence
    from the B1/B2 tail, and a cross-variable factor per (group, ob) with
    zeros in it."""
    import torch

    from efa_xray_tpu_torch.assimilation import ensrf_core as core

    dev = torch.device(dev)
    f32 = torch.float32
    rng = np.random.default_rng(seed)
    t = lambda x: torch.tensor(x, dtype=f32, device=dev)
    lon, lat = np.meshgrid(np.linspace(0.0, 360.0, nx, endpoint=False),
                           np.linspace(-89.0, 89.0, ny))
    ngrid = ny * nx
    gen = torch.Generator(device=dev).manual_seed(seed)
    bm = 0.5 * torch.randn(vt * ngrid, generator=gen, device=dev)
    bp = 5.0 * torch.randn(vt * ngrid, nmems, generator=gen, device=dev)
    levels = (np.linspace(1000.0, 100.0, vt) if group_levels is None
              else np.asarray(group_levels))
    group = rng.integers(0, vt, nobs)
    ye = (bp[torch.from_numpy(group * ngrid + rng.integers(0, ngrid, nobs))
             .to(dev)] + 0.5 * torch.randn(nobs, nmems, generator=gen,
                                           device=dev))
    tm = ye.mean(1)
    obs = core.ObsArrays(
        values=tm + torch.randn(nobs, generator=gen, device=dev),
        errors=torch.ones(nobs, device=dev),
        lats=t(rng.uniform(-88.0, 88.0, nobs)),
        lons=t(rng.uniform(0.0, 360.0, nobs)),
        radii=torch.full((nobs,), radius, device=dev),
        assim=torch.ones(nobs, dtype=torch.bool, device=dev),
        verts=t(levels[group]), vert_radii=torch.full((nobs,), 300.0,
                                                      device=dev))
    tail = core.tail_scan_blocked(tm, ye - tm[:, None], obs, localize=True,
                                  fast_geometry=True, vertical=True,
                                  panel=512, kernels=True,
                                  max_radius_km=radius)
    # Four quantities: factor[ob quantity, group quantity], zeros included.
    fac = rng.choice([0.0, 0.3, 1.0], (4, 4))
    quantity = lambda g: g * 4 // vt
    gf = t(fac[quantity(group)][:, quantity(np.arange(vt))].T)
    body_vert = t(np.repeat(levels, ngrid))
    return dict(bm=bm, bp=bp, lat=t(lat.ravel()), lon=t(lon.ravel()),
                body_vert=body_vert, tail=tail, obs=obs, gf=gf, ngrid=ngrid,
                vt=vt)


# Block sizes swept by the grid kernel's edge cases: under one panel's
# width, ragged last panels, one to 32 panels.
GRID_BLOCK_SWEEP = (8, 16, 24, 40, 64, 72, 96, 120, 136, 200, 256)


def _grid_edge_inputs(dev="cuda"):
    """The grid kernel's small grids chosen for the edges of its tiling: a
    grid of 527 points (not a multiple of the tile nor of 4: 4-byte weight
    copies, a ragged last tile), of 60 (a multiple of 4: 16-byte copies
    into a ragged tile) and of 21 (under one tile); ensembles of 12, 21,
    30, 50, 80, 128 and 256; blocks of 100 and 50 obs (a ragged last
    panel, 4-byte copies) and a sweep of block sizes; no weights
    (unlocalized), no table, one group, one block and an in-place update.
    Yields ``(label, case, (w, table, y_b, ggt_b, coef_b), vt, donate)``,
    ``case`` from :func:`_grid_case` (made once per shape: the last one
    holds the 17 x 31 grid of 3 groups, 30 members and 300 obs)."""
    from efa_xray_tpu_torch.observation.localization import latlon_to_unit
    from efa_xray_tpu_torch.ops import ensrf_grid

    wide = dict(ny=17, nx=31)
    cases = [
        # label, grid, vt, members, block, obs, weights, table, in place
        ("G 527, 30 members", wide, 3, 30, 128, 300, True, True, False),
        ("G 60", dict(ny=6, nx=10), 3, 30, 128, 300, True, True, False),
        ("G 21 (under one tile)", dict(ny=3, nx=7), 3, 30, 128, 300, True,
         True, False),
        ("12 members", wide, 3, 12, 128, 300, True, True, False),
        ("21 members", wide, 3, 21, 128, 300, True, True, False),
        ("50 members", wide, 3, 50, 128, 300, True, True, False),
        ("80 members", wide, 3, 80, 128, 300, True, True, False),
        ("128 members", wide, 3, 128, 128, 300, True, True, False),
        ("256 members", wide, 3, 256, 128, 300, True, True, False),
        ("80 members, blocks of 100", wide, 3, 80, 100, 300, True, True,
         False),
        ("30 members, blocks of 50", wide, 3, 30, 50, 300, True, True, False),
        ("w null", wide, 3, 30, 128, 300, False, False, False),
        ("table null", wide, 3, 30, 128, 300, True, False, False),
        ("vt 1", wide, 1, 30, 128, 300, True, False, False),
        ("one block", wide, 3, 30, 128, 100, True, True, False),
        ("in place", wide, 3, 80, 128, 300, True, True, True),
    ] + [(f"blocks of {b}", wide, 3, 30, b, 300, True, True, False)
         for b in GRID_BLOCK_SWEEP]
    made = {}
    for label, grid, vt, m, bsz, nobs, weights, use_table, donate in cases:
        key = (grid["ny"], grid["nx"], vt, m, nobs)
        if key not in made:
            made[key] = _grid_case(vt=vt, nmems=m, nobs=nobs, seed=63,
                                   dev=dev, **grid)
        c = made[key]
        ops = ensrf_grid.grid_prepare(
            c["bp"], c["body_vert"], c["tail"], c["obs"], c["ngrid"],
            localize=weights, block_size=bsz, vertical=use_table,
            group_factor=c["gf"] if use_table else None)
        nblocks = ops["y_b"].shape[0]
        w = None
        if weights:
            w = ensrf_grid.grid_weights(
                latlon_to_unit(c["lat"], c["lon"]), ops["ob_xyz"],
                ops["radii"]).reshape(nblocks, bsz, c["ngrid"])
        yield label, c, (w, ops["table"], ops["y_b"], ops["ggt_b"],
                         ops["coef_b"]), vt, donate


def _first_block_places(c, bsz: int):
    """``(lat, lon, ob_lat, ob_lon, radii)``: the grid of
    :func:`_grid_case`'s ``c`` and its first ``bsz`` obs, padded as
    ``blocked_body`` pads (latitude and longitude 0, infinite
    halfwidth)."""
    import torch

    obs, g = c["obs"], c["ngrid"]
    n = min(bsz, obs.lats.shape[0])
    pad = lambda x, v=0.0: torch.nn.functional.pad(x[:n], (0, bsz - n),
                                                   value=v)
    return (c["lat"][:g], c["lon"][:g], pad(obs.lats), pad(obs.lons),
            pad(obs.radii, float("inf")))


def _first_block_geometry(c, bsz: int):
    """The ``Geometry`` of :func:`_first_block_places`."""
    import torch

    from efa_xray_tpu_torch.ops import ensrf_grid

    lat, lon, olat, olon, rad = _first_block_places(c, bsz)
    f32 = torch.float32
    return ensrf_grid.Geometry(
        ensrf_grid.point_geometry(lat, lon, f32),
        ensrf_grid.point_geometry(olat, olon, f32, rad))


def _first_block(args):
    """B4's operands for the first block of :func:`_grid_edge_inputs`'s
    ``(w, table, y_b, ggt_b, coef_b)`` (``w`` may be a ``Geometry``):
    ``(for block_apply, for grid_apply_plain)``."""
    from efa_xray_tpu_torch.ops import ensrf_grid

    def block(t, i, s):
        if isinstance(t, ensrf_grid.Geometry):
            return ensrf_grid.Geometry(t.points, t.obs[s])
        return None if t is None else (t[:, s] if i == 1 else t[s])

    return (tuple(block(t, i, 0) for i, t in enumerate(args)),
            tuple(block(t, i, slice(0, 1)) for i, t in enumerate(args)))


def _grid_edge_cases(entry: str):
    """B3 or B4 (``entry``) against the plain version at each of
    :func:`_grid_edge_inputs`'s grids and, for B3, ``grid_body`` over more
    blocks than one weight chunk holds.  Each case runs all its blocks
    through B3, or its first block through B4, and checks the tile and the
    CTAs per SM the wrapper planned for.  Returns ``(max abs err,
    labels)``."""
    import torch

    from efa_xray_tpu_torch.observation.localization import latlon_to_unit
    from efa_xray_tpu_torch.ops import ensrf_grid

    # The tile the wrapper must choose where the choice was measured.
    tiles = {"G 527, 30 members": 64, "50 members": 64, "80 members": 64,
             "128 members": 32, "256 members": 32, "blocks of 256": 32}
    worst = 0.0
    labels = []
    geo_cases, geo_bitwise = 0, 0
    for label, c, args, vt, donate in _grid_edge_inputs():
        bsz, m = args[2].shape[1:]
        tile = ensrf_grid.pick_tile(bsz, m)
        planned = ensrf_grid.ctas_per_sm(tile, bsz, m)
        on_card = ensrf_grid.ctas_per_sm_on_card(tile, bsz, m)
        check(tile == tiles.get(label, tile) and 1 <= planned <= on_card,
              f"grid edge case {label}: tile {tile}, {planned} CTAs per SM "
              f"planned, {on_card} on the card")
        plain = args
        run = ensrf_grid.grid_apply
        if entry == "B4":  # the first block alone (the table is [VT, nb, B])
            args, plain = _first_block(args)
            run = ensrf_grid.block_apply
        want = ensrf_grid.grid_apply_plain(c["bm"], c["bp"], *plain, vt)
        gm, gp = ((c["bm"].clone(), c["bp"].clone()) if donate
                  else (c["bm"], c["bp"]))
        got = run(gm, gp, *args, vt, donate=donate)
        torch.cuda.synchronize()
        name = f"{entry} edge case {label}"
        if donate:
            check(got[0].data_ptr() == gm.data_ptr()
                  and got[1].data_ptr() == gp.data_ptr(),
                  f"{name}: not updated in place")
        check(float((want[1] - c["bp"]).abs().max()) > 1e-2,
              f"{name}: the plain version did not move the state")
        worst = max(worst, compare(f"{name} mean", got[0], want[0]),
                    compare(f"{name} perts", got[1], want[1]))
        labels.append(label)
        if entry == "B4" and args[0] is not None:
            # The first block's exact haversine weights computed in the
            # kernel, against the plain version and the launch that reads
            # the same weights as torch builds them.
            geo = _first_block_geometry(c, bsz)
            wt = _torch_weights(*_first_block_places(c, bsz))
            want = ensrf_grid.grid_apply_plain(c["bm"], c["bp"], wt[None],
                                               *plain[1:], vt)
            got = ensrf_grid.block_apply(c["bm"], c["bp"], geo, *args[1:],
                                         vt)
            read = ensrf_grid.block_apply(c["bm"], c["bp"], wt, *args[1:],
                                          vt)
            torch.cuda.synchronize()
            worst = max(worst,
                        compare(f"{name} in-kernel weights mean", got[0],
                                want[0]),
                        compare(f"{name} in-kernel weights perts", got[1],
                                want[1]))
            geo_cases += 1
            geo_bitwise += int(torch.equal(got[0], read[0])
                               and torch.equal(got[1], read[1]))
    if entry == "B4":
        return worst, labels + [
            f"in-kernel exact haversine weights at {geo_cases} of them "
            f"({geo_bitwise} bit for bit the launch reading them from w)"]

    # grid_body building its weights over chunks of two blocks.
    ops = ensrf_grid.grid_prepare(c["bp"], c["body_vert"], c["tail"],
                                  c["obs"], c["ngrid"], block_size=64,
                                  vertical=True)
    w = ensrf_grid.grid_weights(latlon_to_unit(c["lat"], c["lon"]),
                                ops["ob_xyz"], ops["radii"])
    want = ensrf_grid.grid_apply_plain(
        c["bm"], c["bp"], w.reshape(-1, 64, c["ngrid"]), ops["table"],
        ops["y_b"], ops["ggt_b"], ops["coef_b"], 3)
    budget = ensrf_grid.GRID_WEIGHT_BUDGET_BYTES
    before = ensrf_grid.b3_launches
    try:
        ensrf_grid.GRID_WEIGHT_BUDGET_BYTES = 2 * 64 * c["ngrid"] * 4
        got = ensrf_grid.grid_body(
            c["bm"], c["bp"], c["lat"], c["lon"], c["tail"], c["obs"],
            c["ngrid"], body_vert=c["body_vert"], block_size=64,
            vertical=True)
    finally:
        ensrf_grid.GRID_WEIGHT_BUDGET_BYTES = budget
    check(ensrf_grid.b3_launches - before == 3,
          f"grid_body over weight chunks: {ensrf_grid.b3_launches - before} "
          "launches, not 3")
    worst = max(worst, compare("B3 weight chunks mean", got[0], want[0]),
                compare("B3 weight chunks perts", got[1], want[1]))
    labels.append("5 blocks in weight chunks of 2")
    return worst, labels


def phase6():
    """B3 against its plain version at config 3's shape."""
    import torch

    from efa_xray_tpu_torch.observation.localization import latlon_to_unit
    from efa_xray_tpu_torch.ops import ensrf_grid

    bsz = 128
    results = []
    c3 = dict(ny=90, nx=180, vt=80, nmems=30, nobs=5000, seed=61,
              group_levels=np.tile(C3_LEVELS, 4))
    for label, dims, use_gf in (
            ("config 3", c3, False),
            ("config 3 + group factor", c3, True),
            ("80 members, 45x90 grid, 20 groups",
             dict(ny=45, nx=90, vt=20, nmems=80, nobs=1000, seed=62), False)):
        c = _grid_case(**dims)
        ops = ensrf_grid.grid_prepare(
            c["bp"], c["body_vert"], c["tail"], c["obs"], c["ngrid"],
            block_size=bsz, vertical=True,
            group_factor=c["gf"] if use_gf else None)
        nblocks = ops["y_b"].shape[0]
        w = ensrf_grid.grid_weights(latlon_to_unit(c["lat"], c["lon"]),
                                    ops["ob_xyz"], ops["radii"])
        args = (c["bm"], c["bp"], w.reshape(nblocks, bsz, c["ngrid"]),
                ops["table"], ops["y_b"], ops["ggt_b"], ops["coef_b"],
                ops["vt"])
        got = ensrf_grid.grid_apply(*args)
        want, p_ms = cuda_timed(lambda: ensrf_grid.grid_apply_plain(*args))
        torch.cuda.synchronize()
        err = max(compare(f"B3 {label} mean", got[0], want[0]),
                  compare(f"B3 {label} perts", got[1], want[1]))
        k_ms = cuda_ms(lambda: ensrf_grid.grid_apply(*args), 3)
        tile = ensrf_grid.pick_tile(bsz, dims["nmems"])
        moved = nbytes(*args[:7]) + nbytes(*got)
        results.append(dict(
            label=label, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
            nmems=dims["nmems"], tile=tile,
            ctas=ensrf_grid.ctas_per_sm_on_card(tile, bsz, dims["nmems"]),
            moved=moved,
            # Every CTA reads its [nb, B, tile] slab of the weights: once
            # per group if no read found the slab in the L2.
            w_reads=ops["vt"] * nbytes(w),
            **bound(body_flop(c["bm"].numel(), nblocks, bsz, dims["nmems"]),
                    moved)))
        del c, ops, w, args, got, want
    log("phase 6: B3 matches plain: " + "; ".join(
        f"{r['label']} ({r['nmems']} members, tile {r['tile']}, "
        f"{r['ctas']} CTAs per SM): err "
        f"{r['max_abs_err']:.3e} kernel {r['ms']:.2f} ms plain "
        f"{r['plain_ms']:.2f} ms bound {r['bound_ms']:.3f} ms "
        f"({r['bound_by']}; the bound counts {r['moved'] / 1e9:.3f} GB moved, "
        f"the launch's weight reads are {r['w_reads'] / 1e9:.3f} GB if none "
        f"hits the L2)" for r in results))
    edge_err, edge_labels = _grid_edge_cases("B3")
    log(f"phase 6: B3 matches plain at small grids (max abs err "
        f"{edge_err:.3e}): " + ", ".join(edge_labels))
    head = results[1]
    return dict(max_abs_err=max([edge_err] + [r["max_abs_err"]
                                              for r in results]),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"])


def phase7():
    """B4 against its plain version, four blocks in sequence."""
    import torch

    from efa_xray_tpu_torch.ops import ensrf_grid

    bsz, nblk = 128, 4
    results = []
    for label, dims, vertical in (
            ("config 3 (vt 80, vertical table)",
             dict(ny=90, nx=180, vt=80, nmems=30, nobs=5000, seed=71,
                  group_levels=np.tile(C3_LEVELS, 4)), True),
            ("1024x1024 x 80 members (vt 1)",
             dict(ny=1024, nx=1024, vt=1, nmems=80, nobs=10_000, seed=72),
             False)):
        c = _grid_case(**dims)
        tail, obs = c["tail"], c["obs"]
        nrows = c["bp"].shape[0]
        # The weights' source as blocked_body chooses it: computed in the
        # kernel at vt 1, read from w at vt 80.
        g = c["ngrid"]
        pgeo = ensrf_grid.points_for_kernel(
            c["lat"][:g], c["lon"][:g], torch.float32, on_card=True,
            localize=True, fast_geometry=False, vertical=vertical,
            vt=nrows // g)
        got = want = (c["bm"], c["bp"])
        for b in range(nblk):
            sl = slice(b * bsz, (b + 1) * bsz)
            vt, w, table, ggt = ensrf_grid.block_operands(
                c["lat"], c["lon"], tail.ye[sl], tail.sqrt_coef[sl],
                obs.lats[sl], obs.lons[sl], obs.radii[sl], nrows,
                body_vert=c["body_vert"], ob_vert=obs.verts[sl],
                ob_vrad=obs.vert_radii[sl], vertical=vertical,
                ngrid=c["ngrid"], point_geo=pgeo)
            coef = torch.stack([tail.gain_coef[sl], tail.sqrt_coef[sl]])
            ops = (w, table, tail.ye[sl].contiguous(), ggt.contiguous(), coef)
            got = ensrf_grid.block_apply(*got, *ops, vt)
            want = ensrf_grid.grid_apply_plain(
                *want, ensrf_grid.as_blocks(w),
                None if table is None else table[:, None],
                ops[2][None], ops[3][None], coef[None], vt)
        torch.cuda.synchronize()
        err = max(compare(f"B4 {label} mean", got[0], want[0]),
                  compare(f"B4 {label} perts", got[1], want[1]))
        args = (c["bm"], c["bp"], *ops, vt)
        k_ms = cuda_ms(lambda: ensrf_grid.block_apply(*args), 5)
        # The block's operands in torch (haversine weights at the full
        # grid, the vertical table, ggt), apart from the kernel.
        o_ms = cuda_ms(lambda: ensrf_grid.block_operands(
            c["lat"], c["lon"], tail.ye[sl], tail.sqrt_coef[sl],
            obs.lats[sl], obs.lons[sl], obs.radii[sl], nrows,
            body_vert=c["body_vert"], ob_vert=obs.verts[sl],
            ob_vrad=obs.vert_radii[sl], vertical=vertical,
            ngrid=c["ngrid"], point_geo=pgeo), 3)
        tile = ensrf_grid.pick_tile(bsz, dims["nmems"])
        p_ms = cuda_ms(lambda: ensrf_grid.grid_apply_plain(
            c["bm"], c["bp"], ensrf_grid.as_blocks(w),
            None if table is None else table[:, None], ops[2][None],
            ops[3][None], coef[None], vt), 1)
        results.append(dict(
            label=label, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
            operands_ms=o_ms, tile=tile,
            ctas=ensrf_grid.ctas_per_sm_on_card(tile, bsz, dims["nmems"]),
            **bound(body_flop(nrows, 1, bsz, dims["nmems"]),
                    nbytes(*args[:7]) + nbytes(*got))))
        # B4e on the same blocks, against departure rows z = ye - eps.
        got = want = (c["bm"], c["bp"])
        for b in range(2):
            sl = slice(b * bsz, (b + 1) * bsz)
            z = (tail.ye[sl] - _draws(tail.ye[sl], 71 + b)).contiguous()
            vt, w, table, ggt = ensrf_grid.block_operands(
                c["lat"], c["lon"], tail.ye[sl], tail.sqrt_coef[sl],
                obs.lats[sl], obs.lons[sl], obs.radii[sl], nrows,
                body_vert=c["body_vert"], ob_vert=obs.verts[sl],
                ob_vrad=obs.vert_radii[sl], vertical=vertical,
                ngrid=c["ngrid"], apply_rows=z, point_geo=pgeo)
            coef = torch.stack([tail.gain_coef[sl], tail.sqrt_coef[sl]])
            ops = (w, table, tail.ye[sl].contiguous(), ggt.contiguous(), coef)
            got = ensrf_grid.block_apply(*got, *ops, vt, z=z)
            want = ensrf_grid.grid_apply_plain(
                *want, ensrf_grid.as_blocks(w),
                None if table is None else table[:, None],
                ops[2][None], ops[3][None], coef[None], vt, z_b=z[None])
        torch.cuda.synchronize()
        results[-1]["b4e_max_abs_err"] = max(
            compare(f"B4e {label} mean", got[0], want[0]),
            compare(f"B4e {label} perts", got[1], want[1]))
        del c, tail, obs, got, want, ops, args, w
    log(f"phase 7: B4 matches plain over {nblk} blocks: " + "; ".join(
        f"{r['label']} (tile {r['tile']}, {r['ctas']} CTAs per SM): err "
        f"{r['max_abs_err']:.3e}, one block: kernel "
        f"{r['ms']:.3f} ms plain {r['plain_ms']:.3f} ms bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}); its operands in torch "
        f"(block_operands) {r['operands_ms']:.3f} ms; B4e over 2 blocks: "
        f"err {r['b4e_max_abs_err']:.3e}" for r in results))
    edge_err, edge_labels = _grid_edge_cases("B4")
    log(f"phase 7: B4 matches plain at small grids (max abs err "
        f"{edge_err:.3e}): " + ", ".join(edge_labels))
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    config3, wide = results
    return dict(config3=dict(max_abs_err=max(edge_err, config3["max_abs_err"]),
                             **{k: config3[k] for k in keys}),
                wide=dict(max_abs_err=wide["max_abs_err"],
                          **{k: wide[k] for k in keys}))


def _config3_workload(nmems=30, nobs=5000, seed=3, dev="cuda", ny=90,
                      nx=180):
    """BASELINE config 3 as a user builds it: the four quantities on 20
    levels as 80 level-stacked variables named like ``T_526``, each with
    its level in ``var_verts``; one time; the 90 x 180 global 2-degree
    grid; 30 members; 5,000 obs of random variables at 2000 km, each with
    its variable's level and a 300 hPa vertical radius.  Returns
    ``(state, batch, names)``."""
    import torch

    from efa_xray_tpu_torch import EnsembleState
    from efa_xray_tpu_torch.observation.observation import ObservationBatch
    from efa_xray_tpu_torch.state.structure import StateStructure
    from efa_xray_tpu_torch.utils import timeutil

    dev = torch.device(dev)
    rng = np.random.default_rng(seed)
    names = [f"{q}_{lev:.0f}" for q in C3_QUANTITIES for lev in C3_LEVELS]
    verts = np.tile(C3_LEVELS, len(C3_QUANTITIES))
    lon, lat = np.meshgrid(np.linspace(0.0, 360.0, nx, endpoint=False),
                           np.linspace(-89.0, 89.0, ny))
    times = np.array([np.datetime64("2026-08-01T00")])
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = 5.0 * torch.randn((len(names), 1, ny, nx, nmems), generator=gen,
                             device=dev)
    state = EnsembleState.from_vardict(
        {n: data[i] for i, n in enumerate(names)},
        {"validtime": times, "lat": lat, "lon": lon,
         "mem": np.arange(nmems)}, dtype="float32", device=dev)
    s = state.structure
    state = EnsembleState(state.data, StateStructure.build(
        s.var_names, s.times64(), s.lat, s.lon, nmems, var_verts=verts))
    var = rng.integers(0, len(names), nobs)
    batch = ObservationBatch(
        values=rng.normal(0.0, 1.0, nobs), errors=np.ones(nobs),
        lats=rng.uniform(-88.0, 88.0, nobs),
        lons=rng.uniform(0.0, 358.0, nobs),
        times_s=timeutil.to_epoch_seconds(np.repeat(times[0], nobs)),
        obtypes=[names[v] for v in var],
        localize_radius=np.full(nobs, 2000.0),
        assimilate_flags=np.ones(nobs, bool), verts=verts[var],
        descriptions=[None] * nobs, vert_radius=np.full(nobs, 300.0))
    return state, batch, names


def _config3_runs(names):
    """Phase 8's two configurations: ``[(label, cfg, route)]``."""
    from efa_xray_tpu_torch import FilterConfig

    mid = len(C3_LEVELS) // 2
    lev = lambda q: names[C3_QUANTITIES.index(q) * len(C3_LEVELS) + mid]
    spec = {f"{lev('T')}:{lev('Q')}": 0.0, f"{lev('U')}:{lev('V')}": 0.5,
            f"{lev('Q')}:{lev('T')}": 0.3}
    return [("(a) default FilterConfig", FilterConfig(localization="GC"),
             "B4"),
            ("(b) fast_geometry + variable_localization",
             FilterConfig(localization="GC", fast_geometry=True,
                          variable_localization=spec), "B3")]


def _api_phase(label, state, batch, cfg, route, expect, plain=None):
    """Drive ``EnSRF.update()`` once on the card along ``route``, timed
    with its tail/body split (the kernels are built and the device is warm
    from the phases before), check the launch counts (:func:`_counts`)
    with ``expect`` and hold the result against the plain blocked update
    (``plain``, :func:`_plain_update`'s tuple, where given).  Returns a
    dict of the numbers."""
    from efa_xray_tpu_torch import EnSRF

    filt = EnSRF(state, batch, config=cfg, verbose=False)
    check(filt._route(state.structure.nstate) == route,
          f"{label}: routed to {filt._route(state.structure.nstate)}, not "
          f"{route}")
    _reset_counts()
    (post, obs), wall, spent = _timed_update(lambda: filt)
    counts, weights = _counts(), _weight_sources()
    check(expect(counts), f"{label}: launches {counts}")
    mean_err, incr_rms, inn_prior, inn_post = _check_api(
        label, state, batch, cfg, post, obs, plain=plain)
    return dict(counts=counts, weights=weights, mean_err=mean_err,
                incr_rms=incr_rms, inn=(inn_prior, inn_post), wall=wall,
                **spent)


def _api_line(r):
    launched = " ".join(f"{k} {v}" for k, v in r["counts"].items())
    return (f"launches {launched}; posterior mean vs "
            f"plain blocked: max abs diff {r['mean_err']:.3e} (increment RMS "
            f"{r['incr_rms']:.3e}); mean |innov| {r['inn'][0]:.4f} -> "
            f"{r['inn'][1]:.4f}; update wall {r['wall']:.3f} s (tail "
            f"{r['tail']:.3f} s, body {r['body']:.3f} s"
            + (f", of which the blocks' torch operands {r['operands']:.3f} s "
               f"and the B4 launches {r['kernel']:.3f} s; B4 weights by "
               f"source {r['weights']}" if r["counts"]["B4"] else "") + ")")


def phase8():
    """The public API on config 3: B4 at the defaults, B3 with varloc."""
    state, batch, names = _config3_workload()
    nblocks = -(-batch.nobs // 128)
    # The tail: B1 per panel, applied out of panel by B4 (exact haversine
    # in (a), varloc in (b)).
    tail = _tail_counts(batch.nobs, 512, True)
    expects = {"B4": _only(B1=tail["panels"], B4=nblocks + tail["b4"]),
               "B3": _only(B1=tail["panels"], B4=tail["b4"], B3=None)}
    out = {}
    for label, cfg, route in _config3_runs(names):
        r = _api_phase(f"phase 8 {label}", state, batch, cfg, route,
                       expects[route])
        # Every B4 reads w: the body's over 80 groups, the tail's with
        # levels per row (or varloc).
        want = dict(kernel=0, w=tail["b4"] + (nblocks if route == "B4"
                                              else 0), none=0)
        check(r["weights"] == want,
              f"phase 8 {label}: B4 weights by source {r['weights']}, not "
              f"{want}")
        log(f"phase 8: EnSRF.update() config 3 (80 level variables x 90x180 "
            f"x 30 members, {batch.nobs} obs, vertical 300 hPa) {label}, "
            f"route {route}: " + _api_line(r))
        out[route] = r
    return dict(b3=out["B3"]["counts"]["B3"], b4=out["B4"]["counts"]["B4"])


def phase9():
    """Phase 4's workload at the default FilterConfig, through B4."""
    import torch

    from efa_xray_tpu_torch import FilterConfig

    state, batch = _api_state(torch.device("cuda"))
    nblocks = -(-batch.nobs // 128)
    tail = _tail_counts(batch.nobs, 512, True)
    cfg = FilterConfig(localization="GC")
    # Its plain update is kept for phase 29 (b).
    r = _api_phase("phase 9", state, batch, cfg, "B4",
                   _only(B1=tail["panels"], B4=nblocks + tail["b4"]),
                   plain=_plain_kept(("api default", 1024, 10_000, 80),
                                     state, batch, cfg))
    _weights_in_kernel("phase 9", r["counts"], r["weights"])
    log(f"phase 9: EnSRF.update() 1024x1024x80, {batch.nobs} obs at the "
        f"default FilterConfig: " + _api_line(r))
    return dict(b4=r["counts"]["B4"], b1=r["counts"]["B1"],
                b4_weights_in_kernel=r["weights"]["kernel"])


def phase10():
    """B2h against its plain version at phase 3's shape."""
    import torch

    from efa_xray_tpu_torch.assimilation import ensrf_core as core
    from efa_xray_tpu_torch.ops import ensrf_fused

    dev = torch.device("cuda")
    n, m, nobs, alpha = 262_144, 80, 2048, 0.5
    lat, lon, olat, olon, _ = _scattered(n, nobs, 101, dev)
    gen = torch.Generator(device=dev).manual_seed(102)
    rnd = lambda *shape: torch.rand(*shape, generator=gen, device=dev)
    bm = 280.0 + 0.5 * torch.randn(n, generator=gen, device=dev)
    bp = 5.0 * torch.randn(n, m, generator=gen, device=dev)
    body_sigma = 2.0 + 2.0 * rnd(n)
    body_vert = 100.0 + 900.0 * rnd(n)
    tp0 = 5.0 * torch.randn(nobs, m, generator=gen, device=dev)
    tm = tp0.mean(1) + 280.0
    tp = tp0 - tp0.mean(1, keepdim=True)
    obs = core.ObsArrays(
        values=tm + torch.randn(nobs, generator=gen, device=dev),
        errors=torch.ones(nobs, device=dev), lats=olat, lons=olon,
        radii=torch.full((nobs,), 2000.0, device=dev),
        assim=torch.ones(nobs, dtype=torch.bool, device=dev),
        verts=100.0 + 900.0 * rnd(nobs),
        vert_radii=torch.full((nobs,), 300.0, device=dev))
    tail_sigma = 2.0 + 2.0 * rnd(nobs)
    tails = {}
    results = []
    for label, rows, slen, localize, vertical in (
            ("(a) L 1000 km, radius 2000 km", n, 1000.0, True, False),
            ("(a) odd row count", n - 1, 1000.0, True, False),
            ("(b) L 3000 km, radius 2000 km", n, 3000.0, True, False),
            ("(c) unlocalized", n, 1000.0, False, False),
            ("(d) vertical", n, 1000.0, True, True)):
        key = (slen, localize, vertical)
        radius = 2000.0 if localize else None
        if key not in tails:
            # The body's operands: the tail through B1h (held in phase 2).
            tails[key] = core.tail_scan_blocked(
                tm, tp, obs, localize=localize, fast_geometry=True,
                vertical=vertical, panel=512, kernels=True,
                max_radius_km=radius, hybrid_alpha=alpha,
                tail_sigma=tail_sigma, static_length=slen)
        ops = ensrf_fused.prepare(
            bp[:rows], lat[:rows], lon[:rows], tails[key], obs,
            body_vert=body_vert[:rows] if vertical else None,
            localize=localize, block_size=128, max_radius_km=radius,
            hybrid=True, body_sigma=body_sigma[:rows], static_length=slen)
        args = (bm[:rows], bp[:rows], ops["geom"], ops["y_b"], ops["ggt_b"],
                ops["tab_b"], ops["bits"], ops["tile"], localize, vertical,
                ops["series"], True)
        got = ensrf_fused.fused_apply(*args)
        want, p_ms = cuda_timed(lambda: ensrf_fused.fused_apply_plain(*args))
        torch.cuda.synchronize()
        err = max(compare(f"B2h {label} mean", got[0], want[0]),
                  compare(f"B2h {label} perts", got[1], want[1]))
        check(float((got[0] - bm[:rows]).abs().max()) > 0.1,
              f"B2h {label}: the mean did not move")
        alive = (float((ops["bits"] != 0).float().mean())
                 if ops["bits"] is not None else 1.0)
        k_ms = cuda_ms(lambda: ensrf_fused.fused_apply(*args), 3)
        results.append(dict(
            label=label, alive_tile_blocks=alive, max_abs_err=err, ms=k_ms,
            plain_ms=p_ms, form="series" if ops["series"] else "arccos",
            **bound(b2_flop(ops, rows, m, localize, True),
                    nbytes(*args[:7]) + nbytes(*got))))
        del ops, args, got, want
    log("phase 10: B2h (alpha 0.5, per-row sigma, 262,144 x 80 x 2048 obs) "
        "matches plain: " + "; ".join(
            f"{r['label']} {r['form']} (alive tile-blocks "
            f"{r['alive_tile_blocks']:.3f}): err {r['max_abs_err']:.3e} "
            f"kernel {r['ms']:.2f} ms plain {r['plain_ms']:.2f} ms bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']})" for r in results))
    edge_err, edge_labels = _b2_edge_cases(hybrid=True)
    log(f"phase 10: B2h matches plain at 20,001 rows x 300 obs (max abs err "
        f"{edge_err:.3e}): " + ", ".join(edge_labels))
    head = results[0]
    return dict(max_abs_err=max([edge_err] + [r["max_abs_err"]
                                              for r in results]),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"])


def _hybrid_config(nstate: int, seed: int):
    """Phase 11's hybrid ``FilterConfig``: chordal localization at the
    obs' radii, alpha 0.5, a static std drawn per state row in [2, 4] and a
    1000 km static length."""
    from efa_xray_tpu_torch import FilterConfig

    sigma = np.random.default_rng(seed).uniform(2.0, 4.0, nstate)
    return FilterConfig(localization="GC", fast_geometry=True,
                        hybrid_alpha=0.5, static_b_sigma=sigma,
                        static_b_length=1000.0)


def phase11():
    """The hybrid path through the public API, on phase 4's workload and
    on config 3: B2h and no other kernel."""
    import torch

    state, batch = _api_state(torch.device("cuda"))
    cfg = _hybrid_config(state.structure.nstate, 111)
    panels = _tail_counts(batch.nobs, 512, False)["panels"]
    r = _api_phase("phase 11 (a)", state, batch, cfg, "B2h",
                   _only(B1h=panels, B2h=None))
    log(f"phase 11: EnSRF.update() hybrid 1024x1024x80, {batch.nobs} obs "
        f"(alpha 0.5, per-row sigma, L 1000 km, fast_geometry), route B2h: "
        + _api_line(r))
    del state, batch
    state, batch, _ = _config3_workload()
    r3 = _api_phase("phase 11 (b)", state, batch,
                    _hybrid_config(state.structure.nstate, 112), "B2h",
                    _only(B1h=_tail_counts(batch.nobs, 512, False)["panels"],
                          B2h=None))
    log(f"phase 11: EnSRF.update() hybrid config 3 (80 level variables x "
        f"90x180 x 30 members, {batch.nobs} obs, vertical 300 hPa), route "
        f"B2h: " + _api_line(r3))
    return dict(b2h=r["counts"]["B2h"], b1h=r["counts"]["B1h"])


def phase13():
    """A ``fast_geometry`` update at 128 members (a 1024 x 1024 grid, 2048
    obs): B1 at 512 x 128 over a cluster, then B2."""
    import torch

    from efa_xray_tpu_torch import FilterConfig
    from efa_xray_tpu_torch.ops import tail_solve

    state, batch = _api_state(torch.device("cuda"), nmems=128, nobs=2048,
                              seed=13)
    panels = _tail_counts(batch.nobs, 512, False)["panels"]
    r = _api_phase("phase 13", state, batch,
                   FilterConfig(localization="GC", fast_geometry=True), "B2",
                   _only(B1=panels, B2=None))
    log(f"phase 13: EnSRF.update() 1024x1024x128, {batch.nobs} obs with "
        f"fast_geometry (B1 over {tail_solve.pick_cluster(512, 128)} CTAs): "
        + _api_line(r))


def phase14():
    """A float64 update on the card at a small shape (128 x 128 x 20, 500
    obs): the plain blocked update and no kernel, within 1e-3 of the
    increment RMS of the float32 update through B1 and B4."""
    import torch

    from efa_xray_tpu_torch import EnSRF, FilterConfig

    state, batch = _api_state(torch.device("cuda"), nmems=20, nobs=500,
                              seed=14, ny=128)
    cfg64 = FilterConfig(localization="GC", dtype="float64")
    filt = EnSRF(state, batch, config=cfg64, verbose=False)
    route = filt._route(state.structure.nstate)
    check(route == "plain", f"phase 14: float64 routed to {route}")
    _reset_counts()
    t0 = time.perf_counter()
    post64, obs64 = filt.update()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    check(_only()(counts), f"phase 14: launches {counts}")
    post32, _ = EnSRF(state, batch, config=FilterConfig(localization="GC"),
                      verbose=False).update()
    m64 = post64.to_vect().mean(dim=1)
    prior = state.to_vect().double().mean(dim=1)
    incr_rms = float(torch.sqrt(torch.mean((m64 - prior) ** 2)))
    diff = float((post32.to_vect().double().mean(dim=1) - m64).abs().max())
    check(filt.dtype == torch.float64
          and bool(torch.isfinite(post64.data).all())
          and diff <= 1e-3 * incr_rms,
          f"phase 14: update in {filt.dtype}, float32 differs "
          f"by {diff:.3e} against an increment RMS of {incr_rms:.3e}")
    log(f"phase 14: EnSRF.update() float64 on the card, 128x128x20, "
        f"{batch.nobs} obs: route {route}, no kernel launched; posterior "
        f"mean vs the float32 kernel update: max abs diff {diff:.3e} "
        f"(increment RMS {incr_rms:.3e}); wall {wall:.3f} s")


# ---------------------------------------------------------------------------
# The cycled production filter (BASELINE config 13) and its options
# ---------------------------------------------------------------------------


def _popcount_share(bits, npanels: int) -> float:
    """Share of the 8-ob panels that cull bits ``bits`` keep alive."""
    import torch

    b = bits.to(torch.int64) & 0xFFFFFFFF
    alive = sum(int(((b >> q) & 1).sum()) for q in range(npanels))
    return alive / (b.numel() * npanels)


def _b2_body_stats(state, batch, cfg):
    """B2's body launch of ``EnSRF(state, batch, config=cfg).update()`` on
    its own: the kernel's ms (CUDA events, median of 3, on a copy of the
    prior), and the shares of (row tile, obs block) pairs and of 8-ob
    panels that the cull keeps alive, in the order the update runs (sorted
    obs with ``obs_order``, sorted rows with ``spatial_sort``)."""
    import torch

    from efa_xray_tpu_torch import EnSRF
    from efa_xray_tpu_torch.ops import ensrf_fused

    filt = EnSRF(state, batch, config=cfg, verbose=False)
    bm, bp, tm, tp = filt.format_prior_state()
    oa = filt.obs_arrays()
    blat, blon = state.structure.row_latlon_device(torch.float32,
                                                   state.device)
    if cfg.spatial_sort:
        order, _ = state.structure.spatial_order_device(state.device)
        bm, bp, blat, blon = (x[order] for x in (bm, bp, blat, blon))
    tail = filt._kernel_tail(tm, tp, oa, False, {}, {})
    ops = ensrf_fused.prepare(bp, blat, blon, tail, oa,
                              block_size=cfg.block_size, cull=cfg.cull,
                              max_radius_km=filt.max_finite_radius())
    ms = cuda_ms(lambda: ensrf_fused.fused_apply(
        bm, bp, ops["geom"], ops["y_b"], ops["ggt_b"], ops["tab_b"],
        ops["bits"], ops["tile"], True, False, ops["series"]), 3)
    npanels = -(-cfg.block_size // ensrf_fused.PANEL)
    return dict(ms=ms, pairs=float((ops["bits"] != 0).float().mean()),
                panels=_popcount_share(ops["bits"], npanels))


def _perts_err(label, post, want_perts, prior_perts):
    """Max abs error of the posterior's perturbations against
    ``want_perts``; raises beyond 1e-3 x the RMS of their increment."""
    import torch

    v = post.to_vect()
    got = v - v.mean(dim=1, keepdim=True)
    incr_rms = float(torch.sqrt(torch.mean((want_perts - prior_perts) ** 2)))
    err = float((got - want_perts).abs().max())
    check(err <= 1e-3 * incr_rms,
          f"{label}: perturbations differ from the plain formula by "
          f"{err:.3e} > 1e-3 x increment RMS {incr_rms:.3e}")
    return err, incr_rms


def _flat_scattered_state(dev, n, nmems, nobs, radius, seed):
    """A flat state (one location axis) of ``n`` scattered points in
    random order, ``nmems`` members, and ``nobs`` random obs at
    ``radius``: ``(state, batch)``."""
    import torch

    from efa_xray_tpu_torch import EnsembleState
    from efa_xray_tpu_torch.observation.observation import ObservationBatch
    from efa_xray_tpu_torch.utils import timeutil

    rng = np.random.default_rng(seed)
    lat = rng.uniform(-88.0, 88.0, n)
    lon = rng.uniform(0.0, 360.0, n)
    times = np.array([np.datetime64("2026-08-01T00")])
    field = torch.from_numpy(rng.normal(280, 5, (1, n, nmems)).astype(
        np.float32)).to(dev)
    state = EnsembleState.from_vardict({"T2m": field}, {
        "validtime": times, "lat": lat, "lon": lon}, dtype="float32",
        device=dev)
    batch = ObservationBatch(
        values=rng.normal(280, 5, nobs), errors=np.ones(nobs),
        lats=rng.uniform(-85, 85, nobs), lons=rng.uniform(0, 360, nobs),
        times_s=timeutil.to_epoch_seconds(np.repeat(times[0], nobs)),
        obtypes=["T2m"] * nobs, localize_radius=np.full(nobs, radius),
        assimilate_flags=np.ones(nobs, bool), verts=np.full(nobs, np.nan),
        descriptions=[None] * nobs)
    return state, batch


def phase15(dev="cuda", ny=1024, nobs=10_000, nmems=80, flat_n=262_144,
            flat_obs=2048):
    """A7 on the card: phase 4's workload with and without
    ``obs_order="hilbert"`` (B2's body ms and the cull's alive shares),
    ``spatial_sort`` on a flat state of shuffled rows, and RTPS/RTPP,
    each held against the plain update."""
    import dataclasses

    import torch

    from efa_xray_tpu_torch import EnSRF, FilterConfig
    from efa_xray_tpu_torch.assimilation.adaptive_inflation import (
        row_spread,
        rtpp,
        rtps,
    )

    state, batch = _api_state(dev, ny=ny, nobs=nobs, nmems=nmems)
    base = FilterConfig(localization="GC", fast_geometry=True)
    panels = _tail_counts(batch.nobs, base.tail_panel, False)["panels"]
    plain = _plain_kept(("api", ny, nobs, nmems), state, batch, base)
    out = {}
    for order in (None, "hilbert"):
        cfg = dataclasses.replace(base, obs_order=order)
        _reset_counts()
        (post, obs), wall, spent = _timed_update(
            lambda: EnSRF(state, batch, config=cfg, verbose=False))
        counts = _counts()
        check(_only(B1=panels, B2=panels + 1)(counts),
              f"phase 15 obs_order={order}: launches {counts}")
        check(np.array_equal(obs.values, batch.values)
              and np.array_equal(obs.lats, batch.lats),
              f"phase 15 obs_order={order}: batch not in the caller's order")
        mean_err, incr_rms, *_ = _check_api(
            f"phase 15 obs_order={order}", state, batch, cfg, post, obs,
            plain=plain if order is None else None)
        body = _b2_body_stats(state, batch, cfg)
        out[order] = body
        log(f"phase 15 (a): EnSRF.update() {ny}x{ny}x{nmems}, {batch.nobs} obs, "
            f"fast_geometry, obs_order={order}: launches B1 "
            f"{counts['B1']} B2 {counts['B2']}; wall {wall:.3f} s (tail "
            f"{spent['tail']:.3f} s, body {spent['body']:.3f} s); B2 body "
            f"launch {body['ms']:.2f} ms, cull alive: (tile, block) pairs "
            f"{body['pairs']:.4f}, 8-ob panels {body['panels']:.4f}; "
            f"posterior mean vs plain max abs diff {mean_err:.3e} "
            f"(increment RMS {incr_rms:.3e}); batch in the caller's order")

    fstate, fbatch = _flat_scattered_state(dev, flat_n, nmems, flat_obs,
                                           1000.0, 151)
    posts, bodies = [], {}
    for sort in (False, True):
        cfg = FilterConfig(localization="GC", fast_geometry=True,
                           obs_order="hilbert", spatial_sort=sort)
        _reset_counts()
        post, obs = EnSRF(fstate, fbatch, config=cfg, verbose=False).update()
        counts = _counts()
        check(_only(B1=None, B2=None)(counts),
              f"phase 15 spatial_sort={sort}: launches {counts}")
        posts.append(post)
        bodies[sort] = _b2_body_stats(fstate, fbatch, cfg)
    err = compare("phase 15 spatial_sort", posts[1].data, posts[0].data)
    log(f"phase 15 (b): EnSRF.update() flat state of {flat_n} shuffled "
        f"rows x {nmems}, {flat_obs} obs at 1000 km, obs_order=hilbert: "
        f"spatial_sort=True vs False max abs diff {err:.3e}; B2 body launch "
        + "; ".join(f"spatial_sort={k}: {v['ms']:.2f} ms, alive pairs "
                    f"{v['pairs']:.4f}, panels {v['panels']:.4f}"
                    for k, v in bodies.items()))

    bm, bp, pbm, pbp = plain
    want = {"rtps_alpha": rtps(row_spread(bp), pbp, 0.5),
            "rtpp_alpha": rtpp(bp, pbp, 0.5)}
    for key, want_perts in want.items():
        cfg = dataclasses.replace(base, **{key: 0.5})
        _reset_counts()
        post, obs = EnSRF(state, batch, config=cfg, verbose=False).update()
        counts = _counts()
        check(_only(B1=panels, B2=panels + 1)(counts),
              f"phase 15 {key}: launches {counts}")
        mean_err, incr_rms, *_ = _check_api(f"phase 15 {key}", state, batch,
                                            cfg, post, obs, plain=plain)
        perr, pincr = _perts_err(f"phase 15 {key}", post, want_perts, bp)
        log(f"phase 15 (c): EnSRF.update() {ny}x{ny}x{nmems}, {batch.nobs} obs, "
            f"{key}=0.5: launches B1 {counts['B1']} B2 {counts['B2']}; vs "
            f"the plain update relaxed by the plain formula: mean max abs "
            f"diff {mean_err:.3e} (increment RMS {incr_rms:.3e}), "
            f"perturbations {perr:.3e} (increment RMS {pincr:.3e})")
    return out


def _api_batch(nobs, seed, ny=1024):
    """Random obs over phase 4's grid at 2000 km (a batch of another
    size for the chunk sweep)."""
    from efa_xray_tpu_torch.observation.observation import ObservationBatch
    from efa_xray_tpu_torch.utils import timeutil

    rng = np.random.default_rng(seed)
    t0 = np.datetime64("2026-08-01T00")
    return ObservationBatch(
        values=rng.normal(280, 5, nobs), errors=np.ones(nobs),
        lats=rng.uniform(-85, 85, nobs), lons=rng.uniform(0, 360, nobs),
        times_s=timeutil.to_epoch_seconds(np.repeat(t0, nobs)),
        obtypes=["T2m"] * nobs, localize_radius=np.full(nobs, 2000.0),
        assimilate_flags=np.ones(nobs, bool), verts=np.full(nobs, np.nan),
        descriptions=[None] * nobs)


def _peak_update(state, batch, cfg):
    """One update: ``(post, obs, wall seconds, peak GB allocated, launch
    counts)``."""
    import torch

    from efa_xray_tpu_torch import EnSRF

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    post, obs = EnSRF(state, batch, config=cfg, verbose=False).update()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (post, obs, wall, torch.cuda.max_memory_allocated() / 1e9,
            _counts())


def phase16(dev="cuda", ny=1024, nobs=10_000, nmems=80,
            sweep=(40_000, 160_000), chunk=4096, c3_chunk=2048):
    """``obs_chunk`` on the card: chunked against one-shot through B2
    (phase 4's workload), B3 (config 3, ``fast_geometry``) and B4 (config
    3, the default config), with the launches and the peak memory; then
    one-shot batches of growing size on phase 4's grid beside a chunked
    one."""
    import dataclasses

    import torch

    from efa_xray_tpu_torch import FilterConfig

    def run(label, state, batch, cfg, n_chunk, expect):
        one = _peak_update(state, batch, cfg)
        many = _peak_update(state, batch,
                            dataclasses.replace(cfg, obs_chunk=n_chunk))
        for name, r, ok in (("one-shot", one, expect[0]),
                            ("chunked", many, expect[1])):
            check(ok(r[4]), f"phase 16 {label} {name}: launches {r[4]}")
        err = compare(f"phase 16 {label} chunked vs one-shot",
                      many[0].data, one[0].data)
        for k in ("prior_mean", "prior_var", "post_mean", "post_var"):
            compare(f"phase 16 {label} {k}",
                    torch.from_numpy(getattr(many[1], k)),
                    torch.from_numpy(getattr(one[1], k)))
        fmt = lambda c: " ".join(f"{k} {v}" for k, v in c.items() if v)
        log(f"phase 16: {label}, {batch.nobs} obs in chunks of {n_chunk}: "
            f"chunked vs one-shot max abs diff {err:.3e}; launches one-shot "
            f"{fmt(one[4])}, chunked {fmt(many[4])}; wall {one[2]:.3f} / "
            f"{many[2]:.3f} s; peak allocated {one[3]:.2f} / {many[3]:.2f} "
            "GB")

    state, batch = _api_state(dev, ny=ny, nobs=nobs, nmems=nmems)
    cfg = FilterConfig(localization="GC", fast_geometry=True)
    p1 = _tail_counts(batch.nobs, 512, False)["panels"]
    nch = -(-batch.nobs // chunk)
    p2 = nch * chunk // 512
    run(f"B2, {ny}x{ny}x{nmems}", state, batch, cfg, chunk,
        (_only(B1=p1, B2=p1 + 1), _only(B1=p2, B2=p2 + nch)))

    sizes = []
    for n in sweep:
        big = _api_batch(n, 160 + len(sizes), ny=ny)
        one = _peak_update(state, big, cfg)
        check(bool(torch.isfinite(one[0].data).all()),
              f"phase 16: one-shot {n} obs not finite")
        sizes.append((n, one[2], one[3]))
        del one
    many = _peak_update(state, big, dataclasses.replace(cfg,
                                                        obs_chunk=16_384))
    check(bool(torch.isfinite(many[0].data).all()),
          f"phase 16: chunked {sweep[-1]} obs not finite")
    log(f"phase 16: one-shot B2 updates on {ny}x{ny}x{nmems}: "
        + ", ".join(f"{n} obs {w:.3f} s peak {g:.2f} GB"
                    for n, w, g in sizes)
        + f" (largest one-shot run: {sizes[-1][0]} obs); chunked (16384) at "
        f"{sweep[-1]} obs {many[2]:.3f} s peak {many[3]:.2f} GB")
    del state, batch, big, many

    state, batch, _ = _config3_workload()
    q1 = _tail_counts(batch.nobs, 512, True)
    nch3 = -(-batch.nobs // c3_chunk)
    q2 = _tail_counts(nch3 * c3_chunk, 512, True)
    b3_ok = lambda panels, least: (
        lambda c: _only(B1=panels, B2=panels, B3=None)(c)
        and c["B3"] >= least)
    run("B3, config 3 fast_geometry", state, batch,
        FilterConfig(localization="GC", fast_geometry=True), c3_chunk,
        (b3_ok(q1["panels"], 1), b3_ok(q2["panels"], nch3)))
    nb = -(-batch.nobs // 128)
    run("B4, config 3 default", state, batch,
        FilterConfig(localization="GC"), c3_chunk,
        (_only(B1=q1["panels"], B4=nb + q1["b4"]),
         _only(B1=q2["panels"],
               B4=nch3 * -(-c3_chunk // 128) + q2["b4"])))


# Config 13's published defaults (benchmarks/cycled_production.py's
# argparse): grid, members, obs, radius (km), ob bias, inflation damping
# and cap, bias-correction rate, cycles.
CONFIG13 = dict(ny=320, nx=320, nmems=40, nobs=8000, radius=500.0,
                ob_bias=0.3, damp=0.7, adaptive_max=1.7, bias_alpha=0.2,
                cycles=20)


def _check_colored_inflation(adapt0, adapt, out, cfg, dev):
    """On cycle 0's innovations: the colored Anderson update on the card
    against the per-ob scan in color order, both from the pre-update
    fields ``adapt0`` in float64, and the fields the update learned
    (``adapt``) against the colored update, damped; returns the max abs
    differences of the mean and std fields and the colors."""
    import torch

    from efa_xray_tpu_torch.assimilation import adaptive_inflation as ai

    s = adapt0.structure
    f64 = torch.float64
    t = lambda x: torch.as_tensor(np.array(x, np.float64), dtype=f64,
                                  device=dev)
    innov = out.values - out.prior_mean
    coloring = ai.build_obs_coloring(s.lat.ravel(), s.lon.ravel(), out.lats,
                                     out.lons, out.localize_radius,
                                     device=dev)
    check(coloring is not None, "phase 17: the network did not color")
    order, sizes, row_ob = coloring
    attrs, use = ai.pack_color_tables(order, sizes, out.lats, out.lons,
                                      out.localize_radius, innov,
                                      out.prior_var, out.errors,
                                      out.assimilated)
    lam = t(adapt0.mean["X"].reshape(1, 1, -1))
    sd = t(np.maximum(adapt0.std["X"].reshape(1, 1, -1), 1e-4))
    kw = dict(lambda_min=cfg.adaptive_min, lambda_max=cfg.adaptive_max,
              evolve_sd=True, sd_min=cfg.adaptive_sd_min)
    glat, glon = t(s.lat.ravel()), t(s.lon.ravel())
    colored = ai.update_inflation_rows_colored(
        lam, sd, glat, glon, row_ob, t(attrs), torch.as_tensor(use,
                                                                device=dev),
        **kw)
    o = lambda a: t(np.asarray(a, np.float64)[order])
    scan = ai.update_inflation_rows(
        lam, sd, glat, glon, o(out.lats), o(out.lons),
        o(out.localize_radius), o(innov), o(out.prior_var), o(out.errors),
        torch.as_tensor(np.asarray(out.assimilated)[order], device=dev),
        **kw)
    errs = [compare(f"phase 17 colored vs scan {k}", a, b)
            for k, a, b in zip(("mean", "std"), colored, scan)]
    damped = torch.clamp(1.0 + cfg.adaptive_damp * (colored[0] - 1.0),
                         min=cfg.adaptive_min)
    compare("phase 17 learned mean vs the colored update",
            t(adapt.mean["X"].reshape(1, 1, -1)), damped)
    compare("phase 17 learned std vs the colored update",
            t(adapt.std["X"].reshape(1, 1, -1)), colored[1])
    return errs, len(sizes)


def phase17(dev="cuda", ny=None, nx=None, nmems=None, nobs=None,
            radius=None, cycles=None):
    """The production cycle of BASELINE config 13 at its published
    defaults (``CONFIG13``; arguments cut it down): the L96-2d forecast,
    synthetic obs of the truth with a network bias, online bias
    correction, ``EnSRF.update()`` with ``fast_geometry``, the outlier
    check and Anderson adaptive inflation (evolved std, damping, a cap),
    and the verification, in float32 through the public API."""
    import dataclasses

    import torch

    from efa_xray_tpu_torch import (
        AdaptiveInflation,
        EnSRF,
        EnsembleState,
        FilterConfig,
    )
    from efa_xray_tpu_torch.models import l96_2d
    from efa_xray_tpu_torch.observation import forward as fwd
    from efa_xray_tpu_torch.observation.bias import BiasCorrection
    from efa_xray_tpu_torch.observation.observation import ObservationBatch
    from efa_xray_tpu_torch.postprocess.verification import crps
    from efa_xray_tpu_torch.state.structure import StateStructure
    from efa_xray_tpu_torch.utils import timeutil

    p = dict(CONFIG13)
    p.update({k: v for k, v in dict(ny=ny, nx=nx, nmems=nmems, nobs=nobs,
                                    radius=radius, cycles=cycles).items()
              if v is not None})
    ny, nx, nmems, nobs = p["ny"], p["nx"], p["nmems"], p["nobs"]
    sync = _syncer(dev)
    t0 = time.perf_counter()
    truth, ens = l96_2d.spinup_ensemble(ny=ny, nx=nx, nmems=nmems, seed=3,
                                        device=dev, dtype=torch.float32)
    sync()
    spinup = time.perf_counter() - t0
    # The forecast on the card against float64 on the CPU, 4 steps.
    start = ens[:8]
    ferr = compare("phase 17 L96-2d forecast, card vs float64 CPU",
                   l96_2d.integrate(start, nsteps=4),
                   l96_2d.integrate(start.double().cpu(), nsteps=4).to(dev))

    lat, lon = l96_2d.grid_latlon(ny, nx)
    times = np.datetime64("2026-08-01T00:00:00") + np.arange(1)
    structure = StateStructure.build(["X"], times, lat, lon, nmems)
    rng = np.random.default_rng(11)
    ob_lats = rng.uniform(-58.0, 58.0, nobs)
    ob_lons = rng.uniform(0.0, 360.0, nobs)
    times_s = timeutil.to_epoch_seconds(np.repeat(times[0], nobs))
    taps = fwd.build_taps_cached(structure, ob_lats, ob_lons, times_s,
                                 np.zeros(nobs, dtype=np.int32), device=dev)
    cfg = FilterConfig(localization="GC", dtype="float32",
                       fast_geometry=True, outlier_threshold=4.0,
                       adaptive_sd_evolve=True, adaptive_sd_min=0.15,
                       adaptive_damp=p["damp"],
                       adaptive_max=p["adaptive_max"])
    as_state = lambda e: EnsembleState(
        e.permute(1, 2, 0)[None, None].contiguous(), structure)
    adapt = AdaptiveInflation(as_state(ens), ("adaptive", None, (1.0, 0.6)))
    bias = BiasCorrection(alpha=p["bias_alpha"])

    def make_batch(values):
        return ObservationBatch(
            values=values, errors=np.ones(nobs), lats=ob_lats,
            lons=ob_lons, times_s=times_s, obtypes=["X"] * nobs,
            localize_radius=np.full(nobs, p["radius"]),
            assimilate_flags=np.ones(nobs, bool), verts=np.full(nobs, np.nan),
            descriptions=[None] * nobs)

    rows = []
    for c in range(p["cycles"]):
        ph = {}
        t0 = time.perf_counter()
        truth = l96_2d.integrate(truth, nsteps=4)
        ens = l96_2d.integrate(ens, nsteps=4)
        sync()
        ph["forecast"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        ye_t = fwd.apply_taps_obj(truth.reshape(-1, 1), taps)[:, 0]
        raw = (ye_t.double().cpu().numpy() + rng.normal(0.0, 1.0, nobs)
               + p["ob_bias"])
        batch = bias.correct(make_batch(raw))
        ph["obgen"] = time.perf_counter() - t0

        fmean = ens.mean(dim=0)
        rmse_f = float(torch.sqrt(torch.mean((fmean - truth) ** 2)))
        if c == 0:
            adapt0 = AdaptiveInflation.from_fields(
                structure, adapt.mean, adapt.std, device=dev)
        state = as_state(ens)
        _reset_counts()
        (post, out), ph["update"], spent = _timed_update(
            lambda: EnSRF(state, batch, inflation=adapt, config=cfg,
                          verbose=False))
        counts = _counts()
        check(_only(B1=None, B2=None)(counts),
              f"phase 17 cycle {c}: launches {counts}")

        t0 = time.perf_counter()
        bias.update(dataclasses.replace(out, values=raw))
        nrej = int(np.sum(out.qc_outlier))
        ph["bias_qc"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        amean = post.data[0, 0].mean(dim=-1)
        aspread = post.data[0, 0].std(dim=-1, unbiased=False)
        rmse = float(torch.sqrt(torch.mean((amean - truth) ** 2)))
        spread = float(torch.sqrt(torch.mean(aspread ** 2)))
        _, cval = crps(post, batch)
        ph["verify"] = time.perf_counter() - t0

        lam = adapt.mean["X"]
        check(bool(torch.isfinite(post.data).all()),
              f"phase 17 cycle {c}: posterior not finite")
        check(rmse < rmse_f, f"phase 17 cycle {c}: analysis RMSE {rmse:.4f} "
              f"not below the forecast's {rmse_f:.4f}")
        check(cfg.adaptive_min - 1e-9 <= lam.min()
              and lam.max() <= cfg.adaptive_max + 1e-9,
              f"phase 17 cycle {c}: inflation in [{lam.min()}, "
              f"{lam.max()}]")
        if c == 0:
            mean_err, incr_rms, *_ = _check_api(
                "phase 17 cycle 0", state, batch, cfg, post, out,
                inflation=adapt0)
            (cm, cs), ncolors = _check_colored_inflation(adapt0, adapt,
                                                         out, cfg, dev)
            log(f"phase 17 cycle 0 checks: posterior mean vs the plain "
                f"update max abs diff {mean_err:.3e} (increment RMS "
                f"{incr_rms:.3e}); colored Anderson ({ncolors} colors) vs "
                f"the per-ob scan in color order, float64 on the device: "
                f"mean {cm:.3e}, std {cs:.3e}; L96-2d 4 steps vs float64 "
                f"CPU {ferr:.3e}; spin-up {spinup:.2f} s")
        ens = post.data[0, 0].permute(2, 0, 1).contiguous()
        rows.append(dict(cycle=c, rmse_f=rmse_f, rmse=rmse, spread=spread,
                         crps=cval, qc_rejected=nrej,
                         est_bias=bias.offset_for("X"),
                         lam_min=float(lam.min()), lam_max=float(lam.max()),
                         B1=counts["B1"], B2=counts["B2"], **ph,
                         **{f"update_{k}": spent[k]
                            for k in ("tail", "body", "learn")}))
        log("phase 17 cycle " + json.dumps(rows[-1]))

    late = rows[-3:]
    keys = ("forecast", "obgen", "update", "bias_qc", "verify")
    late_mean = {k: statistics.mean(r[k] for r in late) for k in keys}
    late_update = {k: statistics.mean(r[f"update_{k}"] for r in late)
                   for k in ("tail", "body", "learn")}
    half = rows[len(rows) // 2:]
    mean_of = lambda k: statistics.mean(r[k] for r in half)
    summary = dict(
        ngrid=ny * nx, nmems=nmems, nobs=nobs, cycles=p["cycles"],
        late_cycle_phases_seconds=late_mean,
        late_cycle_total_seconds=sum(late_mean.values()),
        late_cycle_update_split_seconds=late_update,
        mean_rmse_2nd_half=mean_of("rmse"),
        mean_spread_2nd_half=mean_of("spread"),
        spread_over_rmse_2nd_half=mean_of("spread") / mean_of("rmse"),
        mean_crps_2nd_half=mean_of("crps"),
        ob_bias_true=p["ob_bias"], ob_bias_estimated_final=rows[-1]["est_bias"],
        qc_rejected_total=sum(r["qc_rejected"] for r in rows),
        inflation_field_minmax=[rows[-1]["lam_min"], rows[-1]["lam_max"]],
        launches_per_cycle={"B1": sorted({r["B1"] for r in rows}),
                            "B2": sorted({r["B2"] for r in rows})})
    log("phase 17: config 13 cycled production " + json.dumps(summary))
    return summary


# ---------------------------------------------------------------------------
# The other two solvers: the stochastic EnKF and the LETKF (ROADMAP A9)
# ---------------------------------------------------------------------------

# BASELINE configs 11 and 6 (``benchmarks/run_benchmarks.py:858-912`` and
# ``:616-641``): a 0.5-degree global grid, 40 members, 2,000 obs at
# random grid points, R = 1, 2000 km.
CONFIG11 = dict(ny=361, nx=720, nmems=40, nobs=2000, radius=2000.0, seed=6,
                block=128)
CONFIG6 = dict(ny=361, nx=720, nmems=40, nobs=2000, radius=2000.0, seed=2,
               patch=8, k=64, chunk=512)
# BASELINE config 7 (``:644-682``): scattered points in Hilbert order.
CONFIG7 = dict(npts=4_194_304, nmems=80, nobs=10_000, radius=2000.0, seed=4,
               patch=8, k=64, chunk=512)
# The solvers' f32 gates: a posterior within this share of the increment
# RMS of another computation of the same analysis.
SOLVER_GATE = 1e-3


def _half_degree_workload(dev, ny, nx, nmems, nobs, radius, seed,
                          region=False, **_):
    """Configs 6 and 11 as a user builds them: the prior N(280, 5) drawn
    on the device, ``nobs`` obs at grid points drawn with replacement
    (duplicates give equal chord dots), each the ensemble mean there plus
    N(0, 1), R = 1.  ``region``: ``ny`` x ``nx`` points of the
    half-degree grid from 16 S, 200 E instead of the global ``ny`` x
    ``nx`` one.  Returns ``(state, batch)``."""
    import torch

    from efa_xray_tpu_torch import EnsembleState
    from efa_xray_tpu_torch.observation.observation import ObservationBatch
    from efa_xray_tpu_torch.utils import timeutil

    rng = np.random.default_rng(seed)
    lon, lat = np.meshgrid(np.arange(nx) * (360.0 / nx),
                           np.linspace(-90.0, 90.0, ny))
    if region:
        lon, lat = np.meshgrid(200.0 + 0.5 * np.arange(nx),
                               -16.0 + 0.5 * np.arange(ny))
    times = np.array([np.datetime64("2026-08-01T00")])
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = 280.0 + 5.0 * torch.randn((1, ny, nx, nmems), generator=gen,
                                     device=dev)
    rows = rng.integers(0, ny * nx, nobs)
    at = data.reshape(-1, nmems)[torch.from_numpy(rows).to(dev)]
    values = at.double().mean(dim=1).cpu().numpy() + rng.normal(0, 1, nobs)
    state = EnsembleState.from_vardict(
        {"T2m": data}, {"validtime": times, "lat": lat, "lon": lon,
                        "mem": np.arange(nmems)}, dtype="float32",
        device=dev)
    batch = ObservationBatch(
        values=values, errors=np.ones(nobs), lats=lat.ravel()[rows],
        lons=lon.ravel()[rows],
        times_s=timeutil.to_epoch_seconds(np.repeat(times[0], nobs)),
        obtypes=["T2m"] * nobs, localize_radius=np.full(nobs, radius),
        assimilate_flags=np.ones(nobs, bool), verts=np.full(nobs, np.nan),
        descriptions=[None] * nobs)
    return state, batch


def _as_float64(state):
    """The same prior held in float64 (an exact copy), so that a float64
    update's posterior is not rounded back to float32."""
    from efa_xray_tpu_torch import EnsembleState

    return EnsembleState(state.data.double(), state.structure)


def _posterior_gap(label, got, want, prior, gate=SOLVER_GATE):
    """How far posterior ``got`` lies from ``want`` (two EnsembleStates of
    one analysis), against the increment of ``want`` from ``prior``: the
    RMS and max abs gaps of the mean and of the perturbations, and the
    RMS of each increment.  Raises when an RMS gap exceeds ``gate`` times
    its increment RMS.  (The max gap of a float32 mean near 280 carries
    the rounding of every ob's update at that scale, ~1.5e-5 each, and is
    printed, not gated.)"""
    import torch

    def split(s):
        v = s.to_vect().double()
        m = v.mean(dim=1)
        return m, v - m[:, None]

    rms = lambda x: float(torch.sqrt(torch.mean(x * x)))
    gm, gp = split(got)
    wm, wp = split(want)
    pm, pp = split(prior)
    out = dict(mean_rms=rms(gm - wm), mean_max=float((gm - wm).abs().max()),
               mean_incr_rms=rms(wm - pm), perts_rms=rms(gp - wp),
               perts_max=float((gp - wp).abs().max()),
               perts_incr_rms=rms(wp - pp))
    check(bool(torch.isfinite(got.data).all()), f"{label}: not finite")
    check(out["mean_rms"] <= gate * out["mean_incr_rms"]
          and out["perts_rms"] <= gate * out["perts_incr_rms"],
          f"{label}: RMS gaps {json.dumps(out)} above {gate} x the "
          "increment RMS")
    return out


def _innovations(label, batch, obs, var_shrinks=True):
    """Mean |innovation| before and after; raises unless every ob was
    assimilated, the mean |innovation| shrank and (``var_shrinks``) no
    ob's posterior variance exceeds its prior's."""
    a = obs.assimilated
    check(bool(a.all()), f"{label}: not every ob assimilated")
    check(all(np.isfinite(x).all() for x in (obs.prior_mean, obs.post_mean,
                                              obs.prior_var, obs.post_var)),
          f"{label}: diagnostics not finite")
    inn0 = float(np.mean(np.abs(batch.values - obs.prior_mean)))
    inn1 = float(np.mean(np.abs(batch.values - obs.post_mean)))
    check(inn1 < inn0, f"{label}: innovations did not shrink")
    if var_shrinks:
        check(bool((obs.post_var <= obs.prior_var * (1 + 1e-5)).all()),
              f"{label}: post_var > prior_var")
    return inn0, inn1


def phase18(dev="cuda", **cut):
    """The stochastic EnKF at BASELINE config 11 through
    ``EnKF(...).update()``: ``fast_geometry``, blocks of 128, seed 6, on
    its kernel route (B1e once per 512-ob panel, B2e out of panel and for
    the body): warm, split into tail and body, no read back inside the
    update, held against the plain route (the per-ob tail and the plain
    body); the serial update and a float64 one (the plain route) with the
    same draws; the default config (exact haversine: B1e + B4e).  B2e and
    B4e against their plain versions on the update's own operands."""
    import dataclasses

    import torch

    from efa_xray_tpu_torch import EnKF, FilterConfig
    from efa_xray_tpu_torch.assimilation import enkf as tenkf
    from efa_xray_tpu_torch.assimilation import ensrf_core as core

    p = dict(CONFIG11, **cut)
    sync = _syncer(dev)
    cuda = torch.device(dev).type == "cuda"
    state, batch = _half_degree_workload(dev, **p)
    cfg = FilterConfig(localization="GC", fast_geometry=True,
                       block_size=p["block"])
    run = lambda c: (lambda: EnKF(state, batch, config=c, verbose=False,
                                  seed=p["seed"]).update())
    split = [(core, "tail_scan_blocked", "tail"),
             (tenkf, "enkf_kernel_body", "body")]
    real = tenkf.enkf_kernel_update
    seen = {}

    def capture(route, *a, **k):
        seen.setdefault(route, (a, k))
        return real(route, *a, **k)

    tenkf.enkf_kernel_update = capture
    try:
        _, cold, _ = _spans(run(cfg), [], sync)
        _reset_counts()
        (post, obs), wall, spent = _spans(run(cfg), split, sync)
        counts = _counts()
        check((_enkf_only(p["nobs"], "B2", block=p["block"]) if cuda
               else _only())(counts), f"phase 18: the EnKF launched {counts}")
        cfg_d = FilterConfig(localization="GC", block_size=p["block"])
        run(cfg_d)()
        _reset_counts()
        (post_d, obs_d), wall_d, spent_d = _spans(run(cfg_d), split, sync)
        counts_d = _counts()
        check((_enkf_only(p["nobs"], "B4", block=p["block"]) if cuda
               else _only())(counts_d), f"phase 18 default: launches "
              f"{counts_d}")
    finally:
        tenkf.enkf_kernel_update = real
    inn = _innovations("phase 18", batch, obs, var_shrinks=False)
    inn_d = _innovations("phase 18 default", batch, obs_d, var_shrinks=False)
    syncs = []
    if cuda:
        a, k = seen["B2"]
        syncs = _sync_free(lambda: real("B2", *a, **k))[1]
        check(not syncs, f"phase 18: the kernel update waited on the card: "
              f"{syncs}")
    # The plain route (the per-ob tail, the plain body): the reference.
    route = tenkf.enkf_route
    tenkf.enkf_route = lambda *a: "plain"
    try:
        (post_p, _), wall_p, _ = _spans(run(cfg), [], sync)
        (post_pd, _), wall_pd, _ = _spans(run(cfg_d), [], sync)
    finally:
        tenkf.enkf_route = route
    gap_p = _posterior_gap("phase 18 kernel route vs plain", post, post_p,
                           state)
    gap_pd = _posterior_gap("phase 18 default: kernel route vs plain",
                            post_d, post_pd, state)
    (post_s, _), wall_s, _ = _spans(
        run(dataclasses.replace(cfg, method="serial")), [], sync)
    gap_s = _posterior_gap("phase 18 blocked vs serial", post, post_s, state)
    # The float64 update (of the prior held in float64) draws the float32
    # table, upcast: the same eps.
    draw = tenkf.draw_ob_perturbations
    tenkf.draw_ob_perturbations = (
        lambda seed, errors, nmems, scale=True:
        draw(seed, errors.float(), nmems, scale).to(errors.dtype))
    try:
        (post64, _), wall64, _ = _spans(
            lambda: EnKF(_as_float64(state), batch, verbose=False,
                         seed=p["seed"],
                         config=dataclasses.replace(cfg, dtype="float64"))
            .update(), [], sync)
    finally:
        tenkf.draw_ob_perturbations = draw
    gap64 = _posterior_gap("phase 18 float32 vs float64", post, post64, state)
    kernels = _enkf_holds(seen) if cuda else {}
    out = dict(
        ngrid=p["ny"] * p["nx"], nmems=p["nmems"], nobs=p["nobs"],
        cold_s=cold, warm_s=wall, tail_s=spent["tail"], body_s=spent["body"],
        plain_s=wall_p, serial_s=wall_s, float64_s=wall64, default_s=wall_d,
        default_tail_s=spent_d["tail"], default_body_s=spent_d["body"],
        default_plain_s=wall_pd, b_launches=counts,
        default_launches=counts_d, syncs_in_update=len(syncs),
        mean_abs_innov=inn, default_mean_abs_innov=inn_d,
        kernel_vs_plain=gap_p, default_kernel_vs_plain=gap_pd,
        blocked_vs_serial=gap_s, f32_vs_f64=gap64, gate=SOLVER_GATE,
        obs_points_per_sec=p["nobs"] * p["ny"] * p["nx"] / wall,
        kernels=kernels)
    log("phase 18: EnKF config 11 " + json.dumps(out))
    return out


def _enkf_holds(seen):
    """B2e and B4e against their plain versions on the operands of phase
    18's updates (``seen``: each route's ``enkf_kernel_update`` arguments):
    B2e over the whole body, B4e over its first block; kernel and plain
    ms, the bound.  Returns ``{"B2e": ..., "B4e": ...}``."""
    import torch

    from efa_xray_tpu_torch.assimilation import ensrf_core as core
    from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid

    out = {}
    a, k = seen["B2"]
    bm, bp, tm, tp, lat, lon, obs, eps = a
    tkw = lambda k: {n: k[n] for n in ("localize", "unbiased",
                                       "fast_geometry", "vertical",
                                       "panel")}
    tail = core.tail_scan_blocked(tm, tp, obs, kernels=True, eps=eps,
                                  **tkw(k))
    ops = ensrf_fused.prepare(bp, lat, lon, tail, obs,
                              block_size=k["block_size"], cull=k["cull"],
                              apply_rows=tail.apply_rows)
    args = (bm, bp, ops["geom"], ops["y_b"], ops["ggt_b"], ops["tab_b"],
            ops["bits"], ops["tile"], True, False, ops["series"])
    got = ensrf_fused.fused_apply(*args, z_b=ops["z_b"])
    want, p_ms = cuda_timed(lambda: ensrf_fused.fused_apply_plain(
        *args, z_b=ops["z_b"]))
    torch.cuda.synchronize()
    err = max(compare("B2e config 11 mean", got[0], want[0]),
              compare("B2e config 11 perts", got[1], want[1]))
    out["B2e"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: ensrf_fused.fused_apply(*args, z_b=ops["z_b"]),
                   5),
        plain_ms=p_ms,
        **bound(b2_flop(ops, bp.shape[0], bp.shape[1], True, False),
                nbytes(*args[:7], ops["z_b"]) + nbytes(*got)))
    a, k = seen["B4"]
    bm, bp, tm, tp, lat, lon, obs, eps = a
    tail = core.tail_scan_blocked(tm, tp, obs, kernels=True, eps=eps,
                                  **tkw(k))
    sl = slice(0, k["block_size"])
    z = tail.apply_rows[sl].contiguous()
    # The default config's body: a flat state, weights in the kernel.
    vt, w, table, ggt = ensrf_grid.block_operands(
        lat, lon, tail.ye[sl], tail.sqrt_coef[sl], obs.lats[sl],
        obs.lons[sl], obs.radii[sl], bp.shape[0], apply_rows=z,
        point_geo=ensrf_grid.points_for_kernel(
            lat[:len(bp)], lon[:len(bp)], bp.dtype, on_card=True,
            localize=True, fast_geometry=False, vertical=False, vt=1))
    coef = torch.stack([tail.gain_coef[sl], tail.sqrt_coef[sl]])
    ops = (w, table, tail.ye[sl].contiguous(), ggt.contiguous(), coef)
    got = ensrf_grid.block_apply(bm, bp, *ops, vt, z=z)
    want = ensrf_grid.grid_apply_plain(bm, bp, ensrf_grid.as_blocks(w), None,
                                       ops[2][None], ops[3][None], coef[None],
                                       vt, z_b=z[None])
    torch.cuda.synchronize()
    err = max(compare("B4e config 11 mean", got[0], want[0]),
              compare("B4e config 11 perts", got[1], want[1]))
    out["B4e"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: ensrf_grid.block_apply(bm, bp, *ops, vt, z=z), 5),
        plain_ms=cuda_ms(lambda: ensrf_grid.grid_apply_plain(
            bm, bp, ensrf_grid.as_blocks(w), None, ops[2][None], ops[3][None],
            coef[None], vt, z_b=z[None]), 1),
        **bound(body_flop(bp.shape[0], 1, k["block_size"], bp.shape[1]),
                nbytes(bm, bp, w, *ops[2:], z) + nbytes(*got)))
    log("phase 18: B2e (the body) and B4e (one block of the default "
        "config's body) match plain on config 11's operands: " + "; ".join(
            f"{n}: err {r['max_abs_err']:.3e} kernel {r['ms']:.3f} ms plain "
            f"{r['plain_ms']:.1f} ms bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})" for n, r in out.items()))
    return out


# The LETKF's parts, each closed by a synchronize when split.
def _letkf_split():
    from efa_xray_tpu_torch.assimilation import letkf_core as tl

    return [(tl, "_select_chunk", "select"),
            (tl, "select_local_obs", "select"),
            (tl._ChunkSolver, "__call__", "solve"),
            (tl, "_apply_chunk", "apply"),
            (tl, "host_select_candidates", "host_build")]


def _aten_ops(fn):
    """``fn()`` under a dispatch mode that counts the aten operations it
    issues (factories, views and copies included): ``(result, count)``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen[0] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, seen[0]


# Kernel names of NS and LG in a profiler trace.
KERNEL_NAMES = {"NS": r"(^|[^A-Za-z0-9])ns_[a-z_0-9]*kernel",
                "LG": r"(^|[^A-Za-z0-9])lg_[a-z_0-9]*kernel"}


def _device_events(fn, sync):
    """One run of ``fn`` under ``torch.profiler`` with CUDA activity (CPU
    and CUDA where that traces no device event): ``(the activities traced,
    [(card, start us, end us, name)] of every device event)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for acts in ([ProfilerActivity.CUDA],
                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        sync()
        with profile(activities=acts) as prof:
            fn()
            sync()
        events = [(e.device_index, e.time_range.start, e.time_range.end,
                   e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    check(bool(events), "no device time was traced")
    return [a.name for a in acts], events


def _device_busy(fn, sync) -> dict:
    """The device's busy seconds of one run of ``fn`` (the union of its
    kernel, copy and set intervals on every card), the device window, and
    the summed seconds of NS's and LG's kernels with their shares of the
    busy seconds."""
    import re

    _, events = _device_events(fn, sync)
    spans = [(b, e) for _, b, e, _ in events]
    by = {key: sum(e - b for _, b, e, name in events if re.search(pat, name))
          / 1e6 for key, pat in KERNEL_NAMES.items()}
    busy = _union_us(spans) / 1e6
    window = (max(e for _, e in spans) - min(b for b, _ in spans)) / 1e6
    return dict(busy_s=busy, window_s=window,
                **{f"{k}_s": v for k, v in by.items()},
                **{f"{k}_share": v / busy for k, v in by.items()})


def _chunk_numbers(run, sync, chunks: int, cuda: bool) -> dict:
    """Host and device numbers of a warm LETKF update ``run()`` of
    ``chunks`` chunks: the aten operations it issues per chunk, the host's
    seconds per chunk to issue it (until the call returns, nothing
    synchronized inside; the wall once the card is done beside it), and
    on the card the device's busy seconds under ``torch.profiler`` with
    NS's and LG's shares."""
    _, ops = _aten_ops(run)
    sync()
    t0 = time.perf_counter()
    run()
    issue = time.perf_counter() - t0
    sync()
    wall = time.perf_counter() - t0
    r = dict(chunks=chunks, aten_ops=ops, ops_per_chunk=ops / max(chunks, 1),
             issue_s=issue, issue_ms_per_chunk=1e3 * issue / max(chunks, 1),
             wall_s=wall)
    if cuda:
        r["profile"] = _device_busy(run, sync)
    return r


def _letkf_runs(label, state, batch, cfg, sync, prior_var_check=True):
    """``LETKF(state, batch, config=cfg).update()`` cold, warm (wall, peak
    memory, Newton-Schulz iterations per chunk, host syncs: none where the
    kernel NS runs, float32 Newton-Schulz on the card), and warm again
    split into select / solve / apply, its launches checked: LG once a
    chunk in float32 on the card, and NS once a chunk where it runs.
    Returns ``(post, numbers)``."""
    import torch

    from efa_xray_tpu_torch import LETKF
    from efa_xray_tpu_torch.assimilation import letkf_core as tl

    lg_kernel = state.device.type == "cuda" and cfg.dtype == "float32"
    kernel = lg_kernel and cfg.letkf_sqrt == "newton_schulz"
    run = lambda: LETKF(state, batch, config=cfg).update()
    _reset_counts()
    _, cold, cold_spent = _spans(run, [(tl, "host_select_candidates",
                                        "host_build")], sync)
    tl.reset_counts()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    (post, obs), wall, _ = _spans(run, [], sync)
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if torch.cuda.is_available() else None)
    n = tl.ns_counts()
    ns = dict(calls=n["calls"], iterations=n["iterations"],
              per_chunk=n["iterations"] / max(n["calls"], 1),
              max=n["max_iterations"], host_syncs=n["host_syncs"])
    check(not kernel or n["host_syncs"] == 0,
          f"{label}: {n['host_syncs']} host reads inside a warm update")
    _reset_counts()
    _, wall_split, spent = _spans(run, _letkf_split(), sync)
    counts = _counts()
    chunks = n["calls"]
    check((_only(NS=chunks, LG=chunks) if kernel
           else _only(LG=None) if lg_kernel else _only())(counts),
          f"{label}: launches {counts} ({chunks} Newton-Schulz solves)")
    inn = _innovations(label, batch, obs, var_shrinks=prior_var_check)
    # Operations and busy seconds per chunk where NS runs (on the CPU the
    # plain loop).
    chunks = (_chunk_numbers(run, sync, n["calls"],
                             state.device.type == "cuda")
              if cfg.letkf_sqrt == "newton_schulz" and cfg.localize
              else None)
    return post, dict(cold_s=cold, host_build_s=cold_spent["host_build"],
                      warm_s=wall, peak_gb=peak, newton_schulz=ns,
                      launches=counts, chunks=chunks,
                      split_wall_s=wall_split,
                      **{f"{k}_s": v for k, v in spent.items()
                         if k != "host_build"},
                      mean_abs_innov=inn)


def _letkf_once(label, state, batch, cfg, sync, prior_var_check=True):
    """``LETKF(state, batch, config=cfg).update()`` once (an eigh update,
    for the comparison that needs it): its posterior, and its wall, its
    launches (LG once a chunk in float32 on the card, no NS) and its
    innovations."""
    from efa_xray_tpu_torch import LETKF

    lg_kernel = state.device.type == "cuda" and cfg.dtype == "float32"
    _reset_counts()
    (post, obs), wall, _ = _spans(
        lambda: LETKF(state, batch, config=cfg).update(), [], sync)
    counts = _counts()
    check((_only(LG=None) if lg_kernel else _only())(counts),
          f"{label}: launches {counts}")
    return post, dict(wall_s=wall, launches=counts,
                      mean_abs_innov=_innovations(
                          label, batch, obs, var_shrinks=prior_var_check))


def _first_ns_input(run, got=None):
    """``run()`` with a spy on ``letkf_core._newton_schulz_weights``: the
    first chunk's ``A [C, M, M]``, the cap it was given and its ``b [C,
    M]`` (copies), which are also appended to the list ``got``; ``run``'s
    result is that list's first entry then."""
    from efa_xray_tpu_torch.assimilation import letkf_core as tl

    real, seen = tl._newton_schulz_weights, []

    def spy(a, b, iters, **kw):
        if not seen:
            seen.append((a.clone(), iters, b.clone()))
        return real(a, b, iters, **kw)

    tl._newton_schulz_weights = spy
    try:
        out = run()
    finally:
        tl._newton_schulz_weights = real
    if got is not None:
        got[:] = [out, seen[0]]
    return seen[0]


def _lg_calls(run, keep=lambda i, args: True):
    """``run()`` with a spy on ``letkf_gram.local_gram``: ``(result,
    [(args, kwargs) of each chunk's call that ``keep(i, args)`` takes])``
    (the tensors as given: the chunk's indices are its own, the rest views
    of the update's inputs)."""
    from efa_xray_tpu_torch.ops import letkf_gram

    real, seen, n = letkf_gram.local_gram, [], [0]

    def spy(*a, **kw):
        if keep(n[0], a):
            seen.append((a, {k: v for k, v in kw.items()
                             if k not in ("amat", "b")}))
        n[0] += 1
        return real(*a, **kw)

    letkf_gram.local_gram = spy
    try:
        out = run()
    finally:
        letkf_gram.local_gram = real
    return out, seen


def _lg_hold(label, args, kw):
    """LG against its plain version on one chunk's inputs (a call that
    :func:`_lg_calls` saw): ``A`` and ``b`` at the f32 gate; kernel and
    plain ms, the bound (per (unit, ob) the symmetric Gram's M (M + 1)
    operations, one triangle of ``A``, the right-hand side's 2 M and ~60
    for the weights; the rows of ye the chunk selects, the indices, the
    centroids and the outputs once).  Returns the kernels-line numbers."""
    import torch

    from efa_xray_tpu_torch.ops import letkf_gram

    ye, innov, rinv, oxyz, orad, px, ii = args
    opts = dict(localize=kw["localize"], pv=kw["pv"], vlm_t=kw["vlm_t"],
                uv=kw["uv"], obs_var=kw["obs_var"])
    launch = lambda: letkf_gram.local_gram_cuda(ye, kw["table"], px, ii,
                                                **opts)
    plain = lambda: letkf_gram.local_gram_plain(
        ye, innov, rinv, oxyz, orad, px, ii, obs_verts=kw["obs_verts"],
        obs_vert_radii=kw["obs_vert_radii"], **opts)
    got = launch()
    want, plain_ms = cuda_timed(plain)
    # Each entry of A and b sums K terms a_k y_km y_kn (a_k y_km d_k) that
    # cancel: the kernel's and cuBLAS's float32 sums differ by a share of
    # the terms' magnitude, not of the sum's, so the f32 gate's relative
    # part is taken on that magnitude (float64: |a| |y|^T |y|, |a| |y|^T
    # |d|).
    a = letkf_gram.local_precision_plain(
        kw["table"][:, 4], oxyz, orad, px, ii, kw["localize"], pv=kw["pv"],
        obs_verts=kw["obs_verts"], obs_vert_radii=kw["obs_vert_radii"],
        vlm_t=kw["vlm_t"], uv=kw["uv"], obs_var=kw["obs_var"]).double()
    yl = ye[ii].double().abs()
    ya = yl * a.abs()[..., None]
    scale = (ya.transpose(1, 2) @ yl,
             (ya.transpose(1, 2) @ innov[ii].double().abs()[..., None])[
                 ..., 0])
    torch.cuda.synchronize()
    err = max(compare_sum(f"LG {label} A", got[0], want[0], scale[0]),
              compare_sum(f"LG {label} b", got[1], want[1], scale[1]))
    c, k = ii.shape
    m = ye.shape[1]
    rows = int(torch.unique(ii).numel())
    r = dict(units=c, k=k, nmems=m, max_abs_err=err,
             ms=device_ms(launch, 5, 20), plain_ms=plain_ms,
             **bound(float(c) * k * (m * (m + 1) + 2 * m + 60),
                     rows * (m * 4 + 32) + nbytes(ii, px, kw["pv"],
                                                  kw["uv"], *got)))
    log(f"phase LG {label}: [{c} units x {k} obs x {m} members]: err "
        f"{err:.3e} kernel {r['ms']:.4f} ms plain {r['plain_ms']:.3f} ms "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return r


def _ns_launch(a, iters, b):
    """NS as the update issues it (``letkf_core._newton_schulz_weights``):
    one launch writing ``W = sqrt(M - 1) A^{-1/2}`` and ``wbar = A^{-1}
    b`` into given buffers, its work buffers kept.  Returns ``f() -> (W,
    wbar, iterations [1])``."""
    import torch

    from efa_xray_tpu_torch.ops import newton_schulz

    m = a.shape[-1]
    scale = float(np.sqrt(np.float32(m - 1)))
    w, wbar, ws = torch.empty_like(a), torch.empty_like(b), {}
    return lambda: newton_schulz.solve(a, iters, b=b, scale=scale, out=w,
                                       wbar_out=wbar, ws=ws)


def _ns_plain(a, iters, b):
    """NS's plain version on the card: the loop that reads each error back,
    then ``W = sqrt(M - 1) A^{-1/2}`` and ``wbar = A^{-1} b`` in the JAX
    package's order.  Returns ``(W, wbar, iterations)``."""
    from efa_xray_tpu_torch.assimilation import letkf_core as tl

    m = a.shape[-1]
    s, inv, n = tl._invsqrt_newton_schulz_plain(a, iters)
    return (float(np.sqrt(np.float32(m - 1))) * s,
            (inv @ b[..., None])[..., 0], n)


def _ns_hold(label, a, iters, b=None, inner: int = 10):
    """NS against its plain version on one chunk's ``A`` and ``b`` (random
    where not given), as the update launches it (:func:`_ns_launch`): the
    same iteration count, ``W`` and ``wbar`` at the f32 gate; kernel and
    plain ms, the bound (the iterations this batch runs: three products of
    2 M^3 each; the end's two products with a vector; A, b, W and wbar
    once; the kernel over 5 runs of ``inner`` launches).  Returns the
    kernels-line numbers."""
    import torch

    c, m = a.shape[0], a.shape[-1]
    if b is None:
        gen = torch.Generator(device=a.device).manual_seed(m)
        b = torch.randn((c, m), generator=gen, device=a.device)
    launch = _ns_launch(a, iters, b)
    got = launch()
    want = _ns_plain(a, iters, b)
    torch.cuda.synchronize()
    n = int(got[2][0])
    check(n == want[2], f"NS {label}: {n} iterations, the plain loop "
          f"{want[2]}")
    check(all(bool(torch.isfinite(x).all()) for x in got[:2] + want[:2]),
          f"NS {label}: not finite")
    err = max(compare(f"NS {label} W", got[0], want[0]),
              compare(f"NS {label} wbar", got[1], want[1]))
    r = dict(
        iterations=n, max_abs_err=err, ms=device_ms(launch, 5, inner),
        plain_ms=cuda_ms(lambda: _ns_plain(a, iters, b), 3),
        **bound(float(c) * (6 * n * m ** 3 + 4 * m * m),
                nbytes(a, b, *got[:2])))
    log(f"phase NS {label}: [{c}, {m}, {m}] x {n} iterations: err "
        f"{err:.3e} kernel {r['ms']:.3f} ms plain (host reads) "
        f"{r['plain_ms']:.3f} ms bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})")
    return r


# NS's device-memory variant: a chunk of 64 systems of 200 members, each
# the LETKF's precision (M - 1) I + G^T G of 64 local obs, at the default
# cap of 30 iterations.
NS_WIDE = dict(nmems=200, chunk=64, k=64, seed=19, iters=30)


def _letkf_like_spd(m: int, c: int, k: int, seed: int):
    """``[c, m, m]`` float32 on the card: ``(m - 1) I + G^T G``, ``G``
    ``[k, m]`` standard normal, the form of the LETKF's precision."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn((c, k, m), generator=gen, device="cuda")
    eye = torch.eye(m, device="cuda")
    return (m - 1) * eye + g.transpose(1, 2) @ g


def _selection_flips(state, batch, patch: int, k: int):
    """The patches (bool ``[P]``) whose k nearest obs differ as sets when
    the centroids and obs are taken in float32 rather than float64, by
    ``letkf_core``'s own selection (one group, ``ngrid`` a multiple of
    ``patch``)."""
    import torch

    from efa_xray_tpu_torch import LETKF, FilterConfig
    from efa_xray_tpu_torch.assimilation import letkf_core as tl
    from efa_xray_tpu_torch.observation.localization import latlon_to_unit

    st = state.structure
    check(st.ngrid % patch == 0 and st.nvars * st.ntimes == 1,
          "_selection_flips: one group, whole patches only")
    oa = LETKF(state, batch, config=FilterConfig()).obs_arrays()
    sets = []
    for dt in (torch.float32, torch.float64):
        glat, glon = st.grid_latlon_device(dt, state.device)
        px = latlon_to_unit(glat, glon).reshape(-1, patch, 3).mean(dim=1)
        px = px / torch.clamp(torch.linalg.norm(px, dim=-1, keepdim=True),
                              min=1e-12)
        ox = latlon_to_unit(oa.lats.to(dt), oa.lons.to(dt))
        sets.append(tl.select_local_obs(px, ox, k).sort(dim=1).values)
    return (sets[0] != sets[1]).any(dim=1)


def phase19(dev="cuda", c6=None, c9=None):
    """The LETKF through ``LETKF(...).update()`` at BASELINE config 6 (the
    0.5-degree grid, 40 members, 2,000 obs, patches of 8, k 64, chunks of
    512): top-k exact and host (same analysis), Newton-Schulz and eigh,
    float32 and float64 on the device, and the unlocalized LETKF against
    the unlocalized EnSRF; then config 9 (config 3's 80 level variables,
    30 members, 5,000 obs, 300 hPa vertical).  Each float32
    Newton-Schulz update on the card runs NS and reads nothing back; NS
    is held against its plain version on config 6's first chunk, and its
    device-memory variant on a chunk of 200 members (:data:`NS_WIDE`)."""
    import dataclasses

    import torch

    from efa_xray_tpu_torch import EnSRF, FilterConfig, LETKF

    p = dict(CONFIG6, **(c6 or {}))
    sync = _syncer(dev)
    state, batch = _half_degree_workload(dev, **p)
    cfg = FilterConfig(localization="GC", letkf_patch_size=p["patch"],
                       letkf_k_obs=p["k"], letkf_chunk=p["chunk"])
    out = {}
    post, out["exact"] = _letkf_runs("phase 19 config 6 exact", state, batch,
                                     cfg, sync)
    host = dataclasses.replace(cfg, letkf_topk="host")
    post_h, out["host"] = _letkf_runs("phase 19 config 6 host", state, batch,
                                      host, sync)
    out["host"]["gap_vs_exact"] = _posterior_gap(
        "phase 19 host vs exact", post_h, post, state)
    out["host"]["bitwise_equal_to_exact"] = bool(
        (post_h.data == post.data).all())
    post_e, out["eigh"] = _letkf_once(
        "phase 19 config 6 eigh", state, batch,
        dataclasses.replace(cfg, letkf_sqrt="eigh"), sync)
    out["eigh"]["gap_vs_newton_schulz"] = _posterior_gap(
        "phase 19 Newton-Schulz vs eigh", post, post_e, state)
    post64, out["float64"] = _letkf_runs(
        "phase 19 config 6 float64", _as_float64(state), batch,
        dataclasses.replace(cfg, dtype="float64"), sync)
    # Chord dots from float64 and from float32 coordinates break near-ties
    # at rank k differently: a few patches take another k-th ob, and their
    # posterior moves by that ob's share.  The RMS gate is wider; outside
    # those patches the max gap is gated.
    out["float64"]["gap_vs_float32"] = _posterior_gap(
        "phase 19 float32 vs float64", post, post64, state, gate=1e-2)
    flips = _selection_flips(state, batch, p["patch"], p["k"])
    gap = (post.to_vect().double().mean(dim=1)
           - post64.to_vect().double().mean(dim=1)).abs()
    keep = ~flips.repeat_interleave(p["patch"])
    out["float64"]["patches_selecting_otherwise"] = int(flips.sum())
    out["float64"]["mean_max_gap_elsewhere"] = float(gap[keep].max())
    check(out["float64"]["mean_max_gap_elsewhere"]
          <= SOLVER_GATE * out["float64"]["gap_vs_float32"]["mean_incr_rms"],
          "phase 19: float32 vs float64 outside the patches that select "
          f"otherwise: {out['float64']}")
    # Unlocalized: the global ETKF is the serial EnSRF's analysis (mean
    # and covariance), here with unbiased variances, through eigh: the
    # Newton-Schulz exit rule (the JAX package's) stops early on this
    # ill-conditioned system, at ~1e-4 of the increment even in float64.
    for dtype, gate in (("float32", 1e-2), ("float64", 1e-6)):
        cu = FilterConfig(localization=None, unbiased_variance=True,
                          letkf_k_obs=p["nobs"], letkf_sqrt="eigh",
                          dtype=dtype)
        st = state if dtype == "float32" else _as_float64(state)
        pl, nl = _letkf_once(f"phase 19 unlocalized LETKF {dtype}", st,
                             batch, cu, sync)
        (pe, _), we, _ = _spans(lambda: EnSRF(st, batch, config=cu,
                                              verbose=False).update(),
                                [], sync)
        # The perturbations differ by a rotation: compare the mean and
        # the per-row variance.
        vl, ve, v0 = (x.to_vect().double() for x in (pl, pe, state))
        mgap = float((vl.mean(dim=1) - ve.mean(dim=1)).abs().max())
        incr = float(torch.sqrt(torch.mean(
            (ve.mean(dim=1) - v0.mean(dim=1)) ** 2)))
        var_e = ve.var(dim=1, correction=1)
        vgap = float((vl.var(dim=1, correction=1) - var_e).abs().max())
        vscale = float(var_e.mean())
        check(bool(torch.isfinite(vl).all()) and mgap <= gate * incr
              and vgap <= gate * vscale,
              f"phase 19 unlocalized LETKF vs EnSRF {dtype}: mean gap "
              f"{mgap:.3e} (increment RMS {incr:.3e}), per-row variance "
              f"gap {vgap:.3e} (posterior variance {vscale:.3e}), gate "
              f"{gate}")
        out[f"unlocalized_{dtype}"] = dict(
            letkf_s=nl["wall_s"], ensrf_s=we, gate=gate, mean_gap=mgap,
            mean_incr_rms=incr, var_gap=vgap, post_var_mean=vscale)
    out["gate"] = SOLVER_GATE
    if torch.device(dev).type == "cuda":
        out["ns"] = _ns_hold("config 6 chunk", *_first_ns_input(
            lambda: LETKF(state, batch, config=cfg).update()))
        # LG on config 6's first chunk and on its padded last one.
        padded = lambda i, a: bool((a[5] == 0).all(dim=1).any())
        _, calls = _lg_calls(lambda: LETKF(state, batch, config=cfg)
                             .update(), lambda i, a: i == 0 or padded(i, a))
        out["lg"] = _lg_hold("config 6 first chunk", *calls[0])
        out["lg_padded"] = _lg_hold("config 6 padded last chunk", *next(
            c for c in calls if padded(0, c[0])))
        # Past 136 members NS keeps Y, Z and T in device memory (every
        # system's 64 x 64 tiles dealt over the grid).
        out["ns_wide"] = _ns_hold("200 members", _letkf_like_spd(
            NS_WIDE["nmems"], NS_WIDE["chunk"], NS_WIDE["k"],
            NS_WIDE["seed"]), NS_WIDE["iters"])
    log("phase 19: LETKF config 6 " + json.dumps(out))

    q = dict(nmems=30, nobs=5000, seed=3, patch=8, k=64, chunk=512)
    q.update(c9 or {})
    state9, batch9, _ = _config3_workload(
        nmems=q["nmems"], nobs=q["nobs"], seed=q["seed"], dev=dev,
        ny=q.get("ny", 90), nx=q.get("nx", 180))
    cfg9 = FilterConfig(localization="GC", letkf_patch_size=q["patch"],
                        letkf_k_obs=q["k"], letkf_chunk=q["chunk"])
    _, c9r = _letkf_runs("phase 19 config 9", state9, batch9, cfg9, sync)
    c9r.update(nstate=state9.structure.nstate, nobs=batch9.nobs,
               obs_points_per_sec=batch9.nobs * state9.structure.nstate
               / c9r["warm_s"])
    if torch.device(dev).type == "cuda":
        # LG on config 9's first chunk (vertical), and on it with a
        # cross-variable table (3 observed variables against the units'
        # 80).
        _, calls = _lg_calls(lambda: LETKF(state9, batch9, config=cfg9)
                             .update(), lambda i, a: i == 0)
        args, kw = calls[0]
        c9r["lg"] = _lg_hold("config 9 first chunk (vertical)", args, kw)
        gen = torch.Generator(device=dev).manual_seed(9)
        nvars = state9.structure.nvars * state9.structure.ntimes
        vkw = dict(kw, vlm_t=torch.rand((nvars, 3), generator=gen,
                                        device=dev),
                   uv=torch.randint(0, nvars, (args[6].shape[0],),
                                    generator=gen, device=dev),
                   obs_var=torch.randint(0, 3, (args[0].shape[0],),
                                         generator=gen, device=dev))
        c9r["lg_varloc"] = _lg_hold("config 9 first chunk with varloc",
                                    args, vkw)
    log("phase 19: LETKF config 9 " + json.dumps(c9r))
    return dict(config6=out, config9=c9r)


def _config7(dev, p):
    """Config 7's inputs (``p`` as :data:`CONFIG7`) drawn on ``dev``:
    ``(bm, bp, tm, tp, lat, lon, obs)``, the points and the obs in the
    port's Hilbert order."""
    import torch

    from efa_xray_tpu_torch.assimilation.ensrf_core import ObsArrays
    from efa_xray_tpu_torch.observation.localization import (
        spatial_sort_order,
    )

    n, m, nobs = p["npts"], p["nmems"], p["nobs"]
    gen = torch.Generator(device=dev).manual_seed(p["seed"])
    lat = -88.0 + 176.0 * torch.rand(n, generator=gen, device=dev)
    lon = 360.0 * torch.rand(n, generator=gen, device=dev)
    order = spatial_sort_order(lat, lon)
    lat, lon = lat[order], lon[order]
    prior = 280.0 + 5.0 * torch.randn((n, m), generator=gen, device=dev)
    rows = torch.randint(0, n, (nobs,), generator=gen, device=dev)
    rows = rows[spatial_sort_order(lat[rows], lon[rows])]
    ye = prior[rows]
    tm = ye.mean(dim=1)
    tp = ye - tm[:, None]
    bm = prior.mean(dim=1)
    bp = prior - bm[:, None]
    del prior
    obs = ObsArrays(
        values=tm + torch.randn(nobs, generator=gen, device=dev),
        errors=torch.ones(nobs, device=dev), lats=lat[rows], lons=lon[rows],
        radii=torch.full((nobs,), p["radius"], device=dev),
        assim=torch.ones(nobs, dtype=torch.bool, device=dev))
    return bm, bp, tm, tp, lat, lon, obs


def phase20(dev="cuda", **cut):
    """The LETKF at BASELINE config 7's full size through
    ``letkf_core.letkf_update``, as ``bench_config7`` drives it: 4,194,304
    scattered points x 80 members x 10,000 obs at 2000 km, points and obs
    in the port's Hilbert order (``localization.spatial_sort_order``);
    top-k exact, then host (its build timed apart), the same analysis;
    each launches NS and makes no synchronizing call inside the update
    (``set_sync_debug_mode``), and NS is held against its plain version
    on the first chunk."""
    import torch

    from efa_xray_tpu_torch.assimilation import letkf_core as tl

    p = dict(CONFIG7, **cut)
    sync = _syncer(dev)
    bm, bp, tm, tp, lat, lon, obs = _config7(dev, p)
    n, m, nobs = p["npts"], p["nmems"], p["nobs"]
    kw = dict(ngrid=n, patch_size=p["patch"], k_obs=p["k"],
              chunk=p["chunk"])
    out = dict(npts=n, nmems=m, nobs=nobs, state_gb=bp.numel() * 4 / 1e9)
    t0 = time.perf_counter()
    cand, mask, geff = tl.host_select_candidates(
        lat.double().cpu().numpy(), lon.double().cpu().numpy(), n,
        p["patch"], obs.lats.double().cpu().numpy(),
        obs.lons.double().cpu().numpy(), p["k"], chunk=p["chunk"])
    out["host_build_s"] = time.perf_counter() - t0
    out["host_candidate_width"] = int(cand.shape[1])
    out["host_group"] = int(geff)
    sel = dict(sel_cand=torch.from_numpy(cand).to(dev),
               sel_mask=torch.from_numpy(mask).to(dev), sel_group=geff)
    res, first, lg_first = {}, [], []
    cuda = torch.device(dev).type == "cuda"
    for topk, extra in (("exact", {}), ("host", sel)):
        def update(topk=topk, extra=extra):
            run = lambda: tl.letkf_update(bm, bp, tm, tp, lat, lon, obs,
                                          topk_method=topk, **kw, **extra)
            if topk != "exact":
                return run()
            # The exact run also hands NS's and LG's first chunk to the
            # holds below.

            def run_lg():
                out, calls = _lg_calls(run, lambda i, a: i == 0)
                lg_first[:] = calls
                return out

            _first_ns_input(run_lg, first)
            return first[0]

        tl.reset_counts()
        _reset_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        # Timed, and watched for synchronizing calls (none allowed).
        (res[topk], syncs), wall, _ = _spans(
            lambda: _sync_free(update) if cuda else (update(), []), [],
            sync)
        check(bool(torch.isfinite(res[topk][1]).all()),
              f"phase 20 {topk}: posterior not finite")
        counts, ns = _counts(), tl.ns_counts()
        check((_only(NS=ns["calls"], LG=ns["calls"]) if cuda
               else _only())(counts),
              f"phase 20 {topk}: launches {counts} ({ns['calls']} chunks)")
        check(not cuda or ns["host_syncs"] == 0,
              f"phase 20 {topk}: {ns['host_syncs']} host reads")
        check(not syncs, f"phase 20 {topk}: the update waited on the card: "
              f"{syncs}")
        out[topk] = dict(
            seconds=wall, obs_points_per_sec=nobs * n / wall,
            peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                     if cuda else None),
            ns_per_chunk=ns["iterations"] / max(ns["calls"], 1),
            ns_max=ns["max_iterations"], host_syncs=ns["host_syncs"],
            ns_launches=counts["NS"], lg_launches=counts["LG"],
            syncs_in_update=len(syncs))
        if topk == "exact":
            # Torch operations, host seconds per chunk and the device's
            # busy seconds of one warm update.
            out[topk]["chunks"] = _chunk_numbers(
                lambda: tl.letkf_update(bm, bp, tm, tp, lat, lon, obs,
                                        topk_method="exact", **kw),
                sync, ns["calls"], cuda)
    if cuda:
        out["ns"] = _ns_hold("config 7 chunk", *first[1])
        out["lg"] = _lg_hold("config 7 first chunk", *lg_first[0])
    incr = float(torch.sqrt(torch.mean((res["exact"][0] - bm) ** 2)))
    gap = float((res["host"][0] - res["exact"][0]).abs().max())
    pgap = float((res["host"][1] - res["exact"][1]).abs().max())
    check(gap <= SOLVER_GATE * incr,
          f"phase 20: host vs exact mean gap {gap:.3e} > {SOLVER_GATE} x "
          f"the increment RMS {incr:.3e}")
    out.update(mean_incr_rms=incr, host_vs_exact_mean=gap,
               host_vs_exact_perts=pgap,
               bitwise_equal=bool(torch.equal(res["host"][1],
                                              res["exact"][1])))
    log("phase 20: LETKF config 7 " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# The cycling OSSE and the observation pipeline (ROADMAP A5, A8)
# ---------------------------------------------------------------------------


class _FirstCall:
    """While open, a spy on ``cls.name`` (``FlatRoute.solve``, the
    harness's EnSRF analysis, by default): its first call's positional
    arguments (tensors cloned: the body kernels update them in place),
    its route's config, and its outputs (tensors cloned)."""

    def __init__(self, cls=None, name: str = "solve"):
        if cls is None:
            from efa_xray_tpu_torch.assimilation.ensrf import FlatRoute

            cls = FlatRoute
        self.cls, self.name = cls, name

    def __enter__(self):
        import torch

        copy = lambda x: x.clone() if isinstance(x, torch.Tensor) else x
        self.own = self.name in self.cls.__dict__
        self.real, self.got = getattr(self.cls, self.name), None
        spy = self

        def call(route, *args, **kw):
            first = spy.got is None
            if first:
                spy.got = dict(args=[copy(x) for x in args],
                               cfg=route.config)
            out = spy.real(route, *args, **kw)
            if first:
                spy.got["out"] = ([copy(x) for x in out]
                                  if type(out) is tuple else out)
            return out

        setattr(self.cls, self.name, call)
        return self

    def __exit__(self, *exc):
        if self.own:
            setattr(self.cls, self.name, self.real)
        else:
            delattr(self.cls, self.name)


def _against_plain(label, got):
    """A captured analysis (:class:`_FirstCall` on ``FlatRoute.solve``)
    against the plain ``ensrf_blocked`` on the same tensors (its tail the
    plain panel scan): max abs errors of the mean and the perturbations,
    at the kernel tolerances, and the plain update's seconds."""
    from efa_xray_tpu_torch.assimilation import ensrf_core as core

    cfg = got["cfg"]
    sync = _syncer(got["args"][0].device)
    sync()
    t0 = time.perf_counter()
    pbm, pbp, *_ = core.ensrf_blocked(
        *got["args"][:7], localize=cfg.localize,
        block_size=cfg.block_size, unbiased=cfg.unbiased_variance,
        fast_geometry=cfg.fast_geometry, tail_panel=cfg.tail_panel)
    sync()
    secs = time.perf_counter() - t0
    return (compare(f"{label} mean vs plain ensrf_blocked", got["out"][0],
                    pbm),
            compare(f"{label} perturbations vs plain ensrf_blocked",
                    got["out"][1], pbp), secs)


def _scratch_dir() -> str:
    """A git-ignored directory of the checkout for this run's files."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke")
    os.makedirs(d, exist_ok=True)
    return d


# BASELINE config 1 (benchmarks/run_benchmarks.py:195-253): Lorenz-96, 40
# variables, 20 members, 4 steps a cycle, obs at every 2nd variable (R 1),
# 8000 km, float32, blocks of 8, Anderson adaptive inflation (sd 0.6,
# evolved, sd_min 0.15), 20 warm-up cycles, then 60 with resume=True.
CONFIG1 = dict(nvars=40, nmems=20, steps=4, stride=2, radius=8000.0,
               block=8, sd=0.6, sd_min=0.15, warmup=20, cycles=60, seed=1,
               obs_seed=100, solver_cycles=5)


def _config1_harness(dev, p, **over):
    import torch

    from efa_xray_tpu_torch import FilterConfig
    from efa_xray_tpu_torch.models import lorenz96
    from efa_xray_tpu_torch.models.cycling import CyclingHarness

    lats, lons = lorenz96.fake_latlon(p["nvars"])
    kw = dict(
        forecast=lambda x: lorenz96.integrate(x, nsteps=p["steps"]),
        state_lats=lats, state_lons=lons, ob_error=1.0,
        localize_radius=p["radius"],
        config=FilterConfig(localization="GC", dtype="float32",
                            block_size=p["block"]),
        obs_operator_rows=np.arange(0, p["nvars"], p["stride"]),
        adaptive_inflation=True, adaptive_sd=p["sd"],
        adaptive_sd_evolve=True, adaptive_sd_min=p["sd_min"],
        device=torch.device(dev))
    kw.update(over)
    return CyclingHarness(**kw)


def phase21(dev="cuda", **cut):
    """BASELINE config 1 at its published settings through the port's
    ``CyclingHarness``: cycles per second, the analysis RMSE and spread,
    the B1/B4 launches a cycle; cycle 0 against the plain update, a
    checkpoint halfway reproducing the uninterrupted run bit for bit, 5
    cycles each of the LETKF and the EnKF against the free run, and the
    options the JAX harness ignores keeping B1 + B4 and the analysis."""
    import torch

    from efa_xray_tpu_torch.models import lorenz96

    p = dict(CONFIG1, **cut)
    sync = _syncer(dev)
    cuda = torch.device(dev).type == "cuda"
    truth, ens = lorenz96.spinup_ensemble(
        nvars=p["nvars"], nmems=p["nmems"], seed=p["seed"], device=dev,
        dtype=torch.float32)
    h = _config1_harness(dev, p)
    with _FirstCall() as spy:
        warm = h.run(ens.clone(), truth.clone(), p["warmup"],
                     seed=p["obs_seed"])
    mean_err, pert_err, _ = _against_plain("phase 21 cycle 0", spy.got)
    sync()
    _reset_counts()
    t0 = time.perf_counter()
    stats = h.run(None, None, p["cycles"], resume=True)
    sync()
    wall = time.perf_counter() - t0
    counts = _counts()
    nobs = len(range(0, p["nvars"], p["stride"]))
    per_cycle = dict(B1=1, B4=-(-nobs // p["block"]))
    if cuda:
        check(_only(**{k: v * p["cycles"] for k, v in per_cycle.items()})(
            counts), f"phase 21: launches {counts} in {p['cycles']} cycles")
    rmse = [s.analysis_rmse for s in stats]
    spread = [s.mean_spread for s in stats]
    check(all(np.isfinite([s.analysis_rmse, s.mean_spread,
                           s.background_rmse]).all() for s in warm + stats),
          "phase 21: a cycle is not finite")
    last30 = statistics.mean(rmse[-30:])
    check(last30 < 1.0, f"phase 21: last-30 mean analysis RMSE {last30:.4f} "
          "not below the obs error 1.0")

    # Save halfway, load into a fresh harness, finish: bit for bit.
    half = p["cycles"] // 2
    h2 = _config1_harness(dev, p)
    h2.run(ens.clone(), truth.clone(), p["warmup"], seed=p["obs_seed"])
    first = h2.run(None, None, half, resume=True)
    path = os.path.join(_scratch_dir(), "phase21.ckpt")
    h2.save_checkpoint(path)
    h3 = _config1_harness(dev, p)
    h3.load_checkpoint(path)
    second = h3.run(None, None, p["cycles"] - half, resume=True)
    os.remove(path)
    check(first + second == stats and bool(torch.equal(
        h3._final_ensemble, h._final_ensemble)),
          "phase 21: the resumed run differs from the uninterrupted one")

    # Where a cycle's time goes: 10 more cycles, each part closed by a
    # synchronize.
    from efa_xray_tpu_torch.assimilation import adaptive_inflation as ai
    from efa_xray_tpu_torch.assimilation.ensrf import FlatRoute
    from efa_xray_tpu_torch.models import cycling

    nsplit = 10
    _, split_wall, split = _spans(
        lambda: h.run(None, None, nsplit, resume=True),
        [(lorenz96, "integrate", "forecast"), (FlatRoute, "solve",
                                                "analysis"),
         (ai, "update_inflation_rows", "inflation_learning"),
         (cycling, "_crps_mean", "crps")], sync)
    split = {k: v / nsplit for k, v in split.items()}
    split["cycle"] = split_wall / nsplit

    # The other solvers, from the spun-up ensemble, against the free run.
    free, tr = ens.clone(), truth.clone()
    free_rmse = []
    for _ in range(p["solver_cycles"]):
        tr = lorenz96.integrate(tr, nsteps=p["steps"])
        free = lorenz96.integrate(free, nsteps=p["steps"])
        free_rmse.append(float(torch.sqrt(torch.mean(
            (free.mean(dim=0) - tr) ** 2))))
    solvers = {}
    for solver in ("letkf", "enkf"):
        _reset_counts()
        s = _config1_harness(dev, p, solver=solver).run(
            ens.clone(), truth.clone(), p["solver_cycles"],
            seed=p["obs_seed"])
        r = [x.analysis_rmse for x in s]
        check(bool(np.isfinite(r).all()), f"phase 21 {solver}: not finite")
        check(statistics.mean(r) < statistics.mean(free_rmse),
              f"phase 21 {solver}: mean analysis RMSE "
              f"{statistics.mean(r):.4f} not below the free run's "
              f"{statistics.mean(free_rmse):.4f}")
        # The harness's LETKF runs NS on the card; its EnKF is the serial
        # loop, as the JAX harness's.
        want = (_only(NS=None, LG=None) if (cuda and solver == "letkf")
                else _only())
        check(want(_counts()), f"phase 21 {solver}: launched {_counts()}")
        solvers[solver] = dict(rmse=r, mean_rmse=statistics.mean(r))

    # Options the JAX harness ignores (hybrid, variable_localization,
    # method) keep the harness on B1 + B4 and leave its analysis as it is.
    from efa_xray_tpu_torch import FilterConfig

    lats, lons = lorenz96.fake_latlon(p["nvars"])
    rows = np.arange(0, p["nvars"], p["stride"])
    y = truth[torch.as_tensor(rows, device=truth.device)].double().cpu()
    y = y.numpy() + 0.5

    def one_analysis(**cfg):
        hh = _config1_harness(dev, p, adaptive_inflation=False,
                              config=FilterConfig(
                                  localization="GC", dtype="float32",
                                  block_size=p["block"], **cfg))
        _reset_counts()
        a, _ = hh.analysis_step(ens.clone(), y, lats[rows], lons[rows])
        return a, _counts()

    base, _ = one_analysis()
    ignored = dict(
        hybrid=dict(hybrid_alpha=0.5, static_b_sigma=1.0,
                    static_b_length=500.0),
        variable_localization=dict(variable_localization={("X", "X"): 0.5}),
        serial=dict(method="serial"))
    for name, cfg in ignored.items():
        a, c = one_analysis(**cfg)
        if cuda:
            check(_only(**per_cycle)(c),
                  f"phase 21 {name} config: launches {c}")
        check(bool(torch.equal(a, base)),
              f"phase 21 {name} config: the analysis differs")
    out = dict(
        cycles=p["cycles"], warmup=p["warmup"], seconds=wall,
        cycles_per_sec=p["cycles"] / wall,
        mean_analysis_rmse_last30=last30,
        mean_analysis_rmse_last10=statistics.mean(rmse[-10:]),
        mean_spread_last30=statistics.mean(spread[-30:]),
        mean_spread_last10=statistics.mean(spread[-10:]),
        launches_per_cycle={k: v / p["cycles"] for k, v in counts.items()
                            if v},
        split_seconds_per_cycle=split,
        cycle0_vs_plain=dict(mean=mean_err, perts=pert_err),
        checkpoint_bit_exact=True,
        ignored_options_keep_route=sorted(ignored),
        free_run_mean_rmse=statistics.mean(free_rmse),
        **{f"{k}_{p['solver_cycles']}_cycles": v for k, v in solvers.items()})
    log("phase 21: BASELINE config 1 (L96 CyclingHarness) " + json.dumps(out))
    return out


# examples/multivariate_swe.py on a channel 8 times wider each way: 128 x
# 256 (98,304 rows of eta, u, v), 40 members, eta obs at every 2nd point
# (16,384 obs), R 1e-4, 500 km (the example's 4000 km at 32 columns, in
# grid units), RTPS 0.5, 10 model steps a cycle, 10 cycles, float32; the
# example's spin-up (2500 steps, members 400).
SWE22 = dict(ny=128, nx=256, nmems=40, stride=2, ob_error=1e-4,
             radius=500.0, rtps=0.5, steps=10, cycles=10, spinup=2500,
             member_steps=400, seed=0, obs_seed=3, check_steps=3,
             check_mems=4)


def _var_rmse(flat_ens, flat_truth, n):
    """Ensemble-mean RMSE of each of a flat SWE state's variables."""
    import torch

    from efa_xray_tpu_torch.models import swe

    err = (flat_ens.mean(dim=0) - flat_truth).double()
    return {v: float(torch.sqrt(torch.mean(err[i * n:(i + 1) * n] ** 2)))
            for i, v in enumerate(swe.VAR_ORDER)}


def phase22(dev="cuda", **cut):
    """The multivariate shallow-water OSSE at full width through the
    port's ``CyclingHarness``: spin-up, per-cycle forecast and analysis
    seconds, B1/B4 launches a cycle, background and analysis RMSE per
    variable; cycle 0 against the plain update, the never-observed winds
    corrected on cycle 0, the forecast against float64 on the CPU."""
    import torch

    from efa_xray_tpu_torch import FilterConfig
    from efa_xray_tpu_torch.models import swe
    from efa_xray_tpu_torch.models.cycling import CyclingHarness

    p = dict(SWE22, **cut)
    ny, nx, n = p["ny"], p["nx"], p["ny"] * p["nx"]
    sync = _syncer(dev)
    cuda = torch.device(dev).type == "cuda"
    sync()
    t0 = time.perf_counter()
    truth, ens = swe.spinup_ensemble(
        ny=ny, nx=nx, nmems=p["nmems"], seed=p["seed"],
        spinup_steps=p["spinup"], member_steps=p["member_steps"],
        device=dev, dtype=torch.float32)
    sync()
    spinup = time.perf_counter() - t0
    steps_total = p["spinup"] + p["member_steps"]
    start = {k: v[:p["check_mems"]] for k, v in ens.items()}
    got = swe.integrate(start, ny, nsteps=p["check_steps"])
    want = swe.integrate({k: v.double().cpu() for k, v in start.items()}, ny,
                         nsteps=p["check_steps"])
    ferr = max(compare(f"phase 22 SWE {k}, card vs float64 CPU", got[k],
                       want[k].to(got[k].device)) for k in swe.VAR_ORDER)

    lat, lon = swe.grid_latlon(ny, nx)
    rows = swe.var_rows("eta", ny, nx, stride=p["stride"])
    nobs = len(rows)
    fc = swe.make_flat_forecast(ny, nx, nsteps=p["steps"])
    rec, cur = [], {}

    def forecast(x):
        sync()
        t = time.perf_counter()
        out = fc(x)
        sync()
        cur["forecast"] = cur.get("forecast", 0.0) + time.perf_counter() - t
        if x.ndim == 1:
            cur["truth"] = out
        return out

    cfg = FilterConfig(rtps_alpha=p["rtps"], dtype="float32")
    h = CyclingHarness(forecast=forecast, state_lats=lat, state_lons=lon,
                       ob_error=p["ob_error"], localize_radius=p["radius"],
                       obs_operator_rows=rows, config=cfg,
                       device=torch.device(dev))
    step = h.analysis_step

    def timed_step(ensemble, values, la, lo):
        _reset_counts()
        sync()
        t = time.perf_counter()
        out, diags = step(ensemble, values, la, lo)
        sync()
        secs = time.perf_counter() - t
        counts = _counts()
        check(bool(torch.isfinite(out).all()),
              f"phase 22 cycle {len(rec)}: analysis not finite")
        rec.append(dict(cycle=len(rec), forecast_s=cur.pop("forecast"),
                        analysis_s=secs, B1=counts["B1"], B4=counts["B4"],
                        bg=_var_rmse(ensemble, cur["truth"], n),
                        an=_var_rmse(out, cur["truth"], n),
                        counts=counts))
        return out, diags

    h.analysis_step = timed_step
    with _FirstCall() as spy:
        stats = h.run(swe.pack(ens, ny, nx), swe.pack(truth, ny, nx),
                      p["cycles"], seed=p["obs_seed"])
    mean_err, pert_err, plain_s = _against_plain("phase 22 cycle 0",
                                                 spy.got)
    # Where an analysis's time goes: one more of the last ensemble, each
    # part closed by a synchronize (the operands of the tail's and the
    # body's B4 blocks together).
    from efa_xray_tpu_torch.assimilation import ensrf_core as core
    from efa_xray_tpu_torch.ops import ensrf_grid

    yobs = (cur["truth"][torch.as_tensor(rows, device=cur["truth"].device)]
            .double().cpu().numpy()
            + np.random.default_rng(p["obs_seed"] + 1).normal(
                0.0, np.sqrt(p["ob_error"]), nobs))
    _, split_wall, split = _spans(
        lambda: step(h._final_ensemble, yobs, lat[rows], lon[rows]),
        [(core, "tail_scan_blocked", "tail"),
         (ensrf_grid, "blocked_body", "body"),
         (ensrf_grid, "block_operands", "B4 operands"),
         (ensrf_grid, "block_apply", "B4 launches")], sync)
    split["analysis"] = split_wall
    tail = _tail_counts(nobs, cfg.tail_panel, b4=True)
    want = dict(B1=tail["panels"],
                B4=tail["b4"] + -(-nobs // min(cfg.block_size, nobs)))
    for r in rec:
        if cuda:
            check(_only(**want)(r.pop("counts")),
                  f"phase 22 cycle {r['cycle']}: launches {r}")
        else:
            r.pop("counts")
    c0 = rec[0]
    for v in ("u", "v"):
        check(c0["an"][v] < c0["bg"][v],
              f"phase 22 cycle 0: never-observed {v} analysis RMSE "
              f"{c0['an'][v]:.5f} not below its background's "
              f"{c0['bg'][v]:.5f}")
    for r in rec:
        log("phase 22 cycle " + json.dumps(r))
    late = rec[1:] or rec
    out = dict(
        ny=ny, nx=nx, nrows=3 * n, nmems=p["nmems"], nobs=nobs,
        spinup_s=spinup, spinup_steps=steps_total,
        spinup_ms_per_step=1e3 * spinup / steps_total,
        forecast_s_per_cycle=statistics.mean(r["forecast_s"] for r in late),
        analysis_s_per_cycle=statistics.mean(r["analysis_s"] for r in late),
        first_analysis_s=rec[0]["analysis_s"],
        analysis_split_s=split,
        launches_per_cycle=want if cuda else None,
        cycle0_vs_plain=dict(mean=mean_err, perts=pert_err,
                             plain_s=plain_s),
        forecast_vs_f64_cpu=ferr,
        cycle0_rmse=dict(background=c0["bg"], analysis=c0["an"]),
        final_rmse=dict(background=rec[-1]["bg"], analysis=rec[-1]["an"]),
        analysis_rmse=[s.analysis_rmse for s in stats])
    log("phase 22: multivariate SWE OSSE " + json.dumps(out))
    return out


# The observation pipeline (examples/obs_pipeline.py) on phase 4's grid:
# 100,000 raw obs of a smooth truth (R 1) at grid points, 20% exact
# duplicates of the ob before, superob at 0.25 deg, thinning at 25 km,
# Hilbert order, EnSRF with fast_geometry + spatial_sort at 500 km and
# inflation 1.05, one ob with a custom forward operator (the global mean).
PIPE23 = dict(ny=1024, nmems=80, nraw=100_000, dup=0.2, cell_deg=0.25,
              min_km=25.0, radius=500.0, r=1.0, inflation=1.05, seed=23,
              nmodes=8, tail_check_panels=8)


def _pipeline_against_plain(tail_got, body_got, npanels: int) -> dict:
    """The pipeline's update against the plain versions on the same
    tensors, at the kernel tolerances: the whole body (B2 over every row
    and ob) against the plain ``ensrf_blocked_body`` fed the same tail
    solution, and the tail (B1 with its out-of-panel B2 applies) against
    the plain panel scan over its first ``npanels`` panels, which depend
    on no later ob.  The plain scan of the whole tail (a per-ob loop,
    ~2.3 ms an ob) would take minutes at this batch.  Max abs errors and
    the plain seconds."""
    from efa_xray_tpu_torch.assimilation import ensrf_core as core

    cfg = body_got["cfg"]
    route, bm, bp, lat, lon, tail, obs, body_vert, vertical = \
        body_got["args"][:9]
    check(route == "B2", f"phase 23: the body took {route}, not B2")
    sync = _syncer(bm.device)
    sync()
    t0 = time.perf_counter()
    pbm, pbp = core.ensrf_blocked_body(
        bm, bp, lat, lon, tail, obs, localize=cfg.localize,
        block_size=cfg.block_size, fast_geometry=cfg.fast_geometry,
        body_vert=body_vert, vertical=vertical)
    sync()
    body_s = time.perf_counter() - t0
    errs = dict(
        body_mean=compare("phase 23 body mean vs plain", body_got["out"][0],
                          pbm),
        body_perts=compare("phase 23 body perturbations vs plain",
                           body_got["out"][1], pbp))
    tm, tp, tobs, tvert = tail_got["args"][:4]
    k = min(int(tobs.values.shape[0]), npanels * cfg.tail_panel)
    cut = type(tobs)(*(None if x is None else x[:k] for x in tobs))
    t0 = time.perf_counter()
    ptail = core.tail_scan_blocked(
        tm[:k], tp[:k], cut, localize=cfg.localize,
        unbiased=cfg.unbiased_variance, fast_geometry=cfg.fast_geometry,
        vertical=tvert, panel=cfg.tail_panel, kernels=False)
    sync()
    tail_s = time.perf_counter() - t0
    for name in ("ye", "gain_coef", "sqrt_coef"):
        errs[f"tail {name}"] = compare(
            f"phase 23 tail {name} vs plain (first {k} obs)",
            getattr(tail, name)[:k], getattr(ptail, name))
    for i, name in enumerate(("prior_mean", "prior_var", "post_mean",
                              "post_var")):
        errs[f"tail {name}"] = compare(
            f"phase 23 tail {name} vs plain (first {k} obs)",
            tail.diags[i][:k], ptail.diags[i])
    return dict(max_abs_err=errs, plain_body_s=body_s, plain_tail_s=tail_s,
                tail_obs_checked=k)


def _pipeline_state(dev, ny, nmems, nmodes, seed):
    """Phase 4's grid (``ny`` x ``ny``, lat +-88) with a smooth truth, a
    background off it by a smooth error, and members spread over the same
    smooth modes: ``(state, truth [ny, nx] float64 NumPy)``."""
    import torch

    from efa_xray_tpu_torch import EnsembleState

    nx = ny
    lon, lat = np.meshgrid(np.arange(0, 360, 360 / nx),
                           np.linspace(-88, 88, ny))
    rng = np.random.default_rng(seed)
    la, lo = np.radians(lat), np.radians(lon)
    k = rng.integers(1, 7, nmodes)
    l = rng.integers(1, 5, nmodes)
    ph = rng.uniform(0, 2 * np.pi, (2, nmodes))
    modes = torch.tensor(np.stack([
        np.cos(la) * np.cos(k[j] * lo + ph[0, j]) * np.cos(l[j] * la
                                                           + ph[1, j])
        for j in range(nmodes)]), dtype=torch.float32, device=dev)
    truth = 280.0 + 20.0 * np.cos(la) + 3.0 * np.einsum(
        "j,jyx->yx", rng.normal(size=nmodes), modes.double().cpu().numpy())
    err = rng.normal(size=nmodes)
    c = rng.normal(size=(nmems, nmodes))
    c = 2.0 * (err[None, :] + c - c.mean(axis=0, keepdims=True))
    members = torch.einsum("mj,jyx->yxm", torch.tensor(c, dtype=torch.float32,
                                                       device=dev), modes)
    members += torch.tensor(truth, dtype=torch.float32, device=dev)[..., None]
    times = np.datetime64("2026-08-01T00") + np.arange(1)
    state = EnsembleState.from_vardict(
        {"T2m": members[None]}, {"validtime": times, "lat": lat, "lon": lon},
        dtype="float32", device=dev)
    return state, truth


def _pipeline_dataframe(state, truth, p):
    """``examples/obs_pipeline.py``'s recipe: the truth at interior grid
    points plus N(0, R), every ob with probability ``dup`` a copy of the
    location of the ob before it."""
    import pandas as pd

    s = state.structure
    rng = np.random.default_rng(p["seed"] + 1)
    n = p["nraw"]
    iy = rng.integers(1, s.ny - 1, n)
    ix = rng.integers(1, s.nx - 1, n)
    dup = rng.random(n) < p["dup"]
    iy[dup] = iy[np.maximum(np.nonzero(dup)[0] - 1, 0)]
    ix[dup] = ix[np.maximum(np.nonzero(dup)[0] - 1, 0)]
    return pd.DataFrame({
        "value": truth[iy, ix] + rng.normal(0, np.sqrt(p["r"]), n),
        "error": p["r"], "lat": s.lat[iy, ix], "lon": s.lon[iy, ix],
        "time": np.repeat(s.times64()[0], n), "obtype": s.var_names[0],
        "localize_radius": p["radius"]})


def _haversine_np(lat1, lon1, lat2, lon2):
    p1, p2 = np.radians(lat1), np.radians(lat2)
    a = (np.sin((p2 - p1) / 2) ** 2 + np.cos(p1) * np.cos(p2)
         * np.sin(np.radians(lon2 - lon1) / 2) ** 2)
    return 2 * 6371.0 * np.arctan2(np.sqrt(a), np.sqrt(1 - a))


def _pipeline_probes(post, host, t0):
    """``nearest_points`` / ``interpolate`` / ``isel`` / ``sel`` on the
    posterior against NumPy on its host copy ``host [ny, nx, nmems]``;
    returns the largest error."""
    import torch

    s = post.structure
    errs = []
    for plat, plon in ((12.34, 56.78), (-60.1, 300.2), (87.5, 359.9)):
        yy, xx = post.nearest_points(plat, plon, npt=4)
        d = _haversine_np(s.lat, s.lon, plat, plon).ravel()
        near = np.argsort(d, kind="stable")[:4]
        check(np.array_equal(np.ravel_multi_index((yy, xx), s.lat.shape),
                             near), f"phase 23: nearest_points at "
              f"({plat}, {plon})")
        w = 1.0 / d[near]
        w /= w.sum()
        want = (host.reshape(-1, s.nmems)[near] * w[:, None]).sum(axis=0)
        got = post.interpolate("T2m", t0, plat, plon)
        errs.append(compare(f"phase 23 interpolate at ({plat}, {plon})",
                            got.cpu(), torch.as_tensor(want)))
    ys = slice(s.ny // 10, s.ny // 10 + max(2, s.ny // 25))
    xs = [5, 17, s.nx * 7 // 8]
    sub = post.isel(y=ys, x=xs, mem=slice(0, 10))
    errs.append(compare("phase 23 isel", sub.data[0, 0].cpu(),
                        torch.as_tensor(host[ys][:, xs, :10])))
    box = post.sel(lat=slice(10.0, 20.0), lon=slice(350.0, 10.0))
    ym = (s.lat[:, 0] >= 10.0) & (s.lat[:, 0] <= 20.0)
    xm = (np.mod(s.lon[0], 360) >= 350.0) | (np.mod(s.lon[0], 360) <= 10.0)
    errs.append(compare("phase 23 sel", box.data[0, 0].cpu(),
                        torch.as_tensor(host[ym][:, xm])))
    return max(errs)


def phase23(dev="cuda", **cut):
    """The observation pipeline on phase 4's grid: DataFrame ingest,
    ``superob``, ``thin_by_distance``, ``sort_spatially``, ``EnSRF`` with
    ``fast_geometry`` and ``spatial_sort`` (B1 + B2) with one custom
    forward operator in the batch, held against the plain versions
    (:func:`_pipeline_against_plain`), then
    ``obs_assimilation_statistics``, ``desroziers_diagnostics``,
    ``field_verification`` and the state probes, each held against NumPy
    on the host copy; host seconds of each step and the obs count after
    each thinning step."""
    import torch

    from efa_xray_tpu_torch import (
        EnSRF,
        FilterConfig,
        Observation,
        ObservationBatch,
        obs_assimilation_statistics,
    )
    from efa_xray_tpu_torch.observation import forward as fwd
    from efa_xray_tpu_torch.observation import thinning
    from efa_xray_tpu_torch.postprocess import (
        desroziers_diagnostics,
        field_verification,
    )

    p = dict(PIPE23, **cut)
    sync = _syncer(dev)
    cuda = torch.device(dev).type == "cuda"
    state, truth = _pipeline_state(dev, p["ny"], p["nmems"], p["nmodes"],
                                   p["seed"])
    df = _pipeline_dataframe(state, truth, p)
    secs, counts_after = {}, {"raw": len(df)}

    def step(name, fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        secs[name] = time.perf_counter() - t
        return out

    batch = step("from_dataframe", lambda: ObservationBatch.from_dataframe(df))
    batch = step("superob", lambda: thinning.superob(batch, p["cell_deg"]))
    counts_after["superob"] = batch.nobs
    batch = step("thin", lambda: thinning.thin_by_distance(batch,
                                                           p["min_km"]))
    counts_after["thin"] = batch.nobs
    batch = step("sort", lambda: thinning.sort_spatially(batch))
    t0 = state.structure.times64()[0]
    gmean = lambda st: st.data[0, 0].mean(dim=(0, 1))
    custom = Observation(
        value=float(truth.mean() + 0.2), obtype="T2m_global_mean", time=t0,
        error=0.05, lat=0.0, lon=0.0, assimilate_this=True,
        forward_operator=gmean)
    # The custom ob goes first, so that its recorded prior is its own
    # operator's (a later ob's is the tail after the obs before it).
    obs = step("to_observations", lambda: [custom] + batch.to_observations())
    cfg = FilterConfig(localization="GC", fast_geometry=True,
                       spatial_sort=True, dtype="float32")
    _reset_counts()
    with _FirstCall(EnSRF, "_kernel_tail") as tail_spy, \
            _FirstCall(EnSRF, "_body_apply") as body_spy:
        post, out = step("update", lambda: EnSRF(
            state, obs, inflation=p["inflation"], config=cfg,
            verbose=False).update())
    counts = _counts()
    plain = _pipeline_against_plain(tail_spy.got, body_spy.got,
                                    p["tail_check_panels"])
    nobs = out.nobs
    if cuda:
        check(_only(B1=-(-nobs // cfg.tail_panel), B2=None)(counts),
              f"phase 23: launches {counts}")
    inn = _innovations("phase 23", out, out)
    want_prior = float(gmean(state).double().mean())
    check(abs(out.prior_mean[0] - want_prior) < 1e-3,
          f"phase 23: the custom operator's prior {out.prior_mean[0]} is "
          f"not its own {want_prior}")

    stats = step("statistics", lambda: obs_assimilation_statistics(
        state, post, out))
    # The table re-applies the interpolation taps, so the custom ob's row
    # (the first) carries no meaning for Desroziers: it is left out.
    dd = step("desroziers", lambda: desroziers_diagnostics(stats.iloc[1:]))
    fv = step("field_verification", lambda: field_verification(
        post, truth[None, None]))
    # The same on the host copy, in NumPy.
    s = state.structure
    prior_h = state.to_vect().double().cpu().numpy()
    post_h = post.to_vect().double().cpu().numpy()
    taps = fwd.build_taps_cached(s, out.lats, out.lons, out.times_s,
                                 out.var_indices(s), device=state.device)
    errs = {}
    for name, vect in (("prior", prior_h), ("post", post_h)):
        ye = np.einsum("okm,ok->om", vect[taps.rows], taps.weights)
        errs[f"{name} mean"] = compare(
            f"phase 23 statistics {name} mean",
            torch.tensor(stats[f"{name} mean"].to_numpy()),
            torch.tensor(ye.mean(axis=1)))
        errs[f"{name} variance"] = compare(
            f"phase 23 statistics {name} variance",
            torch.tensor(stats[f"{name} variance"].to_numpy()),
            torch.tensor(ye.var(axis=1)))
    a = stats.iloc[1:][stats["assimilated"].iloc[1:]]
    for ot, g in a.groupby("obtype"):
        d_b = (g["value"] - g["prior mean"]).to_numpy()
        d_a = (g["value"] - g["post mean"]).to_numpy()
        check(abs(dd.loc[ot, "R_estimated"] - np.mean(d_a * d_b)) < 1e-9,
              f"phase 23: desroziers R for {ot}")
    ens_h = post_h.reshape(s.ny * s.nx, s.nmems)
    mean_h = ens_h.mean(axis=1)
    tr = truth.ravel()
    m = s.nmems
    w = 2.0 * np.arange(m) + 1.0 - m
    fv_np = dict(
        rmse=np.sqrt(np.mean((mean_h - tr) ** 2)),
        bias=np.mean(mean_h - tr), spread=np.mean(ens_h.std(axis=1)),
        crps=np.mean(np.abs(ens_h - tr[:, None]))
        - np.mean(np.sort(ens_h, axis=1) @ w) / (m * m))
    for k, v in fv_np.items():
        got = float(fv[k].iloc[0])
        check(abs(got - v) <= 1e-4 * max(1.0, abs(v)),
              f"phase 23: field_verification {k} {got} vs NumPy {v}")
    prior_fv = field_verification(state, truth[None, None])
    check(float(fv["rmse"].iloc[0]) < float(prior_fv["rmse"].iloc[0]),
          "phase 23: the analysis RMSE is not below the background's")
    probe_err = step("probes", lambda: _pipeline_probes(
        post, post.data[0, 0].cpu().numpy(), t0))
    res = dict(
        ngrid=s.ny * s.nx, nmems=s.nmems, obs_counts=counts_after,
        assimilated=nobs, launches=counts if cuda else None,
        host_seconds=secs, update_vs_plain=plain, mean_abs_innov=inn,
        desroziers=dd.reset_index().to_dict("records"),
        field_rmse=dict(background=float(prior_fv["rmse"].iloc[0]),
                        analysis=float(fv["rmse"].iloc[0])),
        field_spread=float(fv["spread"].iloc[0]),
        statistics_vs_numpy=errs, probes_vs_numpy=probe_err)
    log("phase 23: observation pipeline " + json.dumps(res, default=float))
    return res


# Phase 24: ``target``'s in-process part on phase 4's workload: 2,000
# candidate obs, the metric the area mean of T2m over a lat/lon box,
# float64 as ``cli target`` loads the state, greedy network of 10 picks.
TARGET24 = dict(ny=1024, nmems=80, ncand=2000, nselect=10, seed=24,
                lat_range=(30.0, 60.0), lon_range=(230.0, 300.0))


def _rel_gap(got, want) -> float:
    """Max abs difference of two float arrays (NaNs must coincide) over
    the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(bool((np.isnan(got) == np.isnan(want)).all()),
          "NaN patterns differ")
    ok = ~np.isnan(want)
    return float(np.abs(got[ok] - want[ok]).max()
                 / max(np.abs(want[ok]).max(), 1e-300))


def phase24(dev="cuda", **cut):
    """Ensemble sensitivity and observation targeting (what ``cli
    target`` runs once the state is read) on phase 4's workload in
    float64: ``region_mean_metric``, ``ensemble_sensitivity`` with a 95%
    significance mask, ``observation_impact`` over the candidates and
    ``greedy_obs_selection``, each held against NumPy float64 on the host
    copy; no kernel launched; host seconds of each step.  The CLI's
    netCDF steps need h5py, and the line says whether it is installed:
    without it they do not run here (``tests/test_torch_cli.py`` holds
    the CLI against the JAX package's on the CPU)."""
    import importlib.util

    import torch
    from scipy.stats import t as tdist

    from efa_xray_tpu_torch.observation import forward as fwd
    from efa_xray_tpu_torch.postprocess import sensitivity as sens

    p = dict(TARGET24, **cut)
    h5py = ("not installed on this machine"
            if importlib.util.find_spec("h5py") is None
            else importlib.import_module("h5py").__version__)
    sync = _syncer(dev)
    cuda = torch.device(dev).type == "cuda"
    secs = {}

    def step(name, fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        secs[name] = time.perf_counter() - t
        return out

    state32, _ = _api_state(dev, nmems=p["nmems"], ny=p["ny"], nobs=1)
    state = step("to float64", lambda: state32.astype("float64"))
    del state32
    batch = _api_batch(p["ncand"], p["seed"], ny=p["ny"])
    s = state.structure
    metric = sens.region_mean_metric("T2m", time_index=-1,
                                     lat_range=p["lat_range"],
                                     lon_range=p["lon_range"])
    _reset_counts()
    j = step("metric", lambda: sens.metric_values(state, metric))
    field = step("sensitivity", lambda: sens.ensemble_sensitivity(
        state, j, confidence=0.95)["T2m"])
    rank = step("impact", lambda: sens.observation_impact(state, batch,
                                                          metric))
    net = step("greedy", lambda: sens.greedy_obs_selection(
        state, batch, metric, p["nselect"]))
    counts = _counts()
    if cuda:
        check(_only()(counts), f"phase 24: launches {counts}")

    # The same in NumPy float64 on the host copy.
    host = step("host copy", lambda: state.to_vect().cpu().numpy())
    t0 = time.perf_counter()
    mask = ((s.lat >= p["lat_range"][0]) & (s.lat <= p["lat_range"][1])
            & (s.lon >= p["lon_range"][0]) & (s.lon <= p["lon_range"][1]))
    grid = host.reshape(s.ntimes, s.ny, s.nx, s.nmems)[-1]
    j_np = grid[mask].mean(axis=0)
    m = s.nmems
    jp = j_np - j_np.mean()
    xp = host - host.mean(axis=1, keepdims=True)
    cov = xp @ jp / (m - 1)
    varx = np.einsum("nm,nm->n", xp, xp) / (m - 1)
    del xp
    corr = cov / np.sqrt(varx * (jp @ jp / (m - 1)))
    tcrit = tdist.ppf(0.975, m - 2)
    rcrit = tcrit / np.sqrt(m - 2 + tcrit * tcrit)
    taps = fwd.build_taps_cached(s, batch.lats, batch.lons, batch.times_s,
                                 batch.var_indices(s), device=state.device)
    ye = np.einsum("okm,ok->om", host[taps.rows], taps.weights)
    yep = ye - ye.mean(axis=1, keepdims=True)
    varye = (yep * yep).sum(axis=1) / m
    covj = yep @ jp / (m - 1)
    kdenom = varye + batch.errors
    secs["numpy reference"] = time.perf_counter() - t0

    shape = (s.ntimes, s.ny, s.nx)
    gaps = dict(
        metric=_rel_gap(j, j_np),
        covariance=_rel_gap(field["covariance"], cov.reshape(shape)),
        sensitivity=_rel_gap(field["sensitivity"],
                             (cov / varx).reshape(shape)),
        correlation=_rel_gap(field["correlation"], corr.reshape(shape)),
        dJ_mean_pred=_rel_gap(rank["dJ_mean_pred"],
                              covj / kdenom * (batch.values
                                               - ye.mean(axis=1))),
        dJ_var_pred=_rel_gap(rank["dJ_var_pred"], -covj * covj / kdenom))
    for name, gap in gaps.items():
        check(gap <= 1e-9, f"phase 24: {name} differs from NumPy by "
              f"{gap:.3e} of its scale")
    near = np.abs(np.abs(corr) - rcrit) <= 1e-9
    sig_np = (np.abs(corr) > rcrit).reshape(shape)
    flips = int((field["significant"] != sig_np)[~near.reshape(shape)].sum())
    check(flips == 0, f"phase 24: {flips} significance flags differ")
    best = int(rank["dJ_var_pred"].idxmin())
    first = int(net["candidate"].iloc[0])
    check(first == best, f"phase 24: greedy's first pick {first} is not "
          f"the ranking's best {best}")
    check(bool(net["candidate"].is_unique) and len(net) == p["nselect"],
          "phase 24: greedy picks are not unique")
    check(abs(net["dJ_var_step"].iloc[0] - rank["dJ_var_pred"][best])
          <= 1e-9 * abs(rank["dJ_var_pred"][best]),
          "phase 24: greedy's first step is not the ranking's prediction")
    res = dict(
        h5py=h5py, ngrid=s.ny * s.nx, nmems=m, candidates=batch.nobs,
        region_points=int(mask.sum()), launches=counts if cuda else None,
        host_seconds=secs, gap_vs_numpy=gaps,
        significant_share=float(sig_np.mean()),
        best=dict(candidate=best, lat=float(batch.lats[best]),
                  lon=float(batch.lons[best]),
                  dJ_var_pred=float(rank["dJ_var_pred"][best])),
        greedy=dict(picks=net["candidate"].tolist(),
                    dJ_var_cum=float(net["dJ_var_cum"].iloc[-1])))
    log("phase 24: ensemble sensitivity and targeting " + json.dumps(res))
    return res


# Phase 25: phase 4's workload (``api``), the shards of each case, and
# configs 11 and 6 (``c11``, ``c6``) as phases 18 and 19 run them.
MESH25 = dict(fast=4, default=3, hybrid=2, solvers=2)


def _mesh_parts():
    """The sharded drivers' parts, each closed by a synchronize: padding,
    the split of the rows onto the shards' devices, the obs' replication,
    the tail (once, on the first device), the shards' solves, the gather,
    and the LETKF's host selection build."""
    from efa_xray_tpu_torch.assimilation import ensrf_core as core
    from efa_xray_tpu_torch.assimilation import letkf_core as tl
    from efa_xray_tpu_torch.parallel import sharded

    # The EnSRF's and the EnKF's kernel tails are both tail_scan_blocked.
    return [(sharded, "pad_rows", "pad"), (sharded, "_split", "split"),
            (sharded, "_obs_to", "replicate"),
            (core, "tail_scan_blocked", "tail"),
            (sharded, "_ensrf_local", "shards"),
            (sharded, "_enkf_local", "shards"),
            (sharded, "_letkf_local", "shards"),
            (sharded, "_gather", "gather"),
            (tl, "host_select_candidates", "host_build")]


def _mesh_vs_single(label, make, shards, dev, expect, gate=(RTOL, ATOL),
                    warm=False):
    """``make(mesh)`` is a filter on one state; its ``update()`` on one
    device (once to fill the structure's caches, once timed) and on a
    mesh of ``shards`` repeats of ``dev`` (``make_mesh()``'s defaults when
    None), timed by parts, after one untimed mesh update when ``warm``
    (the first use of another card loads the kernels there).  The launches of the mesh run are checked with
    ``expect`` on the card (none on the CPU) and its posterior and
    diagnostics held against the single-device update at ``gate``
    (rtol, atol).  Returns a dict of the numbers."""
    import torch

    from efa_xray_tpu_torch.parallel import make_mesh

    sync = _syncer(dev)
    names = ("prior_mean", "prior_var", "post_mean", "post_var")

    def run(mesh):
        post, obs = make(mesh).update()
        return post, {k: np.array(getattr(obs, k)) for k in names}, np.array(
            obs.assimilated)

    run(None)
    (post1, d1, a1), wall1, _ = _spans(lambda: run(None), [], sync)
    mesh = make_mesh() if shards is None else make_mesh([dev] * shards)
    if warm:
        run(mesh)
    _reset_counts()
    (postm, dm, am), wallm, spent = _spans(lambda: run(mesh), _mesh_parts(),
                                           sync)
    counts = _counts()
    cuda = torch.device(dev).type == "cuda"
    check((expect if cuda else _only())(counts), f"{label}: launches {counts}")
    check(bool(torch.isfinite(postm.data).all()), f"{label}: not finite")
    rtol, atol = gate
    err = float((postm.data - post1.data).abs().max())
    check(bool(torch.allclose(postm.data, post1.data, rtol=rtol, atol=atol)),
          f"{label}: the mesh posterior differs from the single-device one "
          f"by {err:.3e} (rtol {rtol}, atol {atol})")
    check(bool((am == a1).all()), f"{label}: assimilated flags differ")
    diag_err = 0.0
    for k in names:
        got, want = dm[k][a1], d1[k][a1]
        check(bool(np.allclose(got, want, rtol=rtol, atol=atol)),
              f"{label}: {k} differs from the single-device one")
        diag_err = max(diag_err, float(np.abs(got - want).max(initial=0.0)))
    return dict(shards=mesh.size, device=str(mesh.devices[0]),
                launches=counts if cuda else None, max_abs_err=err,
                bitwise=bool(torch.equal(postm.data, post1.data)),
                diag_max_abs_err=diag_err, gate=dict(rtol=rtol, atol=atol),
                single_s=wall1, mesh_s=wallm,
                **{f"{k}_s": v for k, v in spent.items()})


def phase25(dev="cuda", api=None, c11=None, c6=None):
    """The mesh on the card: ``mesh=`` with several shards on the one
    device (``make_mesh([dev] * n)``), each case held against the
    single-device update on the same inputs.  (a) phase 4's workload
    (``fast_geometry``) on 4 shards: B1 once per panel on the mesh's
    first device, B2 once per shard plus the tail's applies; (b) the default
    config on 3 shards (1,048,576 rows are not a multiple of 3: the
    padding runs): B1 + B4; (c) phase 11 (a)'s hybrid config on 2 shards:
    B1h + B2h; (d) the EnKF at config 11 (B1e once per panel, B2e per
    panel and once per shard) and the LETKF at config 6 with
    ``letkf_topk="host"`` (its selection rebuilt for 2 shards; NS) on 2
    shards; (e) ``make_mesh()`` with its defaults, one device
    here (on a machine of several cards, every card, timed after one
    warm-up update: B1 and the tail's B2 once, on the first card, one B2
    body per card): the update bit for bit.  (a)-(d) at the f32 kernel
    gate (rtol 2e-5, atol 2e-4); host seconds of each part around
    synchronizes."""
    import torch

    from efa_xray_tpu_torch import EnKF, EnSRF, FilterConfig, LETKF
    from efa_xray_tpu_torch.assimilation import letkf as tletkf
    from efa_xray_tpu_torch.parallel import pad_to_multiple

    out = {}
    state, batch = _api_state(dev, **(api or {}))
    nobs, ns = batch.nobs, state.structure.nstate
    panels = _tail_counts(nobs, 512, False)["panels"]
    nblocks = -(-nobs // 128)
    ensrf = lambda cfg: (lambda mesh: EnSRF(state, batch, config=cfg,
                                            verbose=False, mesh=mesh))
    fast = FilterConfig(localization="GC", dtype="float32",
                        fast_geometry=True)
    n = MESH25["fast"]
    out["a"] = _mesh_vs_single(
        "phase 25 (a)", ensrf(fast), n, dev,
        _only(B1=panels, B2=panels + n))
    n = MESH25["default"]
    out["b"] = _mesh_vs_single(
        "phase 25 (b)", ensrf(FilterConfig(localization="GC")), n, dev,
        _only(B1=panels, B4=_tail_counts(nobs, 512, True)["b4"]
              + n * nblocks))
    out["b"]["pad_rows"] = pad_to_multiple(ns, n) - ns
    n = MESH25["hybrid"]
    out["c"] = _mesh_vs_single(
        "phase 25 (c)", ensrf(_hybrid_config(ns, 111)), n, dev,
        _only(B1h=panels, B2h=n))
    cuda = torch.device(dev).type == "cuda"
    # make_mesh()'s defaults take every card (B1 and the tail's B2
    # applies once, on the first card, and one B2 body per card); a CPU
    # rehearsal lists the CPU once
    cards = torch.cuda.device_count() if cuda else 1
    out["e"] = _mesh_vs_single(
        "phase 25 (e)", ensrf(fast), None if cuda else 1, dev,
        _only(B1=panels, B2=panels + cards), warm=True)
    check(out["e"]["bitwise"], "phase 25 (e): a mesh of one device is not "
          "the single-device update bit for bit")
    check(out["e"]["shards"] == cards,
          "phase 25 (e): make_mesh() does not take every card")
    del state, batch
    n = MESH25["solvers"]
    p = dict(CONFIG11, **(c11 or {}))
    state, batch = _half_degree_workload(dev, **p)
    cfg = FilterConfig(localization="GC", fast_geometry=True,
                       block_size=p["block"])
    out["d_enkf"] = _mesh_vs_single(
        "phase 25 (d) EnKF", lambda mesh: EnKF(
            state, batch, config=cfg, verbose=False, seed=p["seed"],
            mesh=mesh), n, dev,
        _enkf_only(p["nobs"], "B2", bodies=n, block=p["block"]))
    del state, batch
    p = dict(CONFIG6, **(c6 or {}))
    state, batch = _half_degree_workload(dev, **p)
    cfg = FilterConfig(localization="GC", letkf_patch_size=p["patch"],
                       letkf_k_obs=p["k"], letkf_chunk=p["chunk"],
                       letkf_topk="host")
    builds = tletkf.sel_build_count
    out["d_letkf"] = _mesh_vs_single(
        "phase 25 (d) LETKF", lambda mesh: LETKF(
            state, batch, config=cfg, mesh=mesh), n, dev,
            _only(NS=None, LG=None))
    out["d_letkf"]["host_selection_builds"] = tletkf.sel_build_count - builds
    check(out["d_letkf"]["host_selection_builds"] == 2,
          "phase 25 (d): the host selection was not rebuilt for the mesh")
    for case, r in out.items():
        log(f"phase 25 ({case}): " + json.dumps(r))
    return out


# Phase 26's gates.  (a) A tensor-core mode's kernel against its plain
# version in the same mode, one obs block at a time from the same input: the
# kernel's own output of the blocks before (the whole launch must equal
# that chain of one-block launches bit for bit).  The plain version runs in
# float64 from that input: the same roundings at the same points, the rest
# exact (in fp32 on the card its matmuls err as much as the kernel's tensor
# cores, at 256 members more).  On one block both round the same X and Y
# for D0, whose products are then exact.  What they can round apart is the
# apply's left operand W (g o U, B2h's V), which the kernel computes in
# fp32: an entry next to a midpoint may round to the other neighbour, which
# moves its term by one unit of the mode's rounding, at most FLIP_UNIT x
# |W_rj| x |round(Y_jc)| (one ulp: 2^-10 in TF32, 2^-7 in bf16).  So, per entry, the mean (fp32 from D0 on) is held
# at the f32 gate (rtol 2e-5 / atol 2e-4), and the perturbations at the f32
# gate plus FLIP_UNIT x sum_j |W_rj| |round(Y_jc)|, every term flipped.
# That sum is as large as the mode's whole effect, so gate (a) also holds
# the RMS of kernel minus plain, per member column over all rows and
# blocks, to at most SHARE_GATE of the RMS of the mode's effect there (the
# plain version in the mode minus the plain version in fp32).  Flips are
# rare single ulps; a wrong rounding moves every term.  Planted faults are
# held at gate (a) beside each kernel and must fail it (GATE_A_RUNS): the
# fp32 kernel, the plain version truncating instead of rounding, and, at
# the PERF.md shapes, the plain version with one of its four rounded
# operands left unrounded (the smallest fault a kernel could make; its
# share is about half the effect's, as the two products' four roundings
# each add about as much).  (b) The API's posterior in a mode against the
# fp32 update: the RMS error over the increment's RMS, mean and
# perturbations apart.
FLIP_UNIT = {"tf32": 2.0 ** -10, "bf16": 2.0 ** -7}
SHARE_GATE = 0.25
API_MODE_GATE = {"tf32": 2e-3, "bf16": 1e-2}
# The settings phase 26 (b) runs: (matmul_precision, mxu_bf16).  The
# first is the fp32 reference the others are held against.
MODE_SETTINGS = ((None, False), ("highest", False), ("tensorfloat32", False),
                 ("bfloat16", False), (None, True))
# The kernels line's entries of phase 26: (name, phase 26 (a)'s key, the
# phase 26 (b) run whose launches it reports, source, TPU kernel), and the
# matmul_precision setting of each tensor-core mode there.
MODE_KERNELS = (
    ("B2 fused body", "B2", "api B2", "efa_xray_tpu_torch/csrc/ensrf_fused.cu",
     "efa_xray_tpu/ops/ensrf_pallas_fused.py:117"),
    ("B2h fused body, hybrid static column", "B2h", "api B2h",
     "efa_xray_tpu_torch/csrc/ensrf_fused.cu",
     "efa_xray_tpu/ops/ensrf_pallas_fused.py:208"),
    ("B3 grid body", "B3", "config 3 B3",
     "efa_xray_tpu_torch/csrc/ensrf_grid.cu",
     "efa_xray_tpu/ops/ensrf_pallas_fused.py:784"),
    ("B4 block apply (config 3's shape)", "B4 config 3", "config 3 B4",
     "efa_xray_tpu_torch/csrc/ensrf_grid.cu",
     "efa_xray_tpu/ops/ensrf_pallas.py:68"),
    ("B4 block apply (1024 x 1024 x 80, one group)", "B4 wide", "api B4",
     "efa_xray_tpu_torch/csrc/ensrf_grid.cu",
     "efa_xray_tpu/ops/ensrf_pallas.py:68"))
MODE_SETTING = {"tf32": "tensorfloat32", "bf16": "bfloat16"}
# What phase 26 cuts on the CPU: nothing on the card.
PHASE26 = dict(b2=dict(n=262_144, m=80, nobs=2048),
               c3=dict(ny=90, nx=180, vt=80, nmems=30, nobs=5000, seed=61,
                       group_levels=np.tile(C3_LEVELS, 4)),
               wide=dict(ny=1024, nx=1024, vt=1, nmems=80, nobs=10_000,
                         seed=72),
               api={}, c3api={}, edges={})


def _ms(fn, reps: int, dev) -> float:
    """:func:`cuda_ms` on the card; host milliseconds of a CPU
    rehearsal."""
    import torch

    if torch.device(dev).type == "cuda":
        return cuda_ms(fn, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _truncate(x, mode: str):
    """``x`` rounded toward zero to mode ``mode``'s bits: the fault the
    kernels' explicit rounding guards against (a tensor core reading raw
    fp32 bits)."""
    import torch

    if mode == "ieee":
        return x
    if x.dtype != torch.float32:
        return _truncate(x.to(torch.float32), mode).to(x.dtype)
    keep = ~0x1FFF if mode == "tf32" else ~0xFFFF
    return (x.contiguous().view(torch.int32) & keep).view(torch.float32)


@contextlib.contextmanager
def _plain_rounding(fn):
    """The plain versions of B2-B4 with their input rounding replaced by
    ``fn(x, mode)`` (a planted fault for gate (a)'s controls)."""
    from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid

    saved = ensrf_fused.round_inputs, ensrf_grid.round_inputs
    ensrf_fused.round_inputs = ensrf_grid.round_inputs = fn
    try:
        yield
    finally:
        ensrf_fused.round_inputs, ensrf_grid.round_inputs = saved


def _entry_gate(got, want, allow):
    """Gate (a) per entry for ``got = (mean, perts)`` against ``want``:
    the mean at the f32 gate, the perturbations at the f32 gate plus
    ``allow``.  Returns ``(entries outside, max abs err, per-column sums
    of the squared perturbation errors)``."""
    import torch

    gm, gp = got[0].double(), got[1].double()
    wm, wp = want[0].double(), want[1].double()
    check(bool(torch.isfinite(gm).all() and torch.isfinite(gp).all()),
          "phase 26: not finite")
    em, ep = (gm - wm).abs(), (gp - wp).abs()
    bad = (int((em > ATOL + RTOL * wm.abs()).sum())
           + int((ep > ATOL + RTOL * wp.abs() + allow).sum()))
    return bad, max(float(em.max()), float(ep.max())), ((gp - wp) ** 2).sum(0)


# The runs gate (a) holds on each block: the kernel in the mode, then the
# planted faults, each of which must fail.  The plain versions round, per
# block, X then Y for D0, then W then Y for the apply: OPERAND_FAULTS
# leave the operand at that position unrounded.
OPERAND_FAULTS = ("plain, X unrounded in D0", "plain, Y unrounded in D0",
                  "plain, W unrounded in the apply",
                  "plain, Y unrounded in the apply")
GATE_A_RUNS = ("kernel", "fp32 kernel", "truncating plain") + OPERAND_FAULTS


def _unrounded(position: int):
    """A rounding for :func:`_plain_rounding` that leaves the operand at
    ``position`` (of ``OPERAND_FAULTS``' order) of each plain run on one
    block unrounded."""
    from efa_xray_tpu_torch.ops.precision import round_inputs

    calls = [0]

    def rnd(x, mode):
        k = calls[0]
        calls[0] += 1
        return x if k == position else round_inputs(x, mode)

    return rnd


def hold_mode(label, launch, plain, bm, bp, nblocks: int, mode: str,
              operand_faults: bool = True):
    """Gate (a) for one kernel in tensor-core mode ``mode`` on one input.
    ``launch(bm, bp, blocks, mode)`` runs the kernel's wrapper over the obs
    blocks of the slice ``blocks``; ``plain(bm, bp, blocks, mode,
    operands)`` its plain version, in the dtype of ``bp``.  The whole
    launch must equal the chain of one-block launches bit for bit; each
    block's launch is held against the plain version on the same input in
    float64 (the same roundings, the rest exact), per entry and per member
    column (the comment above ``FLIP_UNIT``), beside the planted faults of
    ``GATE_A_RUNS`` (``OPERAND_FAULTS`` only with ``operand_faults``),
    each of which must fail.  Also reads the plain version in fp32 the
    same way (not gated), whose summed milliseconds over the blocks are
    the plain version's time in the mode (``"plain_ms"``).  Returns the
    readings, the whole launch's output under ``"out"``."""
    import torch

    from efa_xray_tpu_torch.ops.precision import round_inputs

    runs = GATE_A_RUNS if operand_faults else GATE_A_RUNS[:3]
    sync = _syncer(bp.device)
    plain_s = 0.0
    full = launch(bm, bp, slice(None), mode)
    x = (bm, bp)
    bad = dict.fromkeys(runs, 0)
    err = dict.fromkeys(runs, 0.0)
    sq = dict.fromkeys(runs, 0.0)
    effect, sq32, past_f32, allowed = 0.0, 0.0, 0, 0.0
    for b in range(nblocks):
        s = slice(b, b + 1)
        got = launch(*x, s, mode)
        x64 = (x[0].double(), x[1].double())
        ops = []
        want = plain(*x64, s, mode, ops)
        # One apply a block, or one a sub-block where the block is swept
        # in sub-blocks.
        allow = FLIP_UNIT[mode] * sum(left.abs()
                                      @ round_inputs(y, mode).abs()
                                      for left, y in ops)
        del ops
        ref = plain(*x64, s, "ieee", None)
        effect = effect + ((want[1] - ref[1]) ** 2).sum(0)
        sync()
        t0 = time.perf_counter()
        ref = plain(*x, s, mode, None)
        sync()
        plain_s += time.perf_counter() - t0
        sq32 = sq32 + ((ref[1].double() - want[1]) ** 2).sum(0)
        del ref
        for run in runs:
            if run == "kernel":
                out = got
            elif run == "fp32 kernel":
                out = launch(*x, s, "ieee")
            else:
                with _plain_rounding(
                        _truncate if run == "truncating plain" else
                        _unrounded(OPERAND_FAULTS.index(run))):
                    out = plain(*x64, s, mode, None)
            n, e, q = _entry_gate(out, want, allow)
            bad[run] += n
            err[run] = max(err[run], e)
            sq[run] = sq[run] + q
            del out
        past_f32 += int(((got[1].double() - want[1].double()).abs()
                         > ATOL + RTOL * want[1].double().abs()).sum())
        allowed = max(allowed, float(allow.max()))
        del want, allow
        x = got
    check(torch.equal(full[0], x[0]) and torch.equal(full[1], x[1]),
          f"{label} {mode}: the whole launch is not the chain of one-block "
          "launches bit for bit")
    share = {run: float(torch.nan_to_num(torch.sqrt(q / effect),
                                         nan=0.0).max())
             for run, q in dict(sq, fp32_plain=sq32).items()}
    fails = {run: bad[run] > 0 or share[run] > SHARE_GATE for run in runs}
    check(not fails["kernel"],
          f"{label} {mode}: gate (a): {bad['kernel']} entries outside the "
          f"f32 gate plus the flip allowance (max abs err "
          f"{err['kernel']:.3e}), largest column share of the mode's effect "
          f"{share['kernel']:.3f} (gate {SHARE_GATE})")
    for run in runs[1:]:
        check(fails[run], f"{label} {mode}: the planted fault '{run}' "
              f"passes gate (a) ({bad[run]} entries outside, column share "
              f"{share[run]:.3f})")
    return dict(max_abs_err=err["kernel"], beyond_f32_gate=past_f32,
                plain_ms=plain_s * 1e3,
                flip_allowance=allowed, share=share["kernel"],
                fp32_plain_share=share["fp32_plain"],
                controls={run: dict(entries_outside=bad[run],
                                    share=share[run])
                          for run in runs[1:]}, out=full)


def _b2_block_fns(args):
    """``(launch, plain, nblocks)`` for :func:`hold_mode` from B2's
    operands ``args`` after ``bm, bp`` (``fused_apply``'s order)."""
    from efa_xray_tpu_torch.ops import ensrf_fused

    bits, rest = args[4], args[5:]
    by_dtype = {}
    _, bsz, nmems = args[1].shape

    def sliced(s, dtype):
        if dtype not in by_dtype:
            by_dtype[dtype] = [t.to(dtype) for t in args[:4]]
        geom, y_b, ggt_b, tab_b = by_dtype[dtype]
        return (geom, y_b[s], ggt_b[s], tab_b[s],
                None if bits is None else bits[:, s], *rest)

    def launch(bm, bp, s, mode):
        # The kernel in a mode runs at that mode's tile (the cull bits are
        # computed at it).
        check(mode == "ieee" or rest[0] == ensrf_fused.plan(
            bsz, nmems, rest[4], mode).tile, f"B2 at {nmems} members: the "
            f"tile {rest[0]} is not the one of mode {mode}")
        return ensrf_fused.fused_apply(bm, bp, *sliced(s, bp.dtype),
                                       precision=mode)

    return (launch,
            lambda bm, bp, s, mode, ops: ensrf_fused.fused_apply_plain(
                bm, bp, *sliced(s, bp.dtype), precision=mode, operands=ops),
            args[1].shape[0])


def _grid_block_fns(entry, w, table, y_b, ggt_b, coef_b, vt):
    """``(launch, plain, nblocks)`` for :func:`hold_mode` from the grid
    kernel's operands: B3 over the blocks of ``y_b``, or B4 over its one
    block (``entry``).  A ``Geometry`` ``w`` reaches the kernel as it is
    and the plain version as its weights built in torch in fp32."""
    from efa_xray_tpu_torch.ops import ensrf_grid

    geo = w if isinstance(w, ensrf_grid.Geometry) else None
    if geo is not None:
        w = ensrf_grid.geometry_weights(*geo)
    by_dtype = {}

    def sliced(s, dtype):
        if dtype not in by_dtype:
            by_dtype[dtype] = [None if t is None else t.to(dtype)
                               for t in (w, table, y_b, ggt_b, coef_b)]
        w_, table_, y_, ggt_, coef_ = by_dtype[dtype]
        return (None if w_ is None else w_[s],
                None if table_ is None else table_[:, s], y_[s], ggt_[s],
                coef_[s])

    def launch(bm, bp, s, mode):
        ops = sliced(s, bp.dtype)
        if geo is not None:
            ops = (ensrf_grid.Geometry(geo.points, geo.obs[s]),) + ops[1:]
        if entry == "B4":
            return ensrf_grid.block_apply(
                bm, bp, *_first_block(ops)[0], vt, precision=mode)
        return ensrf_grid.grid_apply(bm, bp, *ops, vt, precision=mode)

    check(entry == "B3" or y_b.shape[0] == 1, "B4 takes one block")
    return (launch,
            lambda bm, bp, s, mode, ops: ensrf_grid.grid_apply_plain(
                bm, bp, *sliced(s, bp.dtype), vt, precision=mode,
                operands=ops),
            y_b.shape[0])


def _modes_case(label, fns, bm, bp, products, rest, nbyte, dev):
    """Phase 26 (a) for one kernel: its wrapper (``fns`` from
    :func:`_b2_block_fns` or :func:`_grid_block_fns`) against its plain
    version, in fp32 at the f32 gate and in each tensor-core mode at gate
    (a), each tensor-core output unlike the fp32 one; kernel ms (3 runs),
    plain ms (the plain version over every block: in a mode, timed inside
    gate (a)) and the bound.  Returns ``{mode: dict}``."""
    from efa_xray_tpu_torch.ops.precision import MODES

    launch, plain, nblocks = fns
    sync = _syncer(dev)
    every = slice(None)
    out = {}
    for mode in MODES:
        if mode == "ieee":
            ieee = launch(bm, bp, every, mode)
            sync()
            t0 = time.perf_counter()
            want = plain(bm, bp, every, mode, None)
            sync()
            r = dict(plain_ms=(time.perf_counter() - t0) * 1e3, vs_ieee=0.0,
                     max_abs_err=max(
                         compare(f"phase 26 {label} ieee {part}", g, w)
                         for part, g, w in zip(("mean", "perts"), ieee,
                                               want)))
            del want
        else:
            # plain_ms: the mode's plain version over every block, timed
            # inside the gate's runs.
            r = hold_mode(f"phase 26 {label}", launch, plain, bm, bp,
                          nblocks, mode)
            got = r.pop("out")
            r["vs_ieee"] = max(float((g - f).abs().max())
                               for g, f in zip(got, ieee))
            check(r["vs_ieee"] > 0.0, f"phase 26 {label} {mode}: the output "
                  "is the fp32 one (the mode took no effect)")
            del got
        out[mode] = dict(r, ms=_ms(lambda: launch(bm, bp, every, mode), 3,
                                   dev),
                         **mode_bound(products, rest, nbyte, mode))
    return out


def _phase26_kernels(dev, cut):
    """Phase 26 (a): B2, B2h, B3 and B4 in every mode at their PERF.md
    shapes.  Returns ``{kernel: {mode: dict}}``."""
    import torch

    from efa_xray_tpu_torch.assimilation import ensrf_core as core
    from efa_xray_tpu_torch.observation.localization import latlon_to_unit
    from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid

    res = {}
    w = _b2_workload(dev, **cut["b2"])
    n, m, nobs = w["n"], w["m"], w["nobs"]
    rnd = lambda k: torch.rand(k, generator=w["gen"], device=w["bp"].device)
    hyb = dict(body_sigma=2.0 + 2.0 * rnd(n), static_length=1000.0)
    tail_h = core.tail_scan_blocked(
        w["tm"], w["tp"], w["obs"], localize=True, fast_geometry=True,
        panel=512, kernels=True, max_radius_km=2000.0, hybrid_alpha=0.5,
        tail_sigma=2.0 + 2.0 * rnd(nobs), static_length=1000.0)
    for key, hybrid, tail in (("B2", False, w["tail"]), ("B2h", True,
                                                          tail_h)):
        ops = ensrf_fused.prepare(
            w["bp"], w["lat"], w["lon"], tail, w["obs"], block_size=128,
            max_radius_km=2000.0, hybrid=hybrid, **(hyb if hybrid else {}))
        args = (ops["geom"], ops["y_b"], ops["ggt_b"], ops["tab_b"],
                ops["bits"], ops["tile"], True, False, ops["series"], hybrid)
        res[key] = _modes_case(
            f"{key} {n} x {m} x {nobs} obs", _b2_block_fns(args), w["bm"],
            w["bp"], b2_flop(ops, n, m, True, hybrid, "products"),
            b2_flop(ops, n, m, True, hybrid, "rest"),
            nbytes(*args[:5]) + 2 * nbytes(w["bm"], w["bp"]), dev)
        del ops, args
    del w, tail_h
    bsz = 128
    c = _grid_case(**cut["c3"], dev=dev)
    ops = ensrf_grid.grid_prepare(c["bp"], c["body_vert"], c["tail"],
                                  c["obs"], c["ngrid"], block_size=bsz,
                                  vertical=True, group_factor=c["gf"])
    nb = ops["y_b"].shape[0]
    wts = ensrf_grid.grid_weights(latlon_to_unit(c["lat"], c["lon"]),
                                  ops["ob_xyz"], ops["radii"])
    args = (wts.reshape(nb, bsz, c["ngrid"]), ops["table"], ops["y_b"],
            ops["ggt_b"], ops["coef_b"])
    rows, mm = c["bp"].shape
    res["B3"] = _modes_case(
        "B3 config 3 + group factor",
        _grid_block_fns("B3", *args, ops["vt"]), c["bm"], c["bp"],
        body_flop(rows, nb, bsz, mm, "products"),
        body_flop(rows, nb, bsz, mm, "rest"),
        nbytes(*args) + 2 * nbytes(c["bm"], c["bp"]), dev)
    del c, ops, wts, args
    for key, dims, vertical in (("B4 config 3", cut["c3"], True),
                                ("B4 wide", cut["wide"], False)):
        c = _grid_case(**dims, dev=dev)
        tail, obs = c["tail"], c["obs"]
        sl = slice(0, bsz)
        rows, mm = c["bp"].shape
        vt, wts, table, ggt = ensrf_grid.block_operands(
            c["lat"], c["lon"], tail.ye[sl], tail.sqrt_coef[sl],
            obs.lats[sl], obs.lons[sl], obs.radii[sl], rows,
            body_vert=c["body_vert"], ob_vert=obs.verts[sl],
            ob_vrad=obs.vert_radii[sl], vertical=vertical, ngrid=c["ngrid"])
        coef = torch.stack([tail.gain_coef[sl], tail.sqrt_coef[sl]])
        # The launch reads the weights built in torch; the same block
        # computing them in the kernel is held against it below.
        geo = _first_block_geometry(c, bsz)
        ops = (None if wts is None else wts[None],
               None if table is None else table[:, None],
               tail.ye[sl].contiguous()[None], ggt.contiguous()[None],
               coef[None])
        res[key] = _modes_case(
            f"{key} (one block)", _grid_block_fns("B4", *ops, vt), c["bm"],
            c["bp"], body_flop(rows, 1, bsz, mm, "products"),
            body_flop(rows, 1, bsz, mm, "rest"),
            2 * nbytes(c["bm"], c["bp"]) + nbytes(*ops), dev)
        res[key + " in-kernel weights"] = _geometry_case(
            f"{key} (one block)", geo, ops, vt, c["bm"], c["bp"], res[key],
            dev)
        del c, tail, obs, ops, wts, geo
    return res


def _geometry_case(label, geo, ops, vt, bm, bp, read, dev) -> dict:
    """Phase 26 (a) for B4 computing its exact haversine weights (the
    ``Geometry`` ``geo``) against the launch that reads them (``ops``,
    :func:`_phase26_kernels`' operands with the torch weights; ``read``
    its numbers), in each mode: whether the two are equal bit for bit
    and, where not, the in-kernel launch at the f32 gate in fp32 and at
    gate (a) in a tensor-core mode against the plain version fed the
    torch weights; both launches timed.  Returns ``{mode: dict}``."""
    import torch

    from efa_xray_tpu_torch.ops import ensrf_grid
    from efa_xray_tpu_torch.ops.precision import MODES

    launch_w, plain, _ = _grid_block_fns("B4", *ops, vt)
    args = (geo,) + tuple(None if t is None else t[:, 0] if i == 0 else t[0]
                          for i, t in enumerate(ops[1:]))

    def launch(bm_, bp_, s, mode):
        return ensrf_grid.block_apply(bm_, bp_, *args, vt, precision=mode)

    out = {}
    every = slice(None)
    for mode in MODES:
        got = launch(bm, bp, every, mode)
        want = launch_w(bm, bp, every, mode)
        r = dict(bitwise=bool(all(torch.equal(g, w)
                                  for g, w in zip(got, want))),
                 vs_w=max(float((g - w).abs().max())
                          for g, w in zip(got, want)))
        if not r["bitwise"]:
            if mode == "ieee":
                ref = plain(bm, bp, every, mode, None)
                r["max_abs_err"] = max(
                    compare(f"phase 26 {label} in-kernel weights {part}", g,
                            w) for part, g, w in zip(("mean", "perts"), got,
                                                     ref))
            else:
                h = hold_mode(f"phase 26 {label} in-kernel weights", launch,
                              plain, bm, bp, 1, mode, operand_faults=False)
                h.pop("out")
                r.update(max_abs_err=h["max_abs_err"], share=h["share"])
        del got, want
        r.update(ms=_ms(lambda: launch(bm, bp, every, mode), 3, dev),
                 read_ms=read[mode]["ms"])
        out[mode] = r
    log(f"phase 26 (a): {label}, weights in the kernel against the launch "
        "that reads them: " + "; ".join(
            f"{mode} bit for bit {r['bitwise']} (max diff {r['vs_w']:.3e}"
            + (f", err {r['max_abs_err']:.3e}" if "max_abs_err" in r else "")
            + f"), {r['ms']:.3f} ms against {r['read_ms']:.3f} ms"
            for mode, r in out.items()))
    return out


def _phase26_edges(dev, cut):
    """Phase 26 (a) over the edge cases of phases 3 and 10 (B2, B2h) and
    6 and 7 (B3; B4 on each case's first block), in TF32 and bf16 at gate
    (a), with the fp32 kernel and the truncating plain version as planted
    faults.  ``cut`` may name the cases to run (``labels``).  Returns
    ``{kernel: {mode: dict}}``: the largest error and column share over
    the cases, the smallest share and entry count of each planted fault,
    and the labels."""
    labels = cut.get("labels")
    out = {}

    def hold(kernel, label, fns, bm, bp):
        if labels is not None and label not in labels:
            return
        for mode in ("tf32", "bf16"):
            r = hold_mode(f"phase 26 {kernel} edge case {label}", *fns[:2],
                          bm, bp, fns[2], mode, operand_faults=False)
            agg = out.setdefault(kernel, {}).setdefault(mode, dict(
                max_abs_err=0.0, share=0.0, fp32_plain_share=0.0,
                labels=[], controls={
                    run: dict(entries_outside=None, share=None)
                    for run in GATE_A_RUNS[1:3]}))
            agg["max_abs_err"] = max(agg["max_abs_err"], r["max_abs_err"])
            agg["share"] = max(agg["share"], r["share"])
            agg["fp32_plain_share"] = max(agg["fp32_plain_share"],
                                          r["fp32_plain_share"])
            agg["labels"].append(label)
            for run, c in r["controls"].items():
                for k, v in c.items():
                    have = agg["controls"][run][k]
                    agg["controls"][run][k] = v if have is None else min(
                        have, v)

    for hybrid in (False, True):
        for label, bm, bp, args, _ in _b2_edge_inputs(hybrid, dev):
            hold("B2h" if hybrid else "B2", label, _b2_block_fns(args), bm,
                 bp)
    for label, c, args, vt, _ in _grid_edge_inputs(dev):
        hold("B3", label, _grid_block_fns("B3", *args, vt), c["bm"],
             c["bp"])
        first = _first_block(args)[1]
        hold("B4", label, _grid_block_fns("B4", *first, vt), c["bm"],
             c["bp"])
    return out


def _rms_share(got, want, before) -> float:
    """RMS of ``got - want`` over the RMS of the increment ``want -
    before``."""
    import torch

    err = torch.sqrt(torch.mean((got - want) ** 2))
    inc = torch.sqrt(torch.mean((want - before) ** 2))
    return float(err / inc)


def _mode_runs(label, state, batch, base, route, dev):
    """Phase 26 (b) for one workload: ``EnSRF(...).update()`` at each of
    ``MODE_SETTINGS`` on ``base``'s route, timed (host clock around
    synchronizes), its launches held against the fp32 update's (the same
    counts; on the card the route's body launches in its mode and every
    other launch in fp32) and its posterior mean and perturbations
    against the fp32 update's at gate (b); a setting whose mode is fp32
    gives the fp32 posterior bit for bit.  Returns ``{setting: dict}``."""
    import dataclasses

    import torch

    from efa_xray_tpu_torch import EnSRF
    from efa_xray_tpu_torch.ops.precision import product_mode

    sync = _syncer(dev)
    cuda = torch.device(dev).type == "cuda"
    nstate = state.structure.nstate
    body = -(-batch.nobs // base.block_size) if route == "B4" else 1
    prior = state.to_vect()
    pm0 = prior.mean(dim=1)
    pp0 = prior - pm0[:, None]
    del prior
    ref, out = None, {}
    for mp, mxu in MODE_SETTINGS:
        setting = "mxu_bf16" if mxu else f"matmul_precision={mp}"
        cfg = dataclasses.replace(base, matmul_precision=mp, mxu_bf16=mxu)
        filt = EnSRF(state, batch, config=cfg, verbose=False)
        check(filt._route(nstate) == route,
              f"{label} {setting}: routed to {filt._route(nstate)}")
        mode = product_mode(cfg, route, dev)
        _reset_counts()
        (post, _), wall, _ = _spans(filt.update, [], sync)
        counts, by_mode = _counts(), _mode_counts()
        check(bool(torch.isfinite(post.data).all()),
              f"{label} {setting}: not finite")
        pv = post.to_vect()
        pm = pv.mean(dim=1)
        pp = pv - pm[:, None]
        del pv
        if ref is None:
            ref = dict(pm=pm, pp=pp, counts=counts)
        check(counts == ref["counts"],
              f"{label} {setting}: launches {counts}, fp32 {ref['counts']}")
        for k, modes in by_mode.items():
            for md, nl in modes.items():
                want = (0 if not cuda or md == "ieee" else
                        body if (k == route and md == mode) else 0)
                check(md == "ieee" or nl == want,
                      f"{label} {setting}: {k} launched {nl} times in "
                      f"{md}, not {want}")
        r = dict(mode=mode, wall_s=wall, launches=counts,
                 body_launches_in_mode=by_mode[route][mode] if cuda else 0,
                 mean_err_share=_rms_share(pm, ref["pm"], pm0),
                 perts_err_share=_rms_share(pp, ref["pp"], pp0))
        if mode == "ieee":
            check(torch.equal(pm, ref["pm"]) and torch.equal(pp, ref["pp"]),
                  f"{label} {setting}: fp32 products, but not the fp32 "
                  "posterior bit for bit")
        else:
            gate = API_MODE_GATE[mode]
            check(0.0 < max(r["mean_err_share"], r["perts_err_share"])
                  and r["mean_err_share"] <= gate
                  and r["perts_err_share"] <= gate,
                  f"{label} {setting} ({mode}): posterior error shares "
                  f"{r['mean_err_share']:.3e} / {r['perts_err_share']:.3e} "
                  f"of the increment RMS (gate {gate}; 0 means the mode "
                  "took no effect)")
        out[setting] = r
        del post, pm, pp
    return out


def phase26(dev="cuda", **cut):
    """The body kernels' product modes on the card: (a) B2, B2h, B3 and
    B4 in fp32, TF32 and bf16 at phase 3's, 10's, 6's and 7's shapes,
    each against its plain version in the same mode (gate (a), with its
    two planted faults), each tensor-core output unlike the fp32 one,
    then every edge case of those phases in TF32 and bf16 at gate (a);
    (b) ``EnSRF.update()`` on phase 4's workload (B2 with
    ``fast_geometry``, B4 at the default config, B2h in hybrid mode) and
    on config 3 (B4 at the default config, B3 with ``fast_geometry`` +
    varloc) at every setting of ``MODE_SETTINGS``: wall, launches
    (unchanged) and the posterior's error against the fp32 update (gate
    (b)); and phase 4's B2 update with ``mxu_bf16`` on a mesh of 2 shards
    of the card against the single-device one, each shard's body in bf16.
    ``cut`` overrides ``PHASE26``'s sizes for a CPU rehearsal (``edges``
    may name the edge cases to run: ``labels``)."""
    import dataclasses

    import torch

    from efa_xray_tpu_torch import EnSRF, FilterConfig

    p = {k: dict(v, **cut.get(k, {})) for k, v in PHASE26.items()}
    a = _phase26_kernels(dev, p)
    for key, modes in a.items():
        if key.endswith("in-kernel weights"):  # logged where measured
            continue
        log(f"phase 26 (a): {key}: " + "; ".join(
            f"{mode} err {r['max_abs_err']:.3e}" + (
                "" if mode == "ieee" else
                f" ({r['beyond_f32_gate']} entries past the f32 gate, flip "
                f"allowance up to {r['flip_allowance']:.3e}, column share "
                f"{r['share']:.4f} (the fp32 plain version's "
                f"{r['fp32_plain_share']:.4f}); planted faults: " + ", ".join(
                    f"{run} {c['entries_outside']} entries outside, share "
                    f"{c['share']:.3f}" for run, c in r["controls"].items())
                + ")")
            + f", vs fp32 {r['vs_ieee']:.3e}, kernel {r['ms']:.3f} ms plain "
            f"{r['plain_ms']:.2f} ms bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})" for mode, r in modes.items()))
    edges = _phase26_edges(dev, p["edges"])
    for key, modes in edges.items():
        log(f"phase 26 (a): {key} edge cases ({len(modes['tf32']['labels'])}"
            f"): " + "; ".join(
                f"{mode} err {r['max_abs_err']:.3e}, column share "
                f"{r['share']:.4f} (the fp32 plain version's "
                f"{r['fp32_plain_share']:.4f}); planted faults at least: "
                + ", ".join(
                    f"{run} {c['entries_outside']} entries outside, share "
                    f"{c['share']:.3f}" for run, c in r["controls"].items())
                for mode, r in modes.items()))
    b = {}
    state, batch = _api_state(dev, **p["api"])
    fast = FilterConfig(localization="GC", dtype="float32",
                        fast_geometry=True)
    for route, cfg in (("B2", fast),
                       ("B4", FilterConfig(localization="GC")),
                       ("B2h", _hybrid_config(state.structure.nstate, 111))):
        b[f"api {route}"] = _mode_runs(f"phase 26 (b) api {route}", state,
                                       batch, cfg, route, dev)
    panels = _tail_counts(batch.nobs, 512, False)["panels"]
    shards = 2
    mesh = _mesh_vs_single(
        "phase 26 (b) mesh mxu_bf16",
        lambda m: EnSRF(state, batch, verbose=False, mesh=m,
                        config=dataclasses.replace(fast, mxu_bf16=True)),
        shards, dev, _only(B1=panels, B2=panels + shards))
    by_mode = _mode_counts()["B2"]
    cuda = torch.device(dev).type == "cuda"
    check(not cuda or by_mode == dict(ieee=panels, tf32=0, bf16=shards),
          f"phase 26 (b) mesh mxu_bf16: B2 launches by mode {by_mode}, not "
          f"the tail's {panels} in fp32 and one body per shard in bf16")
    b["mesh B2 mxu_bf16"] = dict(mesh, b2_by_mode=by_mode)
    del state, batch
    state, batch, names = _config3_workload(dev=dev, **p["c3api"])
    for _, cfg, route in _config3_runs(names):
        b[f"config 3 {route}"] = _mode_runs(
            f"phase 26 (b) config 3 {route}", state, batch, cfg, route, dev)
    del state, batch
    for key, runs in b.items():
        if key.startswith("mesh"):
            log(f"phase 26 (b): {key} on {runs['shards']} shards: err "
                f"{runs['max_abs_err']:.3e} against the single-device "
                f"update (bitwise {runs['bitwise']}), B2 by mode "
                f"{runs['b2_by_mode']}, wall {runs['mesh_s']:.3f} s "
                f"(single device {runs['single_s']:.3f} s)")
            continue
        log(f"phase 26 (b): {key}: " + "; ".join(
            f"{s} ({r['mode']}): wall {r['wall_s']:.3f} s, body launches "
            f"in mode {r['body_launches_in_mode']}, error share mean "
            f"{r['mean_err_share']:.3e} perts {r['perts_err_share']:.3e}"
            for s, r in runs.items()))
    return dict(kernels=a, edges=edges, api=b)


# ---------------------------------------------------------------------------
# Phase 27: the port's examples (efa_xray_tpu_torch/examples) on the card.

# (a) Each example at its default arguments, with the kernels its compute
# steps launch on the card (as :func:`_only` takes them: None at least
# once, every kernel not named never).  The float64 examples (sensitivity
# targeting, the Lorenz-96 cyclers) take the plain torch route, the LETKF
# LG and NS and the EnKF B1e + B2e; the unlocalized point update of efa_demo
# takes B2's body.
EXAMPLES27 = (
    ("gridded_assimilation", [], dict(B1=None, B4=None)),
    ("gridded_assimilation", ["--solver", "letkf"], dict(NS=None, LG=None)),
    ("gridded_assimilation", ["--mesh"], dict(B1=None, B4=None)),
    ("obs_pipeline", [], dict(B1=None, B2=None)),
    ("obs_pipeline", ["--solver", "enkf"], dict(B1e=None, B2e=None)),
    ("obs_pipeline", ["--solver", "letkf"], dict(NS=None, LG=None)),
    ("sensitivity_targeting", [], {}),
    ("cycling_adaptive", [], {}),
    ("cycling_smoother", [], {}),
    ("cycling_smoother", ["--iau", "4"], {}),
    ("multivariate_swe", [], dict(B1=None, B4=None)),
    ("efa_demo", [], dict(B1=None, B2=None)),
)
# The examples whose inputs come from a torch.Generator, which draws
# differently on the card and on the CPU: their CPU run gets the card's.
TORCH_SEEDED27 = ("cycling_adaptive", "cycling_smoother", "multivariate_swe")
# (b) gridded_assimilation at BASELINE config 2's size: a 0.5-degree
# grid's 361 x 720 points, 40 members, 2,000 obs (the script's 8 lead
# times: 2,079,360 state points).
CONFIG2_27 = dict(ny=361, nx=720, nmems=40, nobs=2000)
# The float32 LETKF on the card against the one on the CPU, and against
# the float64 LETKF: phase 19's gate (RMS gaps of the mean and the
# perturbations within 1e-2 of the increment RMS).  Near-ties at rank k
# of the obs selection break differently by device and dtype, and a
# patch that takes another k-th ob moves by that ob's share.
LETKF_GATE27 = 1e-2


def _to_cpu(x):
    """Tensors and EnsembleStates, and dicts of them, on the CPU."""
    import torch

    from efa_xray_tpu_torch import EnsembleState

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, EnsembleState):
        return x.to("cpu")
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def _example_run(mod, args, inp, sync):
    """``mod.run(args, inp)`` with the launch counts reset before it, its
    own prints swallowed: ``(result, wall seconds, launches)``."""
    import io

    _reset_counts()
    sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = mod.run(args, inp)
    sync()
    return res, time.perf_counter() - t0, _counts()


def _gap(label, got, want, tol) -> float:
    """Max abs difference of ``got`` from ``want`` (tensors, arrays,
    numbers, dicts of them, or DataFrames: text columns equal, numeric
    ones compared), raising outside ``tol``: 32 the f32 gate
    (:func:`compare`), 64 rtol and atol 1e-9."""
    import pandas as pd
    import torch

    from efa_xray_tpu_torch.interop import to_host

    if isinstance(got, pd.DataFrame):
        check(list(got.columns) == list(want.columns)
              and list(got.index) == list(want.index),
              f"{label}: the tables' columns or rows differ")
        gaps = [0.0]
        for col in got.columns:
            g, w = got[col].to_numpy(), want[col].to_numpy()
            if g.dtype.kind in "fi":
                gaps.append(_gap(f"{label} {col}", g, w, tol))
            else:
                check(list(g) == list(w), f"{label} {col}: differs")
        return max(gaps)
    if isinstance(got, dict):
        return max(_gap(f"{label} {k}", got[k], want[k], tol) for k in got)
    g = torch.from_numpy(np.array(to_host(got), dtype=np.float64))
    w = torch.from_numpy(np.array(to_host(want), dtype=np.float64))
    check(g.shape == w.shape, f"{label}: shapes {g.shape} and {w.shape}")
    if tol == 32:
        return compare(label, g, w)
    err = (g - w).abs()
    check(not bool((err > 1e-9 + 1e-9 * w.abs()).any()),
          f"{label}: max abs err {float(err.max()):.3e} outside 1e-9")
    return float(err.max()) if err.numel() else 0.0


class _Built:
    """While open, records each construction of ``cls``: ``(state, a deep
    copy of the obs, keyword arguments)``."""

    def __init__(self, cls):
        self.cls, self.made = cls, []

    def __enter__(self):
        import copy

        real = self.real = self.cls.__init__
        made = self.made

        def init(obj, state, obs, *a, **k):
            made.append((state, copy.deepcopy(obs), k))
            real(obj, state, obs, *a, **k)

        self.cls.__init__ = init
        return self

    def __exit__(self, *exc):
        self.cls.__init__ = self.real


class _EnkfDraws:
    """While open, ``enkf.draw_ob_perturbations`` records its draws; with
    ``replay`` set it hands them back instead, moved to the device asked
    for, so that the CPU run of an EnKF example takes the card's table."""

    def __enter__(self):
        from efa_xray_tpu_torch.assimilation import enkf

        self.real, self.draws, self.replay = (enkf.draw_ob_perturbations,
                                              [], False)

        def draw(seed, errors, nmems, scale=True):
            if self.replay:
                return self.draws.pop(0).to(errors.device)
            eps = self.real(seed, errors, nmems, scale=scale)
            self.draws.append(eps)
            return eps

        enkf.draw_ob_perturbations = draw
        return self

    def __exit__(self, *exc):
        from efa_xray_tpu_torch.assimilation import enkf

        enkf.draw_ob_perturbations = self.real


def _letkf_float64(built):
    """The recorded LETKF (:class:`_Built`) again in float64 on its
    state's device: ``(posterior, batch)``."""
    import dataclasses

    from efa_xray_tpu_torch import LETKF

    state, obs, k = built.made[0]
    k = dict(k, config=dataclasses.replace(k["config"], dtype="float64"),
             mesh=None, verbose=False)
    return LETKF(state.astype("float64"), obs, **k).update()


def _stats_gap(got, want) -> float:
    """Largest difference of any CycleStats field over the run."""
    fields = ("analysis_rmse", "background_rmse", "mean_spread",
              "obs_prior_rmse", "obs_post_rmse", "analysis_crps")
    return max(abs(getattr(g, f) - getattr(w, f))
               for g, w in zip(got, want) for f in fields)


def _hold27(name, argv, inp, res, cpu, first, first_cpu, built) -> dict:
    """One example's card result ``res`` (from ``inp``) against its CPU
    run ``cpu``: the gaps by quantity (raising outside the gates)."""
    label = f"phase 27 (a) {name} {' '.join(argv)}".rstrip()
    if "letkf" in argv:
        prior = inp["state"]
        post64, _ = _letkf_float64(built)
        out, out_cpu = (r.get("batch", r.get("out")) for r in (res, cpu))
        return dict(
            vs_cpu=_posterior_gap(f"{label} card vs CPU", res["post"],
                                  cpu["post"].to(prior.device), prior,
                                  gate=LETKF_GATE27),
            vs_float64=_posterior_gap(f"{label} float32 vs float64",
                                      res["post"], post64, prior,
                                      gate=LETKF_GATE27),
            obs_post_mean_max_not_gated=float(np.abs(
                out.post_mean - out_cpu.post_mean).max()),
            prior_mean=_gap(f"{label} prior_mean", out.prior_mean,
                            out_cpu.prior_mean, 32))
    if name in ("gridded_assimilation", "efa_demo"):
        gaps = dict(posterior=_gap(f"{label} posterior", res["post"].data,
                                   cpu["post"].data, 32))
        if name == "efa_demo":
            gaps["variance rows"] = _gap(
                f"{label} variance rows",
                np.concatenate([res["prior_var"], res["post_var"]]),
                np.concatenate([cpu["prior_var"], cpu["post_var"]]), 32)
            return gaps
        gaps["statistics"] = _gap(f"{label} statistics", res["stats"],
                                  cpu["stats"], 32)
        keys = ("obs_rmse_prior", "obs_rmse_post", "field_rmse_prior",
                "field_rmse_post")
        gaps["rmse"] = _gap(f"{label} RMSE", {k: res[k] for k in keys},
                            {k: cpu[k] for k in keys}, 32)
        return gaps
    if name == "obs_pipeline":
        gaps = dict(posterior=_gap(f"{label} posterior", res["post"].data,
                                   cpu["post"].data, 32))
        for f in ("prior_mean", "prior_var", "post_mean", "post_var"):
            gaps[f] = _gap(f"{label} {f}", getattr(res["out"], f),
                           getattr(cpu["out"], f), 32)
        gaps["desroziers"] = _gap(f"{label} Desroziers", res["desroziers"],
                                  cpu["desroziers"], 32)
        return gaps
    if name == "sensitivity_targeting":
        check(res["best"] == cpu["best"], f"{label}: the pick differs")
        keys = ("j0_mean", "j0_spread", "frac_sig", "dj_var_pred",
                "dj_mean_pred", "dj_realized", "var_j0", "var_j1")
        return dict(
            numbers=_gap(f"{label} numbers", {k: res[k] for k in keys},
                         {k: cpu[k] for k in keys}, 64),
            impact=_gap(f"{label} impact", res["impact"], cpu["impact"], 64),
            sensitivity=_gap(f"{label} sensitivity",
                             res["sens"]["sensitivity"],
                             cpu["sens"]["sensitivity"], 64))
    if name == "multivariate_swe":
        keys = ("background_rmse", "analysis_rmse",
                "forecast_background_rmse", "forecast_analysis_rmse")
        return dict(
            analysis=_gap(f"{label} analysis", res["post"], cpu["post"], 32),
            rmse=_gap(f"{label} RMSE", {k: res[k] for k in keys},
                      {k: cpu[k] for k in keys}, 32),
            cycles_max_not_gated=_stats_gap(res["stats"], cpu["stats"]))
    # The Lorenz-96 cyclers, float64: the first analysis at 1e-9; the
    # chaotic run after it reported.
    return dict(
        first_analysis=max(
            _gap(f"{label} first analysis {part}", first["out"][i],
                 first_cpu["out"][i], 64)
            for i, part in enumerate(("mean", "perturbations"))),
        cycles_max_not_gated=_stats_gap(res["stats"], cpu["stats"]))


def _report27(mod, args, res) -> str:
    """The lines the example prints, one line, blanks collapsed."""
    return " | ".join(" ".join(line.split())
                      for text in mod.report(args, res)
                      for line in text.splitlines() if line.strip())


def phase27(dev="cuda", c2=None, names=None):
    """The port's examples on the card: (a) each at its default arguments
    through its compute steps, its launches, wall and printed numbers,
    held against the same example on the CPU in the same process; (b)
    gridded_assimilation at BASELINE config 2's size through the EnSRF
    (B1 + B4, held against the plain blocked update), the LETKF and a
    mesh of the card (bit for bit the single-device update), cold and
    warm walls and peak memory; (c) real_data_ingest's in-process part
    (the station CSV through ``cli.read_obs_csv`` and the CLI's update,
    no netCDF)."""
    import importlib
    import io

    import torch

    from efa_xray_tpu_torch import LETKF

    sync = _syncer(dev)
    cuda = torch.device(dev).type == "cuda"
    load = lambda n: importlib.import_module(f"efa_xray_tpu_torch.examples.{n}")
    a, single = {}, None
    for name, argv, kernels in EXAMPLES27:
        if names is not None and name not in names:
            continue
        mod = load(name)
        label = f"{name} {' '.join(argv)}".rstrip()
        args = mod.parse_args(argv + ["--device", str(dev)])
        args_cpu = mod.parse_args(argv + ["--device", "cpu"])
        inp = mod.inputs(args)
        inp_cpu = (_to_cpu(inp) if name in TORCH_SEEDED27
                   else mod.inputs(args_cpu))
        with _EnkfDraws() as draws, _Built(LETKF) as built:
            with _FirstCall() as first:
                res, wall, counts = _example_run(mod, args, inp, sync)
            draws.replay = True
            with _FirstCall() as first_cpu, contextlib.redirect_stdout(
                    io.StringIO()):
                cpu = mod.run(args_cpu, inp_cpu)
            if cuda:
                check(_only(**kernels)(counts),
                      f"phase 27 (a) {label}: launches {counts}")
            gaps = _hold27(name, argv, inp, res, cpu, first.got,
                           first_cpu.got, built)
        a[label] = dict(wall_s=wall, launches=counts, gaps=gaps)
        if name == "gridded_assimilation" and not argv:
            single = res["post"]
        elif name == "gridded_assimilation" and "--mesh" in argv:
            check(single is None or bool(torch.equal(res["post"].data,
                                                     single.data)),
                  "phase 27 (a): the mesh's posterior is not the "
                  "single-device one bit for bit")
        log(f"phase 27 (a) {label}: wall {wall:.3f} s, launches "
            f"{ {k: v for k, v in counts.items() if v} }, against the CPU "
            f"{json.dumps(gaps)}; prints: {_report27(mod, args, res)}")
    del single

    # (b) gridded_assimilation at BASELINE config 2's size.
    p = dict(CONFIG2_27, **(c2 or {}))
    mod = load("gridded_assimilation")
    base = ["--ny", str(p["ny"]), "--nx", str(p["nx"]), "--nmems",
            str(p["nmems"]), "--nobs", str(p["nobs"]), "--device", str(dev)]
    args = mod.parse_args(base)
    t0 = time.perf_counter()
    inp = mod.inputs(args)
    sync()
    inputs_s = time.perf_counter() - t0
    state = inp["state"]
    b = dict(points=state.structure.nstate, nmems=state.structure.nmems,
             nobs=len(inp["obs"]), inputs_s=inputs_s,
             state_gb=state.data.numel() * state.data.element_size() / 1e9)
    posts = {}
    for key, extra, kernels, warm in (
            ("ensrf", [], dict(B1=None, B4=None), True),
            ("letkf", ["--solver", "letkf"], dict(NS=None, LG=None), False),
            ("mesh", ["--mesh"], dict(B1=None, B4=None), True)):
        args = mod.parse_args(base + extra)
        run_inp = dict(inp, mesh=mod.make_mesh(args))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        res, cold, counts = _example_run(mod, args, run_inp, sync)
        walls = dict(cold_s=cold)
        if warm:
            del res
            res, walls["warm_s"], counts = _example_run(mod, args, run_inp,
                                                        sync)
        check(_only(**kernels)(counts) if cuda else True,
              f"phase 27 (b) {key}: launches {counts}")
        check(bool(torch.isfinite(res["post"].data).all()),
              f"phase 27 (b) {key}: posterior not finite")
        check(res["obs_rmse_post"] < res["obs_rmse_prior"],
              f"phase 27 (b) {key}: the obs-space RMSE did not drop")
        b[key] = dict(walls, launches={k: v for k, v in counts.items() if v},
                      peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                               if cuda else None),
                      **{k: res[k] for k in (
                          "obs_rmse_prior", "obs_rmse_post",
                          "field_rmse_prior", "field_rmse_post")})
        posts[key] = res["post"]
        del res
    check(bool(torch.equal(posts["mesh"].data, posts["ensrf"].data)),
          "phase 27 (b): the mesh's posterior is not the single-device one "
          "bit for bit")
    del posts["mesh"], posts["letkf"]
    from efa_xray_tpu_torch import FilterConfig

    sync()
    t0 = time.perf_counter()
    bm, _, pbm, pbp = _plain_update(state, inp["obs"],
                                    FilterConfig(localization="GC",
                                                 method="blocked"),
                                    inflation=1.05)
    sync()
    v = posts["ensrf"].to_vect()
    mean = v.mean(dim=1)
    b["plain"] = dict(
        seconds=time.perf_counter() - t0,
        mean_max_abs_err=compare("phase 27 (b) EnSRF mean vs plain", mean,
                                 pbm),
        perts_max_abs_err=compare("phase 27 (b) EnSRF perturbations vs "
                                  "plain", v - mean[:, None], pbp),
        increment_rms=float(torch.sqrt(torch.mean((pbm - bm) ** 2))))
    del posts, state, inp, bm, pbm, pbp, v, mean
    log(f"phase 27 (b) gridded_assimilation at config 2's size "
        f"{json.dumps(b)}")

    # (c) real_data_ingest without netCDF files.
    mod = load("real_data_ingest")
    work = os.path.join(_scratch_dir(), "ingest27")
    args = mod.parse_args(["--device", str(dev), "--workdir", work])
    args_cpu = mod.parse_args(["--device", "cpu", "--workdir", work])
    res, wall, counts = _example_run(mod, args, mod.inputs(args), sync)
    check(_only(B1=None, B4=None)(counts) if cuda else True,
          f"phase 27 (c): launches {counts}")
    cpu = mod.run(args_cpu, mod.inputs(args_cpu))
    c = dict(wall_s=wall, launches={k: v for k, v in counts.items() if v},
             rmse_prior=res["rmse_prior"], rmse_post=res["rmse_post"],
             gaps=dict(posterior=_gap("phase 27 (c) posterior",
                                      res["post"].data, cpu["post"].data,
                                      32),
                       statistics=_gap("phase 27 (c) statistics",
                                       res["stats"], cpu["stats"], 32)))
    log(f"phase 27 (c) real_data_ingest in process (read_obs_csv, the "
        f"CLI's update) {json.dumps(c)}")
    return dict(a=a, b=b, c=c)


# Phase 28: BASELINE config 4 (the headline's 1e7 x 80 x 10k obs) through
# ``mesh=`` at full size (``c4`` cuts it for a rehearsal), and whether the
# shards on distinct cards overlap; with two distinct devices or more,
# configs 11, 6 and 7 (``c11``, ``c6``, ``c7``) too.


def _mesh_devices(dev):
    """The devices of phase 28's mesh: ``make_mesh()``'s defaults (every
    card) on the card; on the CPU the CPU named twice ("cpu" and "cpu:0":
    two distinct devices, so that (b) and the tail's copies run)."""
    import torch

    if torch.device(dev).type == "cuda":
        return None
    return [torch.device("cpu"), torch.device("cpu", 0)]


def _sync_cards(dev):
    """A synchronize of every card (nothing on the CPU)."""
    import torch

    if torch.device(dev).type != "cuda":
        return lambda: None
    cards = range(torch.cuda.device_count())
    return lambda: [torch.cuda.synchronize(i) for i in cards]


def _union_us(spans) -> float:
    """Microseconds covered by the union of ``(start, end)`` spans."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        total += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return total


def _card_overlap(fn, sync) -> dict:
    """One run of ``fn`` traced (:func:`_device_events`): each card's busy
    seconds (the union of its kernel and copy intervals), the device window
    (the first start to the last end over every card) and the effective
    parallelism, the cards' busy seconds summed over the window (1.0
    serial, the card count perfect)."""
    traced, events = _device_events(fn, sync)
    spans = {}
    for card, b, e, _ in events:
        spans.setdefault(card, []).append((b, e))
    busy = {card: _union_us(s) / 1e6 for card, s in sorted(spans.items())}
    every = [t for s in spans.values() for t in s]
    t0 = min(b for b, _ in every)
    window = (max(e for _, e in every) - t0) / 1e6
    return dict(traced=traced, busy_s=busy, window_s=window,
                parallelism=sum(busy.values()) / window,
                first_last_s={card: ((min(b for b, _ in s) - t0) / 1e6,
                                     (max(e for _, e in s) - t0) / 1e6)
                              for card, s in sorted(spans.items())})


def _mesh_overlap(label, run, dev, mesh, expect, gate=(RTOL, ATOL)) -> dict:
    """``run(m)`` is one update on the mesh ``m`` (the single-device
    update when None) returning tensors; it runs on ``mesh``.  Each is
    run once to warm up (the first use of a card loads the kernels
    there), then timed with no synchronize inside (every card
    synchronized on both sides): the single-device update 3 times; the
    mesh update once with its launches checked with ``expect`` (none on
    the CPU), its peak allocated memory read per card and its outputs
    held against the single-device ones at ``gate`` (rtol, atol), then
    twice more.  Then once by parts, each closed by a synchronize
    (:func:`_mesh_parts`), and on the card once traced
    (:func:`_card_overlap`).  Returns a dict."""
    import torch

    cuda = torch.device(dev).type == "cuda"
    sync = _sync_cards(dev)
    cards = range(torch.cuda.device_count() if cuda else 0)
    run(None)
    single_s = []
    for _ in range(3):
        want, wall, _ = _spans(lambda: run(None), [], sync)
        single_s.append(wall)
    run(mesh)
    _reset_counts()
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    got, wall, _ = _spans(lambda: run(mesh), [], sync)
    mesh_s = [wall]
    counts = _counts()
    check((expect if cuda else _only())(counts), f"{label}: launches {counts}")
    rtol, atol = gate
    err, bitwise = 0.0, True
    for g, w in zip(got, want):
        check(bool(torch.isfinite(g).all()), f"{label}: not finite")
        e = float((g.double() - w.double()).abs().max())
        check(bool(torch.allclose(g, w, rtol=rtol, atol=atol)),
              f"{label}: the mesh update differs from the single-device one "
              f"by {e:.3e} (rtol {rtol}, atol {atol})")
        err, bitwise = max(err, e), bitwise and bool(torch.equal(g, w))
    del got, want
    peak = [torch.cuda.max_memory_allocated(i) / 1e9 for i in cards]
    for _ in range(2):
        mesh_s.append(_spans(lambda: run(mesh), [], sync)[1])
    r = dict(devices=len(mesh.distinct_devices()), shards=mesh.size,
             launches=counts if cuda else None, max_abs_err=err,
             bitwise=bitwise, gate=dict(rtol=rtol, atol=atol),
             peak_gb_per_card=peak or None)
    r["single_s"] = statistics.median(single_s)
    r["mesh_s"] = statistics.median(mesh_s)
    r["runs_s"] = dict(single=single_s, mesh=mesh_s)
    r["parts_s"] = _spans(lambda: run(mesh), _mesh_parts(), sync)[2]
    if cuda:
        r.update(_card_overlap(lambda: run(mesh), sync))
        # The shards' issue, watched for the host waiting on a card.
        from efa_xray_tpu_torch.parallel import sharded

        real, waits = sharded.run_shards, []

        def watched(m, work):
            res, syncs = _sync_free(lambda: real(m, work))
            waits.extend(syncs)
            return res

        sharded.run_shards = watched
        try:
            run(mesh)
        finally:
            sharded.run_shards = real
        r["syncs_in_shards"] = len(waits)
        check(not waits, f"{label}: the host waited on a card while it "
              f"issued the shards: {waits}")
    return r


def phase28(dev="cuda", c4=None, c11=None, c6=None, c7=None):
    """BASELINE config 4 through ``mesh=`` at full size, and the overlap
    of the shards on distinct cards.  (a) The headline's 1e7
    Hilbert-ordered rows x 80 members x 10,000 obs at 2000 km through
    ``ensrf_update_sharded(..., mesh=make_mesh())`` (B1 + B2) against the
    single-device ``tail_scan_blocked`` + ``fused_body`` on the same
    prior: bit for bit on one card, at the f32 kernel gate on several;
    B1 once per panel, B2 once per panel and once per card.  (b) With two
    distinct devices or more: the EnKF at config 11 (B1e once per panel
    on the first card, B2e per panel and once per card), the LETKF at
    config 6 (``LETKF``, top-k exact and host: one group layout for every
    shard) and at config 7 (``letkf_update_sharded``, top-k exact), NS on
    every card, over every card, each against its single-device update
    at the f32 gate.  Each update warm, timed with no synchronize inside
    it; on the card one more mesh update traced per case: each card's
    busy seconds and first and last event, the device window, the
    effective parallelism; peak memory per card; and one more with
    ``run_shards`` watched for a synchronizing call (there must be
    none).  The mesh is ``make_mesh()``'s defaults on the card, "cpu"
    and "cpu:0" on the CPU."""
    import dataclasses

    import torch

    from efa_xray_tpu_torch import EnKF, FilterConfig, LETKF
    from efa_xray_tpu_torch.assimilation import letkf_core as tl
    from efa_xray_tpu_torch.parallel import make_mesh, sharded

    out = {}
    mesh = make_mesh(_mesh_devices(dev))
    tail_phase, body_phase, w = _headline(dev, **(c4 or {}))
    nstate, nobs = w["nstate"], w["nobs"]
    panels = _tail_counts(nobs, 512, False)["panels"]

    def config4(m):
        if m is None:
            tail = tail_phase()
            return (*body_phase(tail), tail.tail_mean, tail.tail_perts)
        return sharded.ensrf_update_sharded(
            w["bm"], w["bp"], w["tm"], w["tp"], w["lat"], w["lon"],
            w["obs"], m, localize=True, block_size=128,
            fast_geometry=True, tail_panel=512,
            max_radius_km=w["radius"])[:4]

    out["a"] = _mesh_overlap("phase 28 (a)", config4, dev, mesh,
                             _only(B1=panels, B2=panels + mesh.size))
    out["a"].update(nstate=nstate, nobs=nobs, obs_points_per_s=dict(
        single=nobs * nstate / out["a"]["single_s"],
        mesh=nobs * nstate / out["a"]["mesh_s"]))
    check(mesh.size > 1 or out["a"]["bitwise"], "phase 28 (a): a mesh of "
          "one card is not the single-device update bit for bit")
    del tail_phase, body_phase, w
    log("phase 28 (a): config 4 EnSRF " + json.dumps(out["a"]))
    if len(mesh.distinct_devices()) < 2:
        return out
    p = dict(CONFIG11, **(c11 or {}))
    state, batch = _half_degree_workload(dev, **p)
    cfg = FilterConfig(localization="GC", fast_geometry=True,
                       block_size=p["block"])
    out["b_enkf"] = _mesh_overlap(
        "phase 28 (b) EnKF", lambda m: (EnKF(
            state, batch, config=cfg, verbose=False, seed=p["seed"],
            mesh=m).update()[0].data,), dev, mesh,
        _enkf_only(p["nobs"], "B2", bodies=mesh.size, block=p["block"]))
    log("phase 28 (b): config 11 EnKF " + json.dumps(out["b_enkf"]))
    p = dict(CONFIG6, **(c6 or {}))
    state, batch = _half_degree_workload(dev, **p)
    cfg = FilterConfig(localization="GC", letkf_patch_size=p["patch"],
                       letkf_k_obs=p["k"], letkf_chunk=p["chunk"])
    for key, topk in (("b_letkf6", "exact"), ("b_letkf6_host", "host")):
        c = dataclasses.replace(cfg, letkf_topk=topk)
        out[key] = _mesh_overlap(
            f"phase 28 (b) LETKF config 6, top-k {topk}",
            lambda m, c=c: (LETKF(state, batch, config=c,
                                  mesh=m).update()[0].data,), dev, mesh,
            _only(NS=None, LG=None))
        log(f"phase 28 (b): config 6 LETKF, top-k {topk} "
            + json.dumps(out[key]))
    del state, batch
    p = dict(CONFIG7, **(c7 or {}))
    bm, bp, tm, tp, lat, lon, obs = _config7(dev, p)
    kw = dict(ngrid=p["npts"], patch_size=p["patch"], k_obs=p["k"],
              chunk=p["chunk"])

    def config7(m):
        if m is None:
            return tl.letkf_update(bm, bp, tm, tp, lat, lon, obs, **kw)[:2]
        return sharded.letkf_update_sharded(bm, bp, tm, tp, lat, lon, obs,
                                            m, **kw)[:2]

    out["b_letkf7"] = _mesh_overlap("phase 28 (b) LETKF config 7", config7,
                                    dev, mesh, _only(NS=None, LG=None))
    log("phase 28 (b): config 7 LETKF " + json.dumps(out["b_letkf7"]))
    return out


# P's products are timed as runs of this many calls back to back.
P_INNER = 20
# The numbers of NS's kernels-line entries.
NS_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")


# ---------------------------------------------------------------------------
# Any ensemble and any block on the card (ROADMAP queue C, fault C5)
# ---------------------------------------------------------------------------

# Phase 29: the members of its full-width updates (no member cut), the
# blocks of its 80-member ones and of config 4's headline, the rows and
# blocks each body kernel is held on beside its plain version, and the
# LETKF's region (``region``: rows x columns of config 6's half-degree
# grid, about four chunks of its units: a depth cut).  (a) takes the
# first 2,048 of phase 4's 10,000 obs and (c) 2,000 of config 3's 5,000:
# depth cuts, because the plain references' per-ob tail takes ~2 ms an ob
# whatever the ensemble, and at the full counts the whole script ran past
# its 1200 s (1215.5 s on an H100; PERF.md section 6).
PHASE29 = dict(nmems=512, ny=1024, nobs=2048, blocks=(256, 512, 1024),
               headline_block=512, hold_rows=16_384, hold_blocks=8,
               mode_hold_blocks=2, plain_rows=65_536,
               c3=dict(nmems=512, nobs=2000), c11=dict(nmems=512),
               c6=dict(nmems=512, ny=64, nx=128, region=True))


class _KernelCalls:
    """While open, a spy on the CUDA entries of B1 (``tail_panel_solve_
    cuda``), B2 (``fused_apply_cuda``) and B3/B4 (``grid_apply_cuda``):
    ``calls[key]`` is the first call of each kernel ("B1", "B1h", "B1e",
    "B2", "B2h", "B2e", "B3", "B4", "B4e"; a tensor-core mode appended as
    in "B2 tf32") at each row count (the key "B2 (10000 rows)": a tail's
    out-of-panel apply and the body are two), as ``(entry, args,
    kwargs)``, its tensors cloned before the call (the bodies update their
    inputs in place)."""

    def __enter__(self):
        import torch

        from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid, tail_solve

        mode = lambda m: "" if m == "ieee" else f" {m}"
        kinds = (
            (tail_solve, "tail_panel_solve_cuda", lambda a, k: (
                "B1e" if a[10] is not None else
                "B1h" if a[7] < 1.0 else "B1")),
            (ensrf_fused, "fused_apply_cuda", lambda a, k: (
                "B2e" if k.get("z_b") is not None else
                ("B2h" if a[11] else "B2") + mode(a[13]))),
            (ensrf_grid, "grid_apply_cuda", lambda a, k: (
                "B4e" if k.get("z_b") is not None else
                a[0] + mode(k.get("precision", "ieee")))))
        copy = lambda x: x.clone() if isinstance(x, torch.Tensor) else x
        self.calls, self.saved = {}, []
        for mod, name, kind_of in kinds:
            real = getattr(mod, name)

            def spy(*a, _real=real, _kind=kind_of, **k):
                rows = a[2 if isinstance(a[0], str) else 1].shape[0]
                kind = f"{_kind(a, k)} ({rows} rows)"
                if kind not in self.calls:
                    self.calls[kind] = (_real, tuple(copy(x) for x in a),
                                        {n: copy(v) for n, v in k.items()})
                return _real(*a, **k)

            self.saved.append((mod, name, real))
            setattr(mod, name, spy)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def _sample(n: int, k: int, seed: int, dev):
    """``k`` sorted indices of ``range(n)`` (all of them where ``k >=
    n``)."""
    import torch

    if k >= n:
        return torch.arange(n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randperm(n, generator=gen, device=dev)[:k].sort().values


def _hold_call(kind, call, rows: int, blocks: int,
               mode_blocks: int) -> dict:
    """One captured launch (:class:`_KernelCalls`) against its plain version
    on its own operands: B1 on the whole panel; the body kernels on
    ``rows`` of its rows (B3, B4: every group at a sample of the grid
    points) and its first ``blocks`` blocks, without the cull (exact), at
    the f32 gate in fp32 and on its first ``mode_blocks`` blocks at gate
    (a) (:func:`hold_mode`) in a tensor-core mode.  Kernel ms (the whole
    launch, 3 runs where one is under 50 ms), plain ms (the held cut), the
    whole launch's bound, and its plan."""
    import torch

    from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid, tail_solve

    fn, a, k = call
    label = f"phase 29 {kind}"
    if kind.startswith("B1"):
        got = fn(*a)
        want, p_ms = cuda_timed(lambda: tail_solve.tail_panel_solve_plain(
            *a[:11]))
        torch.cuda.synchronize()
        err = max(compare(f"{label} out{i}", g, w)
                  for i, (g, w) in enumerate(zip(got, want)))
        p, m = a[1].shape
        c = tail_solve.pick_cluster(p, m, hybrid=a[7] < 1.0,
                                    enkf=a[10] is not None)
        pp = tail_solve.padded_panel(p, tail_solve.DEFAULT_SUB, c)
        return dict(
            max_abs_err=err, ms=_launch_ms(lambda: fn(*a)), plain_ms=p_ms,
            shape=f"{p} x {m}", cluster=c,
            device_slab=tail_solve.in_device_memory(
                pp, m, tail_solve.DEFAULT_SUB, c, a[7] < 1.0,
                a[10] is not None),
            **bound(b1_flop(p, m, a[7] < 1.0),
                    nbytes(*(x for x in a if isinstance(x, torch.Tensor)))
                    + nbytes(*got)))
    if kind.startswith("B2"):
        (bm, bp, geom, y_b, ggt_b, tab_b, bits, tile, loc, vert, series,
         hybrid, _, prec) = a
        z_b = k.get("z_b")
        nrows, m = bp.shape
        nb, bsz, _ = y_b.shape
        full = lambda: fn(bm, bp, geom, y_b, ggt_b, tab_b, bits, tile, loc,
                          vert, series, hybrid, False, prec, z_b=z_b)
        plan = ensrf_fused.plan(bsz, m, hybrid, prec, tile)
        ops = dict(y_b=y_b, tile=tile, bits=bits)
        nbyte = nbytes(bm, bp, geom, y_b, ggt_b, tab_b, bits, z_b, bm, bp)
        b = mode_bound(
            b2_flop(ops, nrows, m, loc, hybrid, "products"),
            b2_flop(ops, nrows, m, loc, hybrid, "rest", plan.sub), nbyte,
            prec)
        s = _sample(nrows, rows, 29, bp.device)
        nbk = min(blocks if prec == "ieee" else mode_blocks, nb)
        cut = (geom[:, s], y_b[:nbk], ggt_b[:nbk], tab_b[:nbk], None, tile,
               loc, vert, series, hybrid)
        zc = None if z_b is None else z_b[:nbk]
        if prec == "ieee":
            got = fn(bm[s], bp[s], *cut, False, prec, z_b=zc)
            want, p_ms = cuda_timed(lambda: ensrf_fused.fused_apply_plain(
                bm[s], bp[s], *cut, precision=prec, z_b=zc))
            torch.cuda.synchronize()
            r = dict(max_abs_err=max(compare(f"{label} mean", got[0],
                                             want[0]),
                                     compare(f"{label} perts", got[1],
                                             want[1])))
        else:
            launch, plain, nbk = _b2_block_fns(cut)
            r = hold_mode(label, launch, plain, bm[s], bp[s], nbk, prec,
                          operand_faults=False)
            r.pop("out")
            p_ms = r.pop("plain_ms")
        return dict(r, ms=_launch_ms(full), plain_ms=p_ms,
                    shape=f"{nrows} x {m}, {nb} blocks of {bsz}",
                    plan=plan._asdict(), held=f"{len(s)} rows x {nbk} "
                    "blocks", **b)
    entry, bm, bp, w, table, y_b, ggt_b, coef_b, vt, _ = a
    prec = k.get("precision", "ieee")
    z_b = k.get("z_b")
    nrows, m = bp.shape
    nb, bsz, _ = y_b.shape
    g = nrows // vt
    full = lambda: fn(entry, bm, bp, w, table, y_b, ggt_b, coef_b, vt, False,
                      precision=prec, z_b=z_b)
    nbyte = nbytes(bm, bp, w, table, y_b, ggt_b, coef_b, z_b, bm, bp)
    plan = ensrf_grid.plan(bsz, m, prec)
    b = mode_bound(body_flop(nrows, nb, bsz, m, "products"),
                   body_flop(nrows, nb, bsz, m, "rest", plan.sub), nbyte,
                   prec)
    pts = _sample(g, max(1, rows // vt), 29, bp.device)
    idx = (torch.arange(vt, device=bp.device)[:, None] * g
           + pts[None, :]).reshape(-1)
    nbk = min(blocks if prec == "ieee" else mode_blocks, nb)
    geo = w if isinstance(w, ensrf_grid.Geometry) else None
    cut = (ensrf_grid.Geometry(geo.points[:, pts].contiguous(), geo.obs[:nbk])
           if geo is not None else
           None if w is None else w[:nbk][:, :, pts].contiguous(),
           None if table is None else table[:, :nbk].contiguous(),
           y_b[:nbk], ggt_b[:nbk], coef_b[:nbk])
    zc = None if z_b is None else z_b[:nbk]
    if prec == "ieee":
        got = fn(entry, bm[idx], bp[idx], *cut, vt, False, precision=prec,
                 z_b=zc)
        want, p_ms = cuda_timed(lambda: ensrf_grid.grid_apply_plain(
            bm[idx], bp[idx], *cut, vt, z_b=zc))
        torch.cuda.synchronize()
        r = dict(max_abs_err=max(compare(f"{label} mean", got[0], want[0]),
                                 compare(f"{label} perts", got[1], want[1])))
    else:
        launch, plain, nbk = _grid_block_fns(entry, *cut, vt)
        r = hold_mode(label, launch, plain, bm[idx], bp[idx], nbk, prec,
                      operand_faults=False)
        r.pop("out")
        p_ms = r.pop("plain_ms")
    if geo is not None:
        # The whole launch against the one that reads the same weights
        # built in torch.
        wts = ensrf_grid.geometry_weights(*geo)
        read = lambda: fn(entry, bm, bp, wts, table, y_b, ggt_b, coef_b, vt,
                          False, precision=prec, z_b=z_b)
        got, want = full(), read()
        r.update(bitwise_vs_w=bool(torch.equal(got[0], want[0])
                                   and torch.equal(got[1], want[1])),
                 read_ms=_launch_ms(read))
        del got, want, wts
    return dict(r, ms=_launch_ms(full), plain_ms=p_ms,
                shape=f"{vt} x {g} x {m}, {nb} blocks of {bsz}",
                plan=plan._asdict(),
                held=f"{len(idx)} rows x {nbk} blocks", **b)


def _launch_ms(fn) -> float:
    """:func:`cuda_ms` of ``fn``, over 3 runs where one takes under 50 ms
    (else that one)."""
    ms = cuda_ms(fn, 1)
    return cuda_ms(fn, 3) if ms < 50.0 else ms


def _hold_all(label, spy, p) -> dict:
    """:func:`_hold_call` of every launch ``spy`` caught; logs one line a
    kernel.  Returns ``{kind: numbers}``."""
    out = {}
    for kind, call in spy.calls.items():
        r = out[kind] = _hold_call(kind, call, p["hold_rows"],
                                   p["hold_blocks"], p["mode_hold_blocks"])
        log(f"phase 29 {label}: {kind} [{r['shape']}] matches plain "
            f"({r.get('held', 'whole launch')}): err {r['max_abs_err']:.3e} "
            f"kernel {r['ms']:.3f} ms"
            + (f" (weights in the kernel; bit for bit the launch reading "
               f"them from w: {r['bitwise_vs_w']}, which takes "
               f"{r['read_ms']:.3f} ms)" if "read_ms" in r else "")
            + f" plain {r['plain_ms']:.1f} ms bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
            + (f" plan {r['plan']}" if "plan" in r else
               f" cluster {r['cluster']}, slab in "
               f"{'device' if r['device_slab'] else 'shared'} memory"))
    return out


def _wide_api_state(dev, nmems, ny=1024, nobs=2048, seed=1):
    """Phase 4's grid at ``nmems`` members, its field N(280, 5) drawn on
    ``dev`` (``nmems`` x ``ny``^2 normals; the host draws phase 4's 80),
    and the first ``nobs`` of phase 4's obs (:func:`_api_draws`, kept from
    phase 4).  Returns ``(state, batch)``."""
    import torch

    from efa_xray_tpu_torch import EnsembleState
    from efa_xray_tpu_torch.observation.observation import ObservationBatch

    _, coords, full = _api_workload(seed=seed, ny=ny)
    keep = lambda x: np.asarray(x)[:nobs]
    batch = ObservationBatch(
        values=keep(full.values), errors=keep(full.errors),
        lats=keep(full.lats), lons=keep(full.lons),
        times_s=keep(full.times_s), obtypes=list(full.obtypes)[:nobs],
        localize_radius=keep(full.localize_radius),
        assimilate_flags=keep(full.assimilate_flags),
        verts=keep(full.verts), descriptions=[None] * nobs)
    gen = torch.Generator(device=dev).manual_seed(seed)
    field = 280.0 + 5.0 * torch.randn((1, ny, ny, nmems), generator=gen,
                                      device=dev)
    coords = dict(coords, mem=np.arange(nmems))
    return EnsembleState.from_vardict({"T2m": field}, coords,
                                      dtype="float32", device=dev), batch


def _wide_update(label, state, batch, cfg, route, expect, p, plain=None,
                 warm=True):
    """``EnSRF(state, batch, config=cfg).update()`` on ``route`` once with
    every kernel's first launch caught and held (:func:`_hold_all`), its
    launches checked with ``expect``, and the posterior held against the
    plain blocked update (``plain``: :func:`_plain_update`'s tuple, made
    here when None on ``p["plain_rows"]`` of the state's rows; ``False``:
    not held, a mode's update); then, with ``warm``, once more for the
    wall (tail and body split) and the peak memory.  Returns
    ``(posterior mean, numbers)``."""
    import torch

    from efa_xray_tpu_torch import EnSRF

    filt = lambda: EnSRF(state, batch, config=cfg, verbose=False)
    nstate = state.structure.nstate
    check(filt()._route(nstate) == route,
          f"phase 29 {label}: routed to {filt()._route(nstate)}, not {route}")
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _KernelCalls() as spy:
        post, obs = filt().update()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _counts()
    check(expect(counts), f"phase 29 {label}: launches {counts}")
    r = dict(launches={k: v for k, v in counts.items() if v},
             first_wall_s=first,
             peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    t0 = time.perf_counter()
    if plain is not False:
        rows = (None if plain is not None else
                _sample(nstate, p["plain_rows"], 7, state.device))
        r["mean_err"], r["incr_rms"], *inn = _check_api(
            f"phase 29 {label}", state, batch, cfg, post, obs, plain=plain,
            rows=rows)
        r["mean_abs_innov"] = inn
    r["check_s"] = time.perf_counter() - t0
    post_mean = post.to_vect().mean(dim=1)
    del post, obs
    if warm:
        torch.cuda.reset_peak_memory_stats()
        (post, _), wall, spent = _timed_update(filt)
        r.update(warm_wall_s=wall, tail_s=spent["tail"],
                 body_s=spent["body"],
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del post
    t0 = time.perf_counter()
    r["kernels"] = _hold_all(label, spy, p)
    r["holds_s"] = time.perf_counter() - t0
    del spy
    log(f"phase 29 {label}: " + json.dumps(
        {k: v for k, v in r.items() if k != "kernels"}))
    return post_mean, r


def _phase29_api(p) -> dict:
    """Phase 29 (a): ``EnSRF.update()`` at ``p["nmems"]`` members on phase
    4's grid and the first ``p["nobs"]`` of its obs: the default config (B1
    + B4), ``fast_geometry`` (B1 + B2), hybrid (B1h + B2h), and TF32 and
    bf16 on B2 and on B4 (each against the fp32 update of its route at
    phase 26's gate (b))."""
    import dataclasses

    import torch

    from efa_xray_tpu_torch import FilterConfig

    dev = torch.device("cuda")
    state, batch = _wide_api_state(dev, p["nmems"], p["ny"], p["nobs"])
    nobs = batch.nobs
    tail = _tail_counts(nobs, 512, True)
    nblocks = -(-nobs // 128)
    runs = {
        "default (B1 + B4)": (FilterConfig(localization="GC"), "B4",
                              _only(B1=tail["panels"],
                                    B4=nblocks + tail["b4"])),
        "fast_geometry (B1 + B2)": (
            FilterConfig(localization="GC", fast_geometry=True), "B2",
            _only(B1=tail["panels"], B2=None)),
        "hybrid (B1h + B2h)": (
            _hybrid_config(state.structure.nstate, 29), "B2h",
            _only(B1h=tail["panels"], B2h=1)),
    }
    out, means = {}, {}
    prior = state.to_vect().mean(dim=1)
    for label, (cfg, route, expect) in runs.items():
        means[route], out[label] = _wide_update(
            f"(a) {p['nmems']} members {label}", state, batch, cfg, route,
            expect, p)
    for route, base in (("B2", runs["fast_geometry (B1 + B2)"]),
                        ("B4", runs["default (B1 + B4)"])):
        for mode in ("tf32", "bf16"):
            cfg = dataclasses.replace(base[0],
                                      matmul_precision=MODE_SETTING[mode])
            label = f"{route} {mode}"
            mean, r = _wide_update(f"(a) {p['nmems']} members {label}",
                                   state, batch, cfg, route, base[2], p,
                                   plain=False, warm=False)
            r["mean_err_share"] = _rms_share(mean, means[route], prior)
            check(0.0 < r["mean_err_share"] <= API_MODE_GATE[mode],
                  f"phase 29 {label}: posterior mean {r['mean_err_share']:.3e}"
                  f" of the fp32 increment RMS (gate {API_MODE_GATE[mode]};"
                  " 0: the mode took no effect)")
            out[label] = r
    return out


def _phase29_blocks(p) -> dict:
    """Phase 29 (b): phase 4's 80-member workload at each block of
    ``p["blocks"]`` through B2 (``fast_geometry``) and B4 (the default
    config), each held against the plain update at blocks of 128 (the
    blocked update is exact for any block: the same algebra, rounded in
    another order); then config 4's headline body at
    ``p["headline_block"]`` (the JAX package culls no block over 256 obs),
    timed and held on a 20k-row sample."""
    import torch

    from efa_xray_tpu_torch import FilterConfig
    from efa_xray_tpu_torch.ops import ensrf_fused

    dev = torch.device("cuda")
    state, batch = _api_state(dev)
    nobs = batch.nobs
    tail = _tail_counts(nobs, 512, True)
    out = {}
    for route, fast in (("B2", True), ("B4", False)):
        # The plain updates of phases 4 (B2) and 9 (B4), kept.
        cfg128 = (FilterConfig(localization="GC", dtype="float32",
                               fast_geometry=True) if fast else
                  FilterConfig(localization="GC"))
        plain = _plain_kept(("api", 1024, 10_000, 80) if fast else
                            ("api default", 1024, 10_000, 80), state, batch,
                            cfg128)
        for bsz in p["blocks"]:
            cfg = FilterConfig(localization="GC", fast_geometry=fast,
                               block_size=bsz)
            expect = (_only(B1=tail["panels"], B2=None) if fast else
                      _only(B1=tail["panels"],
                            B4=-(-nobs // bsz) + tail["b4"]))
            _, out[f"{route} block {bsz}"] = _wide_update(
                f"(b) 80 members {route} block {bsz}", state, batch, cfg,
                route, expect, p, plain=plain, warm=False)
    del state
    tail_phase, _, w = _headline()
    bsz = p["headline_block"]
    body = lambda t: ensrf_fused.fused_body(
        w["bm"], w["bp"], w["lat"], w["lon"], t, w["obs"], localize=True,
        block_size=bsz, max_radius_km=w["radius"])
    body(tail_phase())  # the new shape's first launches
    torch.cuda.synchronize()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    t = tail_phase()
    ev[1].record()
    bm2, bp2 = body(t)
    ev[2].record()
    ev[2].synchronize()
    counts = _counts()
    check(_only(B1=None, B2=None)(counts),
          f"phase 29 headline: launches {counts}")
    s = _sample(w["nstate"], 20_000, 5, dev)
    ops = ensrf_fused.prepare(w["bp"][s], w["lat"][s], w["lon"][s], t,
                              w["obs"], block_size=bsz,
                              max_radius_km=w["radius"])
    pm, pp = ensrf_fused.fused_apply_plain(
        w["bm"][s], w["bp"][s], ops["geom"], ops["y_b"], ops["ggt_b"],
        ops["tab_b"], None, ops["tile"], True, False, ops["series"])
    err = max(compare("phase 29 headline sample mean", bm2[s], pm),
              compare("phase 29 headline sample perts", bp2[s], pp))
    out["headline"] = dict(
        block=bsz, plan=ensrf_fused.plan(bsz, 80)._asdict(),
        update_s=ev[0].elapsed_time(ev[2]) / 1e3,
        tail_s=ev[0].elapsed_time(ev[1]) / 1e3,
        body_s=ev[1].elapsed_time(ev[2]) / 1e3,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        sample_max_abs_err=err, launches=counts)
    log(f"phase 29 (b) config 4 headline 1e7 x 80 x 10k obs at blocks of "
        f"{bsz}: " + json.dumps(out["headline"]))
    return out


def _phase29_config3(p) -> dict:
    """Phase 29 (c): BASELINE config 3's gridded state at ``p["nmems"]``
    members through phase 8's two configurations (B4 at the defaults, B3
    with ``fast_geometry`` and varloc)."""
    state, batch, names = _config3_workload(**p["c3"])
    nblocks = -(-batch.nobs // 128)
    tail = _tail_counts(batch.nobs, 512, True)
    expects = {"B4": _only(B1=tail["panels"], B4=nblocks + tail["b4"]),
               "B3": _only(B1=tail["panels"], B4=tail["b4"], B3=None)}
    return {route: _wide_update(
        f"(c) config 3 at {p['c3']['nmems']} members {label}", state, batch,
        cfg, route, expects[route], p, warm=False)[1]
        for label, cfg, route in _config3_runs(names)}


def _phase29_enkf(p) -> dict:
    """Phase 29 (d): ``EnKF.update()`` at config 11 with ``p["c11"]``
    (B1e + B2e with ``fast_geometry``; the default config, B1e + B4e):
    launches, no synchronizing call inside the update, held against the
    plain route (its per-ob tail and plain body) with the same draws, each
    kernel's first launch held."""
    import torch

    from efa_xray_tpu_torch import EnKF, FilterConfig
    from efa_xray_tpu_torch.assimilation import enkf as tenkf

    q = dict(CONFIG11, **p["c11"])
    sync = _syncer("cuda")
    state, batch = _half_degree_workload("cuda", **q)
    run = lambda c: (lambda: EnKF(state, batch, config=c, verbose=False,
                                  seed=q["seed"]).update())
    out = {}
    for route, cfg in (
            ("B2", FilterConfig(localization="GC", fast_geometry=True,
                                block_size=q["block"])),
            ("B4", FilterConfig(localization="GC", block_size=q["block"]))):
        real, seen = tenkf.enkf_kernel_update, {}

        def capture(*a, **k):
            seen.setdefault("call", (a, k))
            return real(*a, **k)

        tenkf.enkf_kernel_update = capture
        try:
            _reset_counts()
            with _KernelCalls() as spy:
                (post, obs), first, _ = _spans(run(cfg), [], sync)
            counts = _counts()
        finally:
            tenkf.enkf_kernel_update = real
        check(_enkf_only(q["nobs"], route, block=q["block"])(counts),
              f"phase 29 (d) EnKF {route}: launches {counts}")
        a, k = seen["call"]
        syncs = _sync_free(lambda: real(*a, **k))[1]
        check(not syncs, f"phase 29 (d) EnKF {route}: the update waited on "
              f"the card: {syncs}")
        del a, k, seen
        torch.cuda.reset_peak_memory_stats()
        _, wall, _ = _spans(run(cfg), [], sync)
        peak = torch.cuda.max_memory_allocated() / 1e9
        plain_route = tenkf.enkf_route
        tenkf.enkf_route = lambda *a: "plain"
        try:
            (post_p, _), wall_p, _ = _spans(run(cfg), [], sync)
        finally:
            tenkf.enkf_route = plain_route
        r = out[f"EnKF {route}"] = dict(
            launches={n: v for n, v in counts.items() if v},
            first_wall_s=first, warm_wall_s=wall, plain_s=wall_p,
            peak_gb=peak, syncs_in_update=len(syncs),
            kernel_vs_plain=_posterior_gap(
                f"phase 29 (d) EnKF {route} vs the plain route", post,
                post_p, state),
            mean_abs_innov=_innovations(f"phase 29 (d) EnKF {route}", batch,
                                        obs, var_shrinks=False))
        del post, post_p
        log(f"phase 29 (d) EnKF config 11 at {q['nmems']} members, route "
            f"{route}: " + json.dumps(r))
        r["kernels"] = _hold_all(f"(d) EnKF {route}", spy, p)
    return out


@contextlib.contextmanager
def _letkf_plain_route():
    """The LETKF's chunk solve with LG's and NS's plain versions (the
    weights and Grams in torch, the Newton-Schulz loop that reads each
    error back, then the two products) in place of the kernels."""
    import math

    from efa_xray_tpu_torch.assimilation import letkf_core as tl
    from efa_xray_tpu_torch.ops import letkf_gram

    real_lg, real_ns = letkf_gram.local_gram, tl._newton_schulz_weights

    def lg_plain(*a, table=None, amat=None, b=None, **kw):
        return letkf_gram.local_gram_plain(*a, **kw)

    def ns_plain(amat, b, iters, **_):
        inv_sqrt, inv = tl._invsqrt_newton_schulz_plain(amat, iters)[:2]
        m = amat.shape[-1]
        return (inv @ b[..., None])[..., 0], math.sqrt(m - 1) * inv_sqrt

    letkf_gram.local_gram, tl._newton_schulz_weights = lg_plain, ns_plain
    try:
        yield
    finally:
        letkf_gram.local_gram, tl._newton_schulz_weights = real_lg, real_ns


def _phase29_letkf(p) -> dict:
    """Phase 29 (e): ``LETKF.update()`` at ``p["c6"]`` members on a region
    of config 6's half-degree grid (its obs, patches, k and chunks): LG and
    NS once a chunk, no synchronizing call inside the analysis, held
    against the plain route; LG and NS held against their plain versions
    on the first chunk."""
    import torch

    from efa_xray_tpu_torch import FilterConfig, LETKF
    from efa_xray_tpu_torch.assimilation import letkf_core as tl

    q = dict(CONFIG6, **p["c6"])
    sync = _syncer("cuda")
    state, batch = _half_degree_workload("cuda", **q)
    cfg = FilterConfig(localization="GC", letkf_patch_size=q["patch"],
                       letkf_k_obs=q["k"], letkf_chunk=q["chunk"])
    run = lambda: LETKF(state, batch, config=cfg).update()
    real, seen = tl.letkf_update, {}

    def capture(*a, **k):
        seen.setdefault("call", (a, k))
        return real(*a, **k)

    first, lg_first = [], []

    def run_lg():
        out, calls = _lg_calls(run, lambda i, a: i == 0)
        lg_first[:] = calls
        return out

    tl.letkf_update = capture
    try:
        _reset_counts()
        tl.reset_counts()
        (_, first_s, _) = _spans(lambda: _first_ns_input(run_lg, first), [],
                                 sync)
        counts, ns = _counts(), tl.ns_counts()
    finally:
        tl.letkf_update = real
    chunks = ns["calls"]
    check(chunks >= 1 and _only(NS=chunks, LG=chunks)(counts),
          f"phase 29 (e) LETKF: launches {counts} ({chunks} chunks)")
    a, k = seen.pop("call")
    syncs = _sync_free(lambda: real(*a, **k))[1]
    check(not syncs, f"phase 29 (e) LETKF: the analysis waited on the card: "
          f"{syncs}")
    del a, k
    torch.cuda.reset_peak_memory_stats()
    (post, obs), wall, _ = _spans(run, [], sync)
    peak = torch.cuda.max_memory_allocated() / 1e9
    with _letkf_plain_route():
        (post_p, _), wall_p, _ = _spans(run, [], sync)
    r = dict(grid=f"{q['ny']} x {q['nx']} at 0.5 degrees (a region: depth "
             f"cut of config 6's 361 x 720)", nmems=q["nmems"],
             nobs=q["nobs"], chunks=chunks, launches={
                 n: v for n, v in counts.items() if v},
             ns_per_chunk=ns["iterations"] / max(chunks, 1),
             first_wall_s=first_s, warm_wall_s=wall, plain_s=wall_p,
             peak_gb=peak, syncs_in_update=len(syncs),
             kernel_vs_plain=_posterior_gap(
                 "phase 29 (e) LETKF vs the plain route", post, post_p,
                 state),
             mean_abs_innov=_innovations("phase 29 (e) LETKF", batch, obs))
    del post, post_p
    log(f"phase 29 (e) LETKF: " + json.dumps(r))
    # NS's launch at 512 members takes ~0.2 s: one a run.
    r["kernels"] = dict(NS=_ns_hold(f"{q['nmems']} members, first chunk",
                                    *first[1], inner=1),
                        LG=_lg_hold(f"{q['nmems']} members, first chunk",
                                    *lg_first[0]))
    return r


# The kernels line's entries of phase 29: (name, held kernel, phase 29's
# part and run, source, TPU kernel).
FUSED_CU = "efa_xray_tpu_torch/csrc/ensrf_fused.cu"
GRID_CU = "efa_xray_tpu_torch/csrc/ensrf_grid.cu"
TAIL_CU = "efa_xray_tpu_torch/csrc/tail_solve.cu"
WIDE_KERNELS = (
    ("B1 tail panel solve (512 members)", "B1", "api",
     "default (B1 + B4)", TAIL_CU, "efa_xray_tpu/ops/tail_solve_pallas.py:46"),
    ("B1h tail panel solve, hybrid (512 members)", "B1h", "api",
     "hybrid (B1h + B2h)", TAIL_CU,
     "efa_xray_tpu/ops/tail_solve_pallas.py:46"),
    ("B1e tail panel solve, EnKF (config 11, 512 members)", "B1e", "enkf",
     "EnKF B2", TAIL_CU, "efa_xray_tpu/ops/tail_solve_pallas.py:46"),
    ("B2 fused body (512 members)", "B2", "api", "fast_geometry (B1 + B2)",
     FUSED_CU, "efa_xray_tpu/ops/ensrf_pallas_fused.py:117"),
    ("B2 fused body (tf32 products, 512 members)", "B2 tf32", "api",
     "B2 tf32", FUSED_CU, "efa_xray_tpu/ops/ensrf_pallas_fused.py:117"),
    ("B2 fused body (bf16 products, 512 members)", "B2 bf16", "api",
     "B2 bf16", FUSED_CU, "efa_xray_tpu/ops/ensrf_pallas_fused.py:117"),
    ("B2 fused body (80 members, blocks of 1024)", "B2", "blocks",
     "B2 block 1024", FUSED_CU, "efa_xray_tpu/ops/ensrf_pallas_fused.py:117"),
    ("B2h fused body, hybrid (512 members)", "B2h", "api",
     "hybrid (B1h + B2h)", FUSED_CU,
     "efa_xray_tpu/ops/ensrf_pallas_fused.py:208"),
    ("B2e fused body, EnKF (config 11, 512 members)", "B2e", "enkf",
     "EnKF B2", FUSED_CU, "efa_xray_tpu/ops/ensrf_pallas_fused.py:117"),
    ("B3 grid body (config 3, 512 members)", "B3", "config3", "B3", GRID_CU,
     "efa_xray_tpu/ops/ensrf_pallas_fused.py:784"),
    ("B4 block apply (512 members)", "B4", "api", "default (B1 + B4)",
     GRID_CU, "efa_xray_tpu/ops/ensrf_pallas.py:68"),
    ("B4 block apply (tf32 products, 512 members)", "B4 tf32", "api",
     "B4 tf32", GRID_CU, "efa_xray_tpu/ops/ensrf_pallas.py:68"),
    ("B4 block apply (bf16 products, 512 members)", "B4 bf16", "api",
     "B4 bf16", GRID_CU, "efa_xray_tpu/ops/ensrf_pallas.py:68"),
    ("B4 block apply (80 members, blocks of 1024)", "B4", "blocks",
     "B4 block 1024", GRID_CU, "efa_xray_tpu/ops/ensrf_pallas.py:68"),
    ("B4e block apply, EnKF (config 11, 512 members)", "B4e", "enkf",
     "EnKF B4", GRID_CU, "efa_xray_tpu/ops/ensrf_pallas.py:68"),
)


def _wide_rows(wide) -> list:
    """The kernels line's entries of phase 29's results ``wide``: each
    kernel's held launch with the most rows (the body's, not a tail's
    out-of-panel apply) and its run's launches, NS and LG on the LETKF's
    first chunk."""
    rows = []
    for name, kind, part, run, source, replaces in WIDE_KERNELS:
        r = wide[part][run]
        held = [v for k, v in r["kernels"].items()
                if k.rsplit(" (", 1)[0] == kind]
        check(bool(held), f"phase 29 {run}: no {kind} launch was held")
        best = max(held, key=lambda v: v["bound_ms"])
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces,
                         launches=r["launches"][kind.split()[0]],
                         library_ms=None,
                         **{k: best[k] for k in NS_KEYS}))
    letkf = wide["letkf"]
    for name, source, replaces in (
            ("NS", "efa_xray_tpu_torch/csrc/newton_schulz.cu",
             "efa_xray_tpu/assimilation/letkf_core.py:406"),
            ("LG", "efa_xray_tpu_torch/csrc/letkf_gram.cu",
             "efa_xray_tpu/assimilation/letkf_core.py:592")):
        rows.append(dict(name=f"{name} (512 members, LETKF first chunk)",
                         route="cuda", source=source, replaces=replaces,
                         launches=letkf["launches"][name], library_ms=None,
                         **{k: letkf["kernels"][name][k] for k in NS_KEYS}))
    return rows


def phase29(**cut):
    """Any ensemble and any block on the card (fault C5 of ROADMAP queue
    C): (a) ``EnSRF.update()`` at 512 members on phase 4's grid and the
    first 2,048 of its obs through B1 + B4, B1 + B2, B1h + B2h and TF32 /
    bf16 on B2 and B4; (b) phase 4's workload at 80 members at blocks of
    256, 512 and 1024 through B2 and B4, and config 4's headline at
    blocks of 512; (c) config 3 at 512 members (2,000 obs) through B4 and
    B3 + varloc; (d) the EnKF at config 11 with 512 members (B1e + B2e,
    B1e + B4e); (e) the LETKF at 512 members on a region of config 6's
    grid.  Every update: its launches, held against the plain route (on
    sampled rows; a mode's against the fp32 update), each kernel's first
    launch at each row count against its plain version on its own
    operands, its walls (a warm second run for (a)'s three routes, (d) and
    (e); the first run, after the earlier phases' warm-up, elsewhere) and
    peak memory.  ``cut`` overrides :data:`PHASE29`.  Returns the
    numbers."""
    p = dict(PHASE29, **cut)
    out = {}
    for key, part in (("api", _phase29_api), ("blocks", _phase29_blocks),
                      ("config3", _phase29_config3),
                      ("enkf", _phase29_enkf), ("letkf", _phase29_letkf)):
        t0 = time.perf_counter()
        out[key] = part(p)
        log(f"phase 29 {key} took {time.perf_counter() - t0:.1f} s")
    return out


def _library_mm_ms(a, b, mode: str) -> float:
    """Milliseconds of the ``torch.matmul`` that computes what P's mode
    ``mode`` does: float32 with TF32 off ("ieee") or on ("tf32"), or on
    bf16 inputs with a bf16 result ("bf16").  The TF32 switch is restored
    afterwards."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
        if mode == "bf16":
            return cuda_ms(lambda: torch.matmul(a.bfloat16(), b.bfloat16()),
                           5, P_INNER)
        return cuda_ms(lambda: torch.matmul(a, b), 5, P_INNER)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def phase12():
    """P: ``probe()`` on the card, each mode against its plain version at
    512^2, at a non-square size, at 1024^2 and at a size whose 187 tiles of
    128 x 128 fill the card, so that the ieee 128 x 128 kernel and the
    two-warpgroup wgmma kernel that 4096^3 times are checked as well (with
    ragged edges, and at a k short enough for the tolerance to hold), the
    tf32 mode against the product of inputs rounded to nearest (and not of
    truncated ones), and the library product beside it at 1024^3 and
    4096^3."""
    import torch

    from efa_xray_tpu_torch.ops import precision_probe as pp
    from efa_xray_tpu_torch.ops.precision import round_tf32

    dev = torch.device("cuda")
    _reset_counts()
    res = pp.probe(n=512, k=512, time_n=1024, device=dev)
    torch.cuda.synchronize()
    launched = dict(pp.launches_by_mode)
    counts = _counts()
    check(_only(P=None)(counts) and all(v >= 1 for v in launched.values()),
          f"phase 12: launches {counts}, P by mode {launched}")
    errs = [res[f"{mode}_rms_err_over_scale"] for mode in pp.MODES]
    check(errs[0] < 1e-6 < errs[1] < errs[2] < 1e-2,
          f"phase 12: rms errors over scale {errs} are not ieee < tf32 < "
          "bf16 as the roundings predict")
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(121)
    rand = lambda *shape: torch.randn(*shape, generator=gen, device=dev,
                                      dtype=f32)
    peak = {"ieee": "fp32", "tf32": "tf32", "bf16": "bf16"}
    out = {mode: dict(max_abs_err=0.0) for mode in pp.MODES}
    # A wrong swizzle or transpose cannot cancel out at a non-square size.
    for n, k, m in ((512, 512, 512), (528, 144, 272), (1024, 1024, 1024),
                    (2064, 144, 1296)):
        a, b = rand(n, k), rand(k, m)
        for mode in pp.MODES:
            got = pp.mm(a, b, mode)
            out[mode]["max_abs_err"] = max(
                out[mode]["max_abs_err"],
                compare(f"P {mode} [{n}, {k}] @ [{k}, {m}]", got,
                        pp.mm_plain(a, b, mode)))
            if mode == "tf32":
                # cvt.rna, not the truncation wgmma applies to raw fp32
                # bits: the kernel sits nearer the product of inputs
                # rounded to nearest than that of truncated inputs.
                chop = lambda x: (x.view(torch.int32) & ~0x1FFF).view(f32)
                near = float((got - round_tf32(a) @ round_tf32(b))
                             .abs().max())
                far = float((got - chop(a) @ chop(b)).abs().max())
                check(near < 0.1 * far,
                      f"phase 12: tf32 at [{n}, {k}] @ [{k}, {m}] is "
                      f"{near:.3e} from the rna-rounded product and "
                      f"{far:.3e} from the truncated one")
    for size in (1024, 4096):
        a, b = rand(size, size), rand(size, size)
        for mode in pp.MODES:
            pp.mm(a, b, mode)  # warm-up
            t = dict(ms=cuda_ms(lambda: pp.mm(a, b, mode), 5, P_INNER),
                     plain_ms=cuda_ms(lambda: pp.mm_plain(a, b, mode), 5,
                                      P_INNER),
                     library_ms=_library_mm_ms(a, b, mode),
                     **bound(2.0 * size ** 3, nbytes(a, b) + size * size * 4,
                             peak[mode]))
            if size == 1024:
                out[mode].update(launches=launched[mode], **t)
            else:
                out[mode].update({f"{key}_{size}": v for key, v in t.items()})
        del a, b
    log(f"phase 12: P probe on {res['device']}: " + "; ".join(
        f"{mode}: rms err / scale {res[f'{mode}_rms_err_over_scale']:.3e}, "
        f"kernel vs plain max abs err {o['max_abs_err']:.3e} (512^2, "
        f"[528, 144] @ [144, 272], 1024^2, [2064, 144] @ [144, 1296]), 1024^3 "
        f"kernel "
        f"{o['ms']:.4f} ms plain {o['plain_ms']:.4f} ms torch.matmul "
        f"{o['library_ms']:.4f} ms bound {o['bound_ms']:.4f} ms "
        f"({o['bound_by']}), 4096^3 kernel {o['ms_4096']:.4f} ms plain "
        f"{o['plain_ms_4096']:.4f} ms torch.matmul "
        f"{o['library_ms_4096']:.4f} ms bound {o['bound_ms_4096']:.4f} ms "
        f"({o['bound_by_4096']})" for mode, o in out.items())
        + "; bitwise equal: " + ", ".join(
            f"{k[:-len('_bitwise')]} {v}" for k, v in res.items()
            if k.endswith("_bitwise")))
    return out


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
    busy_us = _union_us(spans)
    check(busy_us > 0, f"profile {label}: no device time was traced")
    log(f"profile {label}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms, busy share {busy_us / 1e3 / wall_ms:.3f}")
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:top]
    for name, (n, us) in ranked:
        log(f"  {us / 1e3:10.3f} ms {n:5d}x  {name[:100]}")


def profile_phase():
    """Where the time goes: one warm headline update, the warm API update
    of phase 4 and the hybrid one of phase 11 (a), and the two config-3
    updates of phase 8 under ``torch.profiler``, and the headline's cull
    shares."""
    import torch

    from efa_xray_tpu_torch import EnSRF, FilterConfig
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

    state, batch = _api_state(torch.device("cuda"))
    cfg = FilterConfig(localization="GC", dtype="float32", fast_geometry=True)
    _profiled("API EnSRF.update() (1024 x 1024 x 80, 10k obs)",
              lambda: EnSRF(state, batch, config=cfg, verbose=False,
                            device="cuda").update())
    hybrid = _hybrid_config(state.structure.nstate, 111)
    _profiled("API hybrid EnSRF.update() (1024 x 1024 x 80, 10k obs, B2h)",
              lambda: EnSRF(state, batch, config=hybrid,
                            verbose=False).update())
    del state, batch
    state, batch, names = _config3_workload()
    for label, cfg, route in _config3_runs(names):
        _profiled(f"config 3 EnSRF.update() {label} ({route})",
                  lambda: EnSRF(state, batch, config=cfg,
                                verbose=False).update())


def _b2_variants(label, bm, bp, lat, lon, tail, obs, radius, reps):
    """Times B2 on one workload with parts of its design switched off or
    chosen otherwise; each variant must give the kernel's own result.
    ``no skip``: every panel of an alive block is marked alive (dead panels
    then solve to exact zeros instead of being skipped); ``tile 64``: one
    CTA of 64 rows per SM."""
    import torch

    from efa_xray_tpu_torch.observation.localization import latlon_to_unit
    from efa_xray_tpu_torch.ops import ensrf_fused

    ops = ensrf_fused.prepare(bp, lat, lon, tail, obs, block_size=128,
                              cull=True, max_radius_km=radius)
    nblocks, bsz, nmems = ops["y_b"].shape
    npanels = -(-bsz // ensrf_fused.PANEL)
    check(ops["tile"] == 32,
          f"steps {label}: the kernel's tile is {ops['tile']}")
    bits = {32: ops["bits"], 64: ensrf_fused.cull_bits(
        latlon_to_unit(lat, lon).to(bp.dtype),
        latlon_to_unit(obs.lats, obs.lons).to(bp.dtype), obs.radii, obs.assim,
        64, nblocks, bsz)}
    full = {t: torch.where(b != 0, torch.full_like(b, (1 << npanels) - 1),
                           torch.zeros_like(b)) for t, b in bits.items()}

    def run(b, tile):
        return ensrf_fused.fused_apply_cuda(
            bm, bp, ops["geom"], ops["y_b"], ops["ggt_b"], ops["tab_b"], b,
            tile, True, False, ops["series"])

    want = run(bits[32], 32)
    out = []
    for name, b, tile in (
            ("tile 64, no skip", full[64], 64),
            ("tile 64, skip", bits[64], 64),
            ("tile 32 (2 CTAs per SM), no skip", full[32], 32),
            ("tile 32, skip (the kernel)", bits[32], 32)):
        got = run(b, tile)
        torch.cuda.synchronize()
        compare(f"steps {label} {name} mean", got[0], want[0])
        compare(f"steps {label} {name} perts", got[1], want[1])
        del got
        out.append((name, cuda_ms(lambda: run(b, tile), reps)))
    shares = []
    for t, b in bits.items():
        panels = sum(int(((b.to(torch.int64) >> q) & 1).sum())
                     for q in range(npanels))
        shares.append(f"tile {t}: alive tile-blocks "
                      f"{float((b != 0).double().mean()):.4f}, alive panels "
                      f"{panels / (b.numel() * npanels):.4f}")
    log(f"steps {label}: " + "; ".join(shares) + "; "
        + "; ".join(f"{name}: {ms:.2f} ms" for name, ms in out))


# Where --steps looks for the parent commit's grid kernel (see the module
# docstring): inside the git-ignored build directory.
PARENT_GRID_SOURCE = os.path.join("build", "efa_xray_tpu_torch", "parent",
                                  "ensrf_grid.cu")
# The tile the parent's wrapper gave its kernel (64 points wherever they
# fit its shared memory, as at every shape timed here).
PARENT_GRID_TILE = 64


def _with_lib(lib, fn):
    """``fn()`` with ``lib`` as the kernel library the wrappers call."""
    from efa_xray_tpu_torch.ops import _build

    saved = _build.lib
    _build.lib = lambda: lib
    try:
        return fn()
    finally:
        _build.lib = saved


# The C entries of the parent commit's B1, B2 and B3/B4 (the sources of
# before the one-entry launches), bound only where --steps times them.
_P_, _I_, _F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_ENTRIES = {
    "efa_tail_solve": [_P_] * 8 + [_F_] + [_I_] * 5 + [_P_] * 12,
    "efa_tail_solve_enkf": [_P_] * 7 + [_I_] * 4 + [_P_] * 11,
    "efa_fused_body": [_P_] * 7 + [_I_] * 10 + [_P_] * 3,
    "efa_fused_body_enkf": [_P_] * 8 + [_I_] * 8 + [_P_] * 3,
    "efa_grid_body": [_P_] * 7 + [_I_] * 7 + [_P_] * 3,
    "efa_block_apply_enkf": [_P_] * 8 + [_I_] * 5 + [_P_] * 3,
}


class _ParentEntries:
    """A library built from the parent commit's source, seen through this
    source's entries (``efa_tail_launch``, ``efa_fused_launch``,
    ``efa_grid_launch``) at the shapes it took: the slab in the cluster,
    every member at once.  Its grid entry takes the product mode where
    its ``efa_grid_abi`` is 1 (0: a source from before the modes)."""

    def __init__(self, lib):
        self.lib = lib
        abi = lib.efa_grid_abi() if hasattr(lib, "efa_grid_abi") else 0
        check(abi in (0, 1), f"steps: the parent's grid ABI is {abi}")
        self.grid_mode = abi == 1
        for name, argtypes in PARENT_ENTRIES.items():
            if hasattr(lib, name):
                if name == "efa_grid_body" and not self.grid_mode:
                    argtypes = argtypes[:-4] + argtypes[-3:]
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def efa_tail_launch(self, tm, tp, vals, errs, assim, w, gc, sig, eps,
                        ring, alpha, p, m, unbiased, sub, cluster, *outs):
        (tm_o, tp_o, ye_o, z_o, gain_o, sqrt_o, pm_o, pv_o, om_o, ov_o,
         sg_o, ss_o, stream) = outs
        check(ring is None, "steps: the parent's B1 holds its slab in the "
              "cluster")
        if eps is None:
            return self.lib.efa_tail_solve(
                tm, tp, vals, errs, assim, w, gc, sig, alpha, p, m, unbiased,
                sub, cluster, tm_o, tp_o, ye_o, gain_o, sqrt_o, pm_o, pv_o,
                om_o, ov_o, sg_o, ss_o, stream)
        return self.lib.efa_tail_solve_enkf(
            tm, tp, vals, errs, assim, w, eps, p, m, unbiased, cluster, tm_o,
            tp_o, ye_o, z_o, gain_o, sqrt_o, pm_o, pv_o, om_o, ov_o, stream)

    def efa_fused_launch(self, bm, bp, geom, y, z, ggt, tab, bits, n, m, ms,
                         b, nb, t, loc, vert, series, hybrid, mode, *outs):
        check(ms == m, "steps: the parent's B2 stages every member")
        if z is None:
            return self.lib.efa_fused_body(bm, bp, geom, y, ggt, tab, bits, n,
                                           m, b, nb, t, loc, vert, series,
                                           hybrid, mode, *outs)
        return self.lib.efa_fused_body_enkf(bm, bp, geom, y, z, ggt, tab,
                                            bits, n, m, b, nb, t, loc, vert,
                                            series, *outs)

    def efa_grid_launch(self, bm, bp, w, table, y, z, ggt, coef, pg, og, vt,
                        g, m, ms, b, nb, t, mode, *outs):
        check(pg is None and og is None,
              "steps: the parent's grid kernel reads its weights from w")
        check(ms == m and (mode == 0 or self.grid_mode),
              "steps: the parent's grid kernel stages every member (and "
              "takes a mode from ABI 1 on)")
        if z is not None:
            check(nb == 1, "steps: the parent's B4e takes one block")
            return self.lib.efa_block_apply_enkf(bm, bp, w, table, y, z, ggt,
                                                 coef, vt, g, m, b, t, *outs)
        return self.lib.efa_grid_body(
            bm, bp, w, table, y, ggt, coef, vt, g, m, b, nb, t,
            *((mode,) if self.grid_mode else ()), *outs)


# Parts of the grid kernel that a build with -DEFA_GRID_SKIP=<bits> leaves
# out (csrc/ensrf_grid.cu), so that --steps can time what each costs.
GRID_PARTS = {"the in-panel chain": 1, "the trailing update": 2,
              "chain and update": 3, "the whole panel loop": 16, "D0": 4,
              "the apply": 8, "all but loads, stores and fetches": 28}


def _grid_libs():
    """Builds of the grid kernel beside the port's own
    (:func:`_build_variants`): one per entry of ``GRID_PARTS`` and, under
    the name "parent", the source at ``PARENT_GRID_SOURCE`` where that
    file exists (:class:`_ParentEntries`).  Returns ``{name: library}``."""
    from efa_xray_tpu_torch.ops import _build

    root = os.path.dirname(os.path.abspath(__file__))
    own = str(_build.CSRC / "ensrf_grid.cu")
    specs = {name: (own, [f"-DEFA_GRID_SKIP={bits}"])
             for name, bits in GRID_PARTS.items()}
    if os.path.exists(os.path.join(root, PARENT_GRID_SOURCE)):
        specs["parent"] = (os.path.join(root, PARENT_GRID_SOURCE), [])
    else:
        log(f"steps: no {PARENT_GRID_SOURCE}; the parent's kernel is not "
            "compared")
    libs = _build_variants(specs, "libgrid")
    if "parent" in libs:
        libs["parent"] = _ParentEntries(libs["parent"])
    return libs


def _grid_variants(label, entry, libs, bm, bp, w, table, y_b, ggt_b, coef_b,
                   vt, reps):
    """Times the grid kernel through ``entry`` ("B3" or "B4") at each tile
    the wrapper could give it, with the CTAs per SM the card holds, and the
    parent commit's kernel (``libs["parent"]``, where built) on the same
    operands; each must give the result at the wrapper's own tile.  Then
    the kernel at the wrapper's tile with parts left out (``GRID_PARTS``;
    wrong results, timed only)."""
    import torch

    from efa_xray_tpu_torch.ops import ensrf_grid

    _, bsz, nmems = y_b.shape
    ops = (w, table, y_b, ggt_b, coef_b)

    def run(tile):
        return ensrf_grid.grid_apply_cuda(entry, bm, bp, *ops, vt, tile=tile)

    want = run(None)
    out = []
    runs = [(f"tile {t} ({ensrf_grid.ctas_per_sm_on_card(t, bsz, nmems)} "
             f"CTAs per SM)", lambda t=t: run(t)) for t in (32, 64)
            if ensrf_grid.ctas_per_sm(t, bsz, nmems) >= 1]
    if "parent" in libs:
        runs.append((f"the parent's kernel (tile {PARENT_GRID_TILE})",
                     lambda: _with_lib(libs["parent"],
                                       lambda: run(PARENT_GRID_TILE))))
    for name, fn in runs + runs[::-1]:
        got = fn()
        torch.cuda.synchronize()
        compare(f"steps {label} {name} mean", got[0], want[0])
        compare(f"steps {label} {name} perts", got[1], want[1])
        del got
        out.append((name, cuda_ms(fn, reps)))
    tile = ensrf_grid.pick_tile(bsz, nmems)
    log(f"steps {label} ({entry}, the wrapper takes tile {tile}): "
        + "; ".join(f"{name}: {ms:.3f} ms" for name, ms in out))
    whole = cuda_ms(lambda: run(None), reps)
    parts = [(name, _with_lib(libs[name],
                              lambda: cuda_ms(lambda: run(tile), reps)))
             for name in GRID_PARTS]
    log(f"steps {label} ({entry}) at tile {tile}, {whole:.3f} ms whole; "
        "without " + "; without ".join(
            f"{name}: {ms:.3f} ms" for name, ms in parts))


def grid_steps_phase():
    """The grid kernel at each tile, the parent commit's kernel beside it,
    and the kernel with parts left out: B3 at config 3's shape and at 80
    members, B4 at phase 7's two shapes."""
    import torch

    from efa_xray_tpu_torch.observation.localization import latlon_to_unit
    from efa_xray_tpu_torch.ops import ensrf_grid

    libs = _grid_libs()
    bsz = 128
    for label, dims, b4_only in (
            ("config 3 (80 groups x 16,200 x 30, 5,000 obs)",
             dict(ny=90, nx=180, vt=80, nmems=30, nobs=5000, seed=61,
                  group_levels=np.tile(C3_LEVELS, 4)), False),
            ("80 members, 45x90 grid, 20 groups, 1,000 obs",
             dict(ny=45, nx=90, vt=20, nmems=80, nobs=1000, seed=62), False),
            ("1024x1024 x 80 members (vt 1), one block",
             dict(ny=1024, nx=1024, vt=1, nmems=80, nobs=512, seed=72),
             True)):
        c = _grid_case(**dims)
        vertical = dims["vt"] > 1
        ops = ensrf_grid.grid_prepare(
            c["bp"], c["body_vert"], c["tail"], c["obs"], c["ngrid"],
            block_size=bsz, vertical=vertical,
            group_factor=c["gf"] if vertical else None)
        nblocks = 1 if b4_only else ops["y_b"].shape[0]
        sl = slice(0, nblocks * bsz)
        w = ensrf_grid.grid_weights(
            latlon_to_unit(c["lat"], c["lon"]), ops["ob_xyz"][sl],
            ops["radii"][sl]).reshape(nblocks, bsz, c["ngrid"])
        table = ops["table"]
        if not b4_only:
            _grid_variants(label, "B3", libs, c["bm"], c["bp"], w, table,
                           ops["y_b"], ops["ggt_b"], ops["coef_b"],
                           ops["vt"], 3)
        _grid_variants(label + ", first block", "B4", libs, c["bm"],
                       c["bp"], w[:1],
                       None if table is None else table[:, :1].contiguous(),
                       ops["y_b"][:1], ops["ggt_b"][:1], ops["coef_b"][:1],
                       ops["vt"], 5)
        del c, ops, w, table


# Where --steps looks for the parent commit's B1 (see the module
# docstring), and that kernel's C signature.
PARENT_TAIL_SOURCE = os.path.join("build", "efa_xray_tpu_torch", "parent",
                                  "tail_solve.cu")


def _parent_tail_lib():
    """The parent commit's B1 built from ``PARENT_TAIL_SOURCE``
    (:class:`_ParentEntries`), or None where that file does not exist."""
    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, PARENT_TAIL_SOURCE)
    if not os.path.exists(src):
        log(f"steps: no {PARENT_TAIL_SOURCE}; the parent's B1 is not timed")
        return None
    return _ParentEntries(_build_variants({"parent": (src, [])},
                                          "libtail_parent")["parent"])


# Parts of B1 that a build with -DEFA_TAIL_SKIP=<bits> leaves out
# (csrc/tail_solve.cu), so that --steps can time what each costs.
TAIL_PARTS = {"the warp's serial steps": 1, "the Gram pass": 2,
              "the push into the cluster": 4, "the rank updates": 8,
              "all but loads, stores, copies and barriers": 15}


def _tail_part_libs():
    """Builds of B1 with each entry of ``TAIL_PARTS`` left out, and one
    with sub-panels of 16 (``"sub 16"``), by :func:`_build_variants`.
    Returns ``{name: library}``."""
    from efa_xray_tpu_torch.ops import _build

    src = str(_build.CSRC / "tail_solve.cu")
    specs = {name: (src, [f"-DEFA_TAIL_SKIP={bits}"])
             for name, bits in TAIL_PARTS.items()}
    specs["sub 16"] = (src, ["-DEFA_TAIL_SUB16=1"])
    return _build_variants(specs, "libtail")


def b1_steps_phase():
    """B1 at sub-panels of 8 and 16 on one CTA and on each cluster that
    holds the panel, and the parent commit's kernel where built, each held
    against the serial plain version (512 x 80 localized, and 1024 x
    256); then at 512 x 80 on one CTA and on 8 with parts left out
    (``TAIL_PARTS``; wrong results, timed only)."""
    import torch

    from efa_xray_tpu_torch.ops import tail_solve

    parent = _parent_tail_lib()
    parts = _tail_part_libs()
    sub16 = parts.pop("sub 16")

    for label, p, m in (("512 x 80 chordal", 512, 80),
                        ("1024 x 256 chordal", 1024, 256)):
        args, _ = _b1_case(p, m, "chordal", False, False, False, 0.9, 201)
        want = tail_solve.tail_panel_solve_plain(*args)
        runs = []
        for sub in tail_solve.SUBS:
            for c in tail_solve.CLUSTERS:
                pp = tail_solve.padded_panel(p, sub, c)
                if (tail_solve.smem_bytes(pp // c, m, sub)
                        <= tail_solve.MAX_SMEM_BYTES):
                    run = (lambda sub=sub, c=c: tail_solve
                           .tail_panel_solve_cuda(*args, sub=sub, cluster=c))
                    if sub != tail_solve.DEFAULT_SUB:
                        run = lambda run=run: _with_lib(sub16, run)
                    runs.append((f"sub {sub}, {c} CTA{'s' if c > 1 else ''}",
                                 run))
        # The parent's kernel took up to 256 members, its slab in the
        # cluster.
        if parent is not None and m <= 256:
            runs.append(("the parent's kernel", lambda: _with_lib(
                parent, lambda: tail_solve.tail_panel_solve_cuda(*args))))
        out = []
        for name, fn in runs + runs[::-1]:
            got = fn()
            torch.cuda.synchronize()
            for k, (a, b) in enumerate(zip(got, want)):
                compare(f"steps B1 {label} {name} out{k}", a, b)
            out.append((name, cuda_ms(fn, 10)))
        log(f"steps B1 {label} (the wrapper takes sub "
            f"{tail_solve.DEFAULT_SUB}, {tail_solve.pick_cluster(p, m)} "
            "CTAs): " + "; ".join(f"{name}: {ms:.3f} ms" for name, ms in out))
        if p == 512:
            for c in (1, 8):
                run = lambda c=c: tail_solve.tail_panel_solve_cuda(
                    *args, cluster=c)
                whole = cuda_ms(run, 10)
                timed_parts = [
                    (name, _with_lib(lib, lambda: cuda_ms(run, 10)))
                    for name, lib in parts.items()]
                log(f"steps B1 {label} at sub {tail_solve.DEFAULT_SUB}, {c} "
                    f"CTA{'s' if c > 1 else ''}: {whole:.3f} ms whole; "
                    "without " + "; without ".join(
                        f"{name}: {ms:.3f} ms" for name, ms in timed_parts))
        del args, want


# Where --steps looks for the parent commit's B2 (see the module
# docstring; its mma_modes.cuh beside it), and the parts of the
# tensor-core modes that builds with -DEFA_FUSED_SKIP / -DEFA_GRID_SKIP
# leave out (csrc/ensrf_fused.cu, csrc/ensrf_grid.cu): (B2's bits, the
# grid kernel's bits); ("probe", bits): -DEFA_MMA_PROBE in both
# (csrc/mma_modes.cuh: the mma instructions, the fragment loads).
PARENT_FUSED_SOURCE = os.path.join("build", "efa_xray_tpu_torch", "parent",
                                   "ensrf_fused.cu")
MODE_PARTS = {"the rounding of L": (4, 32), "D0": (1, 4), "the apply": (2, 8),
              "both products": (3, 12), "products and rounding": (7, 44),
              "the mma instructions": ("probe", 1),
              "the fragment loads": ("probe", 2)}
# The fp32 instantiations, whose code the modes' redesign leaves as it was.
IEEE_KERNELS = {"ensrf_fused.cu": ("fused_body_kernelILb0ELi0E",
                                   "fused_body_kernelILb1ELi0E"),
                "ensrf_grid.cu": ("grid_body_kernelILi2ELi0E",
                                  "grid_body_kernelILi3ELi0E")}


def _build_variants(specs, prefix: str = "libmode"):
    """Builds ``{name: (source, flags)}``, one ``nvcc`` each, all started
    together, into ``build/efa_xray_tpu_torch/variants/<prefix>_<i>.so``
    (a prefix of its own for each caller: a loaded library is never
    rewritten); binds each library's entries as
    :mod:`~efa_xray_tpu_torch.ops._build` does.  Returns ``{name:
    library}``."""
    from efa_xray_tpu_torch.ops import _build

    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "efa_xray_tpu_torch", "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, (src, flags)) in enumerate(specs.items()):
        out = os.path.join(out_dir, f"{prefix}_{i}.so")
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o", out,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        text, _ = proc.communicate()
        check(proc.returncode == 0, f"steps: nvcc failed for {name}:\n{text}")
        lib = ctypes.CDLL(out)
        for fn, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _build._RESTYPES.get(
                    fn, ctypes.c_int)
        libs[name] = lib
    return libs


def _ieee_sass_check():
    """Whether each fp32 instantiation of B2/B2h and of the grid kernel
    compiles to the parent commit's machine code: both sources to
    ``-cubin``, ``cuobjdump -sass``, each kernel's listing compared.
    Returns ``{kernel: "same" | "differs in n of m lines" | "no parent"}``."""
    from efa_xray_tpu_torch.ops import _build

    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "efa_xray_tpu_torch", "variants")
    os.makedirs(out_dir, exist_ok=True)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")

    def listings(src, tag):
        cubin = os.path.join(out_dir, f"{tag}.cubin")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-cubin", "-o",
                        cubin, src], check=True, capture_output=True)
        text = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
        out, name = {}, None
        for line in text.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                out[name] = []
            elif name is not None and "/*" in line:
                out[name].append(line.strip())
        return out

    res = {}
    for src, kernels in IEEE_KERNELS.items():
        parent = os.path.join(root, "build", "efa_xray_tpu_torch", "parent",
                              src)
        if not os.path.exists(parent):
            res.update(dict.fromkeys(kernels, "no parent"))
            continue
        own = listings(str(_build.CSRC / src), "own_" + src)
        old = listings(parent, "parent_" + src)
        for k in kernels:
            # This source's fp32 instantiations end in kZ = false.
            a = next((v for n, v in own.items() if k + "Lb0E" in n),
                     None) or next(v for n, v in own.items() if k in n)
            b = next(v for n, v in old.items() if k in n)
            diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            res[k] = ("same" if diff == 0 else
                      f"differs in {diff} of {max(len(a), len(b))} lines")
    return res


def mode_steps_phase():
    """What the tensor-core modes' redesign changed, beside the parent
    commit's kernels on the same operands: B2 and B2h on phase 3's
    workload, B3 at config 3's shape, B4 at one block of config 3 and of
    the 1024 x 1024 x 80 grid, each in fp32 (bit for bit the parent's),
    TF32 and bf16; the mode kernels with parts left out (``MODE_PARTS``:
    the rounding passes, D0, the apply; wrong results, timed only); the
    grid kernel's modes at both tiles; and whether the fp32
    instantiations' machine code is the parent's."""
    import torch

    from efa_xray_tpu_torch.observation.localization import latlon_to_unit
    from efa_xray_tpu_torch.ops import _build, ensrf_fused, ensrf_grid

    root = os.path.dirname(os.path.abspath(__file__))
    log(f"steps modes: fp32 machine code against the parent's: "
        f"{_ieee_sass_check()}")
    specs = {}
    for part, (fbits, gbits) in MODE_PARTS.items():
        flags = ((f"-DEFA_MMA_PROBE={gbits}",) * 2 if fbits == "probe" else
                 (f"-DEFA_FUSED_SKIP={fbits}", f"-DEFA_GRID_SKIP={gbits}"))
        specs[("B2", part)] = (str(_build.CSRC / "ensrf_fused.cu"),
                               [flags[0]])
        specs[("grid", part)] = (str(_build.CSRC / "ensrf_grid.cu"),
                                 [flags[1]])
    for key, src in (("B2", PARENT_FUSED_SOURCE),
                     ("grid", PARENT_GRID_SOURCE)):
        if os.path.exists(os.path.join(root, src)):
            specs[(key, "parent")] = (os.path.join(root, src), [])
        else:
            log(f"steps modes: no {src}; the parent's {key} is not timed")
    libs = _build_variants(specs)
    for key in libs:
        if key[1] == "parent":
            libs[key] = _ParentEntries(libs[key])

    def report(label, run, key, tiles, reps):
        """``run(mode, tile)`` -> outputs; ``tiles(mode)``: the tiles to
        time (the wrapper's first)."""
        line = []
        for mode in ("ieee", "tf32", "bf16"):
            want = run(mode, tiles(mode)[0])
            timed = [(f"tile {t}", lambda t=t: run(mode, t))
                     for t in tiles(mode)]
            if (key, "parent") in libs:
                timed.append(("parent", lambda: _with_lib(
                    libs[(key, "parent")], lambda: run(mode, None))))
            ms = {}
            for name, fn in timed + timed[::-1]:
                got = fn()
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
                if mode == "ieee" and name == "parent":
                    check(err == 0.0, f"steps modes {label}: the fp32 "
                          f"kernel is not the parent's bit for bit ({err})")
                ms.setdefault(name, []).append(cuda_ms(fn, reps))
                ms[name + " err"] = [err]
            parts = {}
            if mode != "ieee" or key == "grid":
                for part in MODE_PARTS:
                    parts[part] = _with_lib(
                        libs[(key, part)],
                        lambda: cuda_ms(lambda: run(mode, tiles(mode)[0]),
                                        reps))
            line.append(f"{mode}: " + ", ".join(
                f"{n} {min(v):.3f} ms" if not n.endswith("err") else
                f"{n} {v[0]:.2e}" for n, v in ms.items()) + (
                "; without " + ", without ".join(
                    f"{p} {v:.3f} ms" for p, v in parts.items())
                if parts else ""))
        log(f"steps modes {label}: " + " | ".join(line))

    w = _b2_workload()
    for hybrid in (False, True):
        kw = {}
        if hybrid:
            gen = torch.Generator(device="cuda").manual_seed(141)
            kw = dict(hybrid=True, body_sigma=2.0 + 2.0 * torch.rand(
                w["n"], generator=gen, device="cuda"), static_length=1000.0)
        tail = w["tail"]
        if hybrid:
            from efa_xray_tpu_torch.assimilation import ensrf_core as core
            tail = core.tail_scan_blocked(
                w["tm"], w["tp"], w["obs"], localize=True,
                fast_geometry=True, panel=512, kernels=True,
                max_radius_km=2000.0, hybrid_alpha=0.5,
                tail_sigma=2.0 + 2.0 * torch.rand(
                    w["nobs"], generator=gen, device="cuda"),
                static_length=1000.0)
        ops = {m: ensrf_fused.prepare(w["bp"], w["lat"], w["lon"], tail,
                                      w["obs"], block_size=128,
                                      max_radius_km=2000.0, precision=m,
                                      **kw)
               for m in ("ieee", "tf32", "bf16")}
        # The cull bits at either tile (the kernel takes 32 rows here).
        bits = {t: ensrf_fused.cull_bits(
            latlon_to_unit(w["lat"], w["lon"]),
            latlon_to_unit(w["obs"].lats, w["obs"].lons),
            (torch.clamp(w["obs"].radii, min=1000.0) if hybrid
             else w["obs"].radii), w["obs"].assim, t,
            ops["ieee"]["y_b"].shape[0], 128) for t in (32, 64)}

        def run(mode, tile, ops=ops, hybrid=hybrid, bits=bits):
            o = ops[mode]
            t = tile or o["tile"]
            return ensrf_fused.fused_apply_cuda(
                w["bm"], w["bp"], o["geom"], o["y_b"], o["ggt_b"],
                o["tab_b"], bits[t], t, True, False, o["series"], hybrid,
                precision=mode)

        report(f"{'B2h' if hybrid else 'B2'} 262,144 x 80 x 2048 obs", run,
               "B2", lambda mode: [ops[mode]["tile"], 96 - ops[mode]["tile"]],
               5)
        del ops
    del w
    bsz = 128
    for label, dims, b3 in (
            ("config 3 (80 groups x 16,200 x 30, 5,000 obs)",
             dict(ny=90, nx=180, vt=80, nmems=30, nobs=5000, seed=61,
                  group_levels=np.tile(C3_LEVELS, 4)), True),
            ("1024x1024 x 80 members (vt 1)",
             dict(ny=1024, nx=1024, vt=1, nmems=80, nobs=512, seed=72),
             False)):
        c = _grid_case(**dims)
        vertical = dims["vt"] > 1
        ops = ensrf_grid.grid_prepare(
            c["bp"], c["body_vert"], c["tail"], c["obs"], c["ngrid"],
            block_size=bsz, vertical=vertical,
            group_factor=c["gf"] if vertical else None)
        nb = ops["y_b"].shape[0] if b3 else 1
        wts = ensrf_grid.grid_weights(
            latlon_to_unit(c["lat"], c["lon"]),
            ops["ob_xyz"][:nb * bsz], ops["radii"][:nb * bsz]).reshape(
                nb, bsz, c["ngrid"])
        table = ops["table"]
        args = (wts, None if table is None else table[:, :nb].contiguous(),
                ops["y_b"][:nb], ops["ggt_b"][:nb], ops["coef_b"][:nb])
        tiles = lambda mode: sorted(
            (t for t in (32, 64) if ensrf_grid.ctas_per_sm(
                t, bsz, dims["nmems"], mode) >= 1),
            key=lambda t: t != ensrf_grid.pick_tile(bsz, dims["nmems"],
                                                    mode))
        for entry in (("B3", "B4") if b3 else ("B4",)):
            a = args if entry == "B3" else tuple(
                None if t is None else (t[:, :1] if i == 1 else t[:1])
                for i, t in enumerate(args))

            def run(mode, tile, entry=entry, a=a):
                return ensrf_grid.grid_apply_cuda(
                    entry, c["bm"], c["bp"], *a, ops["vt"],
                    tile=tile or PARENT_GRID_TILE, precision=mode)

            report(f"{entry} {label}{'' if entry == 'B3' else ', one block'}",
                   run, "grid", tiles, 3 if entry == "B3" else 5)
        del c, ops, wts, args


PARENT_NS_SOURCE = os.path.join("build", "efa_xray_tpu_torch", "parent",
                                "newton_schulz.cu")


def _parent_ns(lib):
    """A chunk's solve by the parent commit's NS (one launch an iteration
    up to the cap, its C entry ``efa_newton_schulz`` of 16 arguments), as
    the parent's update made it: ``f(a, iters, b) -> (W, wbar, iterations
    as a device scalar)``, its buffers set up and ``A^{-1}`` formed as its
    wrapper did, ``W = sqrt(M - 1) A^{-1/2}`` and ``wbar = A^{-1} b`` as
    its ``_solve_chunk`` did."""
    import torch

    from efa_xray_tpu_torch.ops import newton_schulz

    def solve(a, iters, b):
        ns_, m = a.shape[0], a.shape[-1]
        mp = -(-m // 4) * 4
        c = torch.clamp(torch.amax(torch.sum(torch.abs(a), dim=-1), dim=-1),
                        min=1e-30)
        y0 = (a / c[:, None, None]).contiguous()
        e = lambda *shape, dtype=torch.float32: torch.empty(
            shape, dtype=dtype, device=a.device)
        out, yw, zw = e(ns_, m, m), e(ns_, mp, mp), e(ns_, mp, mp)
        tw = None if 3 * mp * (mp + 4) * 4 <= 232448 else e(3, ns_, mp, mp)
        err, run = e(iters + 2), e(iters + 1, dtype=torch.int32)
        count = e(1, dtype=torch.int64)
        tol, quad = newton_schulz.exit_thresholds(a.dtype)
        rc = lib.efa_newton_schulz(
            y0.data_ptr(), c.data_ptr(), out.data_ptr(), yw.data_ptr(),
            zw.data_ptr(), None if tw is None else tw.data_ptr(),
            err.data_ptr(), run.data_ptr(), count.data_ptr(), None, ns_, m,
            iters, tol, quad, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"steps: the parent's NS failed ({rc})")
        return (float(np.sqrt(m - 1)) * out, ((out @ out) @ b[..., None])[..., 0],
                count[0])

    return solve


def ns_steps_phase():
    """NS beside the parent commit's kernel (built from
    ``PARENT_NS_SOURCE`` where that file exists) and the plain loop, on
    config 6's and config 7's first chunks and on :data:`NS_WIDE`, each as
    its update issues the solve (``W`` and ``wbar``): the iterations of
    each, the parent's result against the new one, and ms in turns
    (parent, new, new, parent)."""
    import ctypes

    import torch

    from efa_xray_tpu_torch import LETKF, FilterConfig
    from efa_xray_tpu_torch.assimilation import letkf_core as tl
    from efa_xray_tpu_torch.ops import _build

    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, PARENT_NS_SOURCE)
    parent = None
    if os.path.exists(src):
        out = os.path.join(root, "build", "efa_xray_tpu_torch", "variants",
                           "libns_parent.so")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                              "-o", out, src], capture_output=True, text=True)
        check(res.returncode == 0, "steps: nvcc failed for the parent's NS:"
              f"\n{res.stdout}{res.stderr}")
        lib = ctypes.CDLL(out)
        P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.efa_newton_schulz.argtypes = [P_] * 10 + [I_] * 3 + [F_] * 2 + [P_]
        lib.efa_newton_schulz.restype = ctypes.c_int
        parent = _parent_ns(lib)
    else:
        log(f"steps: no {PARENT_NS_SOURCE}; the parent's NS is not timed")
    cases = {}
    p = CONFIG6
    state, batch = _half_degree_workload("cuda", **p)
    cfg = FilterConfig(localization="GC", letkf_patch_size=p["patch"],
                       letkf_k_obs=p["k"], letkf_chunk=p["chunk"])
    cases["config 6 chunk"] = _first_ns_input(
        lambda: LETKF(state, batch, config=cfg).update())
    del state, batch
    p = CONFIG7
    bm, bp, tm, tp, lat, lon, obs = _config7("cuda", p)
    cases["config 7 chunk"] = _first_ns_input(lambda: tl.letkf_update(
        bm, bp, tm, tp, lat, lon, obs, ngrid=p["npts"],
        patch_size=p["patch"], k_obs=p["k"], chunk=p["chunk"]))
    del bm, bp, tm, tp, lat, lon, obs
    m = NS_WIDE["nmems"]
    gen = torch.Generator(device="cuda").manual_seed(m)
    cases["200 members"] = (_letkf_like_spd(
        m, NS_WIDE["chunk"], NS_WIDE["k"], NS_WIDE["seed"]),
        NS_WIDE["iters"], torch.randn((NS_WIDE["chunk"], m), generator=gen,
                                      device="cuda"))
    res = {}
    for label, (a, iters, b) in cases.items():
        new = _ns_launch(a, iters, b)
        got = [x.clone() for x in new()]
        want = _ns_plain(a, iters, b)
        r = dict(shape=list(a.shape), iterations=int(got[2][0]),
                 plain_iterations=want[2],
                 err_vs_plain=max(
                     compare(f"steps NS {label} W", got[0], want[0]),
                     compare(f"steps NS {label} wbar", got[1], want[1])))
        check(r["iterations"] == want[2], f"steps NS {label}: {r}")
        timings = {"new": [], "parent": []}
        order = ["parent", "new", "new", "parent"] if parent else ["new"] * 2
        for who in order:
            fn = (lambda: parent(a, iters, b)) if who == "parent" else new
            timings[who].append(device_ms(fn, 5))
        r["ms"] = timings["new"]
        r["plain_ms"] = cuda_ms(lambda: _ns_plain(a, iters, b), 3)
        if parent:
            old = parent(a, iters, b)
            r["parent_iterations"] = int(old[2])
            r["parent_ms"] = timings["parent"]
            r["new_vs_parent"] = max(
                compare(f"steps NS {label} W vs the parent", got[0], old[0]),
                compare(f"steps NS {label} wbar vs the parent", got[1],
                        old[1]))
        res[label] = r
        log(f"steps NS {label}: " + json.dumps(r))
    return res


# The shapes the two levers are timed at (members, block): past the member
# bound at the default block and at 256, the slice-only width, and the
# block bound at config 4's and config 3's ensembles; and the sub-blocks
# timed at each.
LEVER_SHAPES = ((300, 128), (512, 128), (512, 256), (1024, 128), (80, 256),
                (80, 512), (80, 1024), (30, 1024))
LEVER_SUB_BLOCKS = (256, 128, 64, 32)


def _lever_plans(smem, tile, bsz, m):
    """The stagings to time at ``tile``: ``{lever: (sub, mslice)}`` for
    sub-blocks alone (each of ``LEVER_SUB_BLOCKS`` below the block that
    fits with every member), member slices alone (the caller's block, the
    widest slice that fits) and both (blocks of 64 obs, the widest slice),
    where each fits; ``smem(tile, block, members)``."""
    from efa_xray_tpu_torch.ops import ensrf_fused as ef

    fits = lambda b, k: smem(tile, b, k) <= ef.MAX_SMEM_BYTES
    widest = lambda b: max((k for k in range(ef.SLICE_UNIT, m, ef.SLICE_UNIT)
                            if fits(b, k)), default=None)
    out = {f"sub-blocks of {b}": (b, m) for b in LEVER_SUB_BLOCKS
           if b < bsz and fits(b, m)}
    if widest(bsz):
        out["member slices"] = (bsz, widest(bsz))
    b = min(bsz, 64)
    if widest(b):
        out["both"] = (b, widest(b))
    return out


@contextlib.contextmanager
def _forced_plan(mod, sub: int, mslice: int):
    """``mod``'s wrapper (:mod:`ensrf_fused` or :mod:`ensrf_grid`) staged
    as blocks of ``sub`` obs and slices of ``mslice`` members, at the tile
    its ``plan`` picks."""
    real = mod.plan
    mod.plan = lambda *a, **k: real(*a, **k)._replace(sub=sub, mslice=mslice)
    try:
        yield
    finally:
        mod.plan = real


def lever_steps_phase(n: int = 262_144, nobs: int = 2048):
    """The two levers of any ensemble and any block, timed on the card: B2
    on ``n`` scattered rows and ``nobs`` obs at 2000 km, and B4 over one
    block on ``n`` points, at each shape of :data:`LEVER_SHAPES` in fp32,
    under the plan's staging and under each lever of
    :func:`_lever_plans`, each result held against the plan's at the f32
    gate."""
    import torch

    from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid

    rows = []
    for m, bsz in LEVER_SHAPES:
        w = _b2_workload(n=n, m=m, nobs=nobs)
        ops = ensrf_fused.prepare(w["bp"], w["lat"], w["lon"], w["tail"],
                                  w["obs"], block_size=bsz,
                                  max_radius_km=2000.0)
        args = (w["bm"], w["bp"], ops["geom"], ops["y_b"], ops["ggt_b"],
                ops["tab_b"], ops["bits"], ops["tile"], True, False,
                ops["series"])
        tile = ops["tile"]
        planned = ensrf_fused.plan(bsz, m, tile=tile)
        def run(sub, ms):
            with _forced_plan(ensrf_fused, sub, ms):
                return ensrf_fused.fused_apply_cuda(*args)

        want = run(planned.sub, planned.mslice)
        levers = _lever_plans(lambda t, b, k: ensrf_fused.smem_bytes(t, b, k),
                              tile, bsz, m)
        r = dict(kernel="B2", nmems=m, block=bsz, tile=tile,
                 plan=(planned.sub, planned.mslice),
                 plan_ms=cuda_ms(lambda: run(planned.sub, planned.mslice), 3))
        for lever, (sub, ms) in levers.items():
            got = run(sub, ms)
            compare(f"levers B2 {m} x {bsz} {lever} mean", got[0], want[0])
            compare(f"levers B2 {m} x {bsz} {lever} perts", got[1], want[1])
            r[lever] = dict(sub=sub, mslice=ms,
                            ms=cuda_ms(lambda: run(sub, ms), 3))
        rows.append(r)
        del w, ops, args, want
        gen = torch.Generator(device="cuda").manual_seed(m + bsz)
        bp = torch.randn(n, m, generator=gen, device="cuda")
        bm = torch.randn(n, generator=gen, device="cuda")
        y = 0.3 * torch.randn(1, bsz, m, generator=gen, device="cuda")
        sq = 0.01 * torch.rand(1, bsz, generator=gen, device="cuda")
        ggt = ensrf_grid._gram_tables(y, sq)
        coef = torch.stack([0.01 * torch.rand(1, bsz, generator=gen,
                                               device="cuda"), sq], 1)
        wt = torch.rand(1, bsz, n, generator=gen, device="cuda")
        planned = ensrf_grid.plan(bsz, m)
        def grun(sub, ms, tile=planned.tile):
            with _forced_plan(ensrf_grid, sub, ms):
                return ensrf_grid.grid_apply_cuda(
                    "B4", bm, bp, wt, None, y, ggt, coef, 1, tile=tile)

        want = grun(planned.sub, planned.mslice)
        r = dict(kernel="B4", nmems=m, block=bsz, tile=planned.tile,
                 plan=(planned.sub, planned.mslice),
                 plan_ms=cuda_ms(lambda: grun(planned.sub, planned.mslice),
                                 5))
        levers = _lever_plans(lambda t, b, k: ensrf_grid.smem_bytes(t, b, k),
                              planned.tile, bsz, m)
        for lever, (sub, ms) in levers.items():
            got = grun(sub, ms)
            compare(f"levers B4 {m} x {bsz} {lever} mean", got[0], want[0])
            compare(f"levers B4 {m} x {bsz} {lever} perts", got[1], want[1])
            r[lever] = dict(sub=sub, mslice=ms,
                            ms=cuda_ms(lambda: grun(sub, ms), 5))
        rows.append(r)
        del bp, bm, y, ggt, coef, wt, want
    for r in rows:
        log(f"levers {r['kernel']} {r['nmems']} members, blocks of "
            f"{r['block']} (tile {r['tile']}): plan (sub-block, slice) "
            f"{r['plan']} {r['plan_ms']:.3f} ms; " + "; ".join(
                f"{k}: ({v['sub']}, {v['mslice']}) {v['ms']:.3f} ms"
                for k, v in r.items() if isinstance(v, dict)))
    return rows


def steps_phase():
    """What the parts of B1's and B2's design buy: B1 at each sub-panel
    and cluster, then B2 on phase 3's workload and on the headline body,
    then the grid kernel, the product modes, NS beside the parent's
    kernel, and the levers of any ensemble and any block."""
    b1_steps_phase()
    w = _b2_workload()
    _b2_variants("262,144 x 80 x 2048 obs", w["bm"], w["bp"], w["lat"],
                 w["lon"], w["tail"], w["obs"], 2000.0, 5)
    del w
    tail_phase, _, w = _headline()
    _b2_variants("headline body, 1e7 x 80 x 10k obs", w["bm"], w["bp"],
                 w["lat"], w["lon"], tail_phase(), w["obs"], w["radius"], 2)
    del tail_phase, w
    grid_steps_phase()
    mode_steps_phase()
    ns_steps_phase()
    lever_steps_phase()


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    smi = phase0()
    phase1()
    if "--profile" in sys.argv[1:] or "--steps" in sys.argv[1:]:
        profile_phase() if "--profile" in sys.argv[1:] else steps_phase()
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    def timed(phase):
        t0 = time.perf_counter()
        out = phase()
        log(f"{phase.__name__} took {time.perf_counter() - t0:.1f} s")
        return out

    b1 = timed(phase2)
    b2 = timed(phase3)
    api = timed(phase4)
    timed(phase5)
    b3 = timed(phase6)
    b4 = timed(phase7)
    c3 = timed(phase8)
    wide = timed(phase9)
    b2h = timed(phase10)
    hyb = timed(phase11)
    p = timed(phase12)
    timed(phase13)
    timed(phase14)
    timed(phase15)
    timed(phase16)
    timed(phase17)
    enkf = timed(phase18)
    letkf = timed(phase19)
    letkf7 = timed(phase20)
    timed(phase21)
    timed(phase22)
    timed(phase23)
    timed(phase24)
    timed(phase25)
    modes = timed(phase26)
    timed(phase27)
    timed(phase28)
    c5 = timed(phase29)
    # No single PyTorch call computes B1-B4, B1h, B2h, B1e, B2e, B4e (a
    # serial filter, a localized recurrence), in any product mode, NS (an
    # iteration with an exit test) or LG (gathered, weighted Grams): their
    # library_ms is null.
    kernels = [
        dict(name="B1 tail panel solve", route="cuda",
             source="efa_xray_tpu_torch/csrc/tail_solve.cu",
             replaces="efa_xray_tpu/ops/tail_solve_pallas.py:46",
             launches=api["b1"], library_ms=None, **b1["B1"]),
        dict(name="B1h tail panel solve, hybrid static column",
             route="cuda", source="efa_xray_tpu_torch/csrc/tail_solve.cu",
             replaces="efa_xray_tpu/ops/tail_solve_pallas.py:46",
             launches=hyb["b1h"], library_ms=None, **b1["B1h"]),
        dict(name="B2 fused body", route="cuda",
             source="efa_xray_tpu_torch/csrc/ensrf_fused.cu",
             replaces="efa_xray_tpu/ops/ensrf_pallas_fused.py:117",
             launches=api["b2"], library_ms=None, **b2),
        dict(name="B2h fused body, hybrid static column", route="cuda",
             source="efa_xray_tpu_torch/csrc/ensrf_fused.cu",
             replaces="efa_xray_tpu/ops/ensrf_pallas_fused.py:208",
             launches=hyb["b2h"], library_ms=None, **b2h),
        dict(name="B3 grid body", route="cuda",
             source="efa_xray_tpu_torch/csrc/ensrf_grid.cu",
             replaces="efa_xray_tpu/ops/ensrf_pallas_fused.py:784",
             launches=c3["b3"], library_ms=None, **b3),
        dict(name="B4 block apply (config 3's shape)", route="cuda",
             source="efa_xray_tpu_torch/csrc/ensrf_grid.cu",
             replaces="efa_xray_tpu/ops/ensrf_pallas.py:68",
             launches=c3["b4"], library_ms=None, **b4["config3"]),
        dict(name="B4 block apply (1024 x 1024 x 80, one group)",
             route="cuda", source="efa_xray_tpu_torch/csrc/ensrf_grid.cu",
             replaces="efa_xray_tpu/ops/ensrf_pallas.py:68",
             launches=wide["b4"], library_ms=None, **b4["wide"]),
        dict(name="B1e tail panel solve, stochastic EnKF (512 x 40)",
             route="cuda", source="efa_xray_tpu_torch/csrc/tail_solve.cu",
             replaces="efa_xray_tpu/ops/tail_solve_pallas.py:46",
             launches=enkf["b_launches"]["B1e"], library_ms=None,
             **b1["B1e"]),
        dict(name="B2e fused body, stochastic EnKF (config 11)",
             route="cuda", source="efa_xray_tpu_torch/csrc/ensrf_fused.cu",
             replaces="efa_xray_tpu/ops/ensrf_pallas_fused.py:117",
             launches=enkf["b_launches"]["B2e"], library_ms=None,
             **enkf["kernels"]["B2e"]),
        dict(name="B4e block apply, stochastic EnKF (config 11, default "
             "config)", route="cuda",
             source="efa_xray_tpu_torch/csrc/ensrf_grid.cu",
             replaces="efa_xray_tpu/ops/ensrf_pallas.py:68",
             launches=enkf["default_launches"]["B4e"], library_ms=None,
             **enkf["kernels"]["B4e"]),
        dict(name="NS Newton-Schulz inverse square root (config 6 chunk)",
             route="cuda", source="efa_xray_tpu_torch/csrc/newton_schulz.cu",
             replaces="efa_xray_tpu/assimilation/letkf_core.py:406",
             launches=letkf["config6"]["exact"]["launches"]["NS"],
             library_ms=None,
             **{k: letkf["config6"]["ns"][k] for k in NS_KEYS}),
        dict(name="NS Newton-Schulz inverse square root (config 7 chunk)",
             route="cuda", source="efa_xray_tpu_torch/csrc/newton_schulz.cu",
             replaces="efa_xray_tpu/assimilation/letkf_core.py:406",
             launches=letkf7["exact"]["ns_launches"], library_ms=None,
             **{k: letkf7["ns"][k] for k in NS_KEYS}),
        dict(name="LG local precision and Gram (config 6 chunk)",
             route="cuda", source="efa_xray_tpu_torch/csrc/letkf_gram.cu",
             replaces="efa_xray_tpu/assimilation/letkf_core.py:592",
             launches=letkf["config6"]["exact"]["launches"]["LG"],
             library_ms=None,
             **{k: letkf["config6"]["lg"][k] for k in NS_KEYS}),
        dict(name="LG local precision and Gram (config 7 chunk)",
             route="cuda", source="efa_xray_tpu_torch/csrc/letkf_gram.cu",
             replaces="efa_xray_tpu/assimilation/letkf_core.py:592",
             launches=letkf7["exact"]["lg_launches"], library_ms=None,
             **{k: letkf7["lg"][k] for k in NS_KEYS}),
    ] + [
        dict(name=f"{name} ({mode} products)", route="cuda", source=source,
             replaces=replaces,
             launches=modes["api"][api][
                 f"matmul_precision={MODE_SETTING[mode]}"][
                 "body_launches_in_mode"],
             library_ms=None,
             **{k: modes["kernels"][key][mode][k]
                for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by")})
        for name, key, api, source, replaces in MODE_KERNELS
        for mode in ("tf32", "bf16")
    ] + [
        dict(name=f"P precision probe ({mode})", route="cuda",
             source="efa_xray_tpu_torch/csrc/precision_probe.cu",
             replaces="benchmarks/precision_probe.py:29", **o)
        for mode, o in p.items()] + _wide_rows(c5)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
