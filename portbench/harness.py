"""One run of one cell: set-up, the measured window, the traced reading,
the check against the plain reference, and the result.

Closed loop, one caller: each update is issued when the last is complete
on the card, until ``seconds`` have passed; the last update runs to its
end, and the window ends with it.  Every update starts from the cell's
prior and assimilates its own set of obs values.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time
from pathlib import Path

import torch

from portbench import check, generate, readers, spec, trace

# The pause before a checked update's answer is taken, so that its device
# work falls outside the update's span with room (trace.EDGE_US).
ANSWER_PAUSE_S = 0.005
# How updates are issued; the only loop implemented.
LOOPS = ("closed",)


def clock_at_process_start() -> float:
    """``time.perf_counter()`` as it read when this process started (from
    ``/proc``, to 10 ms), or now where ``/proc`` cannot say."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return now - max(age, 0.0)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def p90(values) -> float:
    """Nearest-rank 90th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.9 * len(v)) - 1)]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(root: Path, cell_name: str, seed: int, seconds: float,
        traced: bool, device, t_start: float, size: dict | None = None,
        fields: dict | None = None) -> dict:
    """One run; returns the result line's object.  ``size`` overrides
    keys of the configuration and ``fields`` the ``FilterConfig`` fields
    of the traffic mix (tests at a small size, the control)."""
    device = torch.device(device)
    cell = spec.load_cell(root, cell_name)
    config = {**cell.config, **(size or {})}
    traffic = cell.traffic
    fields = {**traffic["filter"], **(fields or {})}
    ck = cell.check
    if traffic["loop"] not in LOOPS:
        raise ValueError(f"traffic loop {traffic['loop']!r} is not "
                         f"implemented here (implemented: {list(LOOPS)})")
    entry = spec.load_module("entries", traffic["entry"])
    reference = spec.load_module("reference", config["reference"])
    limits = ck["limits"]
    if set(limits) != set(check.names(reference)):
        raise ValueError(f"{cell_name}: limits {sorted(limits)} are not "
                         f"the compared numbers "
                         f"{sorted(check.names(reference))}")

    marks = [("imports", time.perf_counter())]
    inputs = generate.make_inputs(config, traffic, seed, device)
    _sync(device)
    marks.append(("inputs", time.perf_counter()))
    prog = entry.Entry(inputs, fields, device)
    _sync(device)
    marks.append(("program", time.perf_counter()))
    g = generate.gen(seed, "check", "cpu")
    nsample = min(int(ck["sample_rows"]), inputs.nstate)
    sample = torch.randperm(inputs.nstate, generator=g)[:nsample].sort()[0]
    sample = sample.to(device)
    early = int(torch.randint(int(ck["early_updates"]), (1,), generator=g))
    for _ in range(int(traffic["warmup"])):
        out = prog.update(0)
        del out
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    log("set-up: " + ", ".join(
        f"{name} {t - prev:.2f} s" for (name, t), prev in
        zip(marks, [t_start] + [t for _, t in marks[:-1]])))

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    times, kept, attempted, failed = [], {}, 0, 0
    t1 = 0.0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    with torch.profiler.record_function(trace.WINDOW_SPAN):
        while True:
            k = attempted
            attempted += 1
            a = time.perf_counter()
            try:
                with torch.profiler.record_function(trace.UPDATE_SPAN):
                    out = prog.update(k)
                    _sync(device)
            except Exception as exc:  # noqa: BLE001 - counted, reported
                failed += 1
                log(f"update {k} failed: {exc!r}")
                t1 = time.perf_counter()
                if failed >= 3 or t1 - t0 >= seconds:
                    break
                continue
            t1 = time.perf_counter()
            times.append(t1 - a)
            last = t1 - t0 >= seconds
            if k == early or last:
                # Only the checked updates' answers are taken, after the
                # update's span and a pause that keeps their device time
                # clear of it in the trace, and waited for.
                time.sleep(ANSWER_PAUSE_S)
                kept[k] = prog.answer(out, sample)
                _sync(device)
            del out
            if last:
                break
    _sync(device)
    window_s = t1 - t0
    if prof is not None:
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        log(f"profiler stopped in {time.perf_counter() - t:.1f} s")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    prog.close()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"{cell_name} seed {seed}: {len(times)} updates in {window_s:.3f} s"
        f" (set-up {setup_s:.3f} s), peak {peak} bytes")

    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": {}, "device": {
                  "platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
                  "count": cell.chips if device.type == "cuda" else 1,
                  "memory_peak_bytes": int(peak)}}
    work_per_update = inputs.nobs * inputs.nstate
    if not traced:
        e2e = {"obs_pts_per_s": (len(times) * work_per_update / window_s
                                 if times else None),
               "update_p90_ms": 1e3 * p90(times) if times else None,
               "peak_device_gib": peak / 2**30,
               "setup_s": setup_s}
        for name, unit in cell.end_to_end:
            # A quantity split by cells (``obs_pts_per_s.host_paced``)
            # is measured alike under each of its names.
            name_base = name.split(".", 1)[0]
            if e2e.get(name_base) is not None:
                result["metrics"][name] = {"value": e2e[name_base],
                                           "unit": unit}
    else:
        t = time.perf_counter()
        tr = trace.from_profiler(prof)
        del prof
        t2 = time.perf_counter()
        ctx = readers.Context(
            trace=tr, updates=len(times),
            pairs=spec.load_module("pairs", traffic["pairs"]).count(
                inputs, fields),
            own=readers.own_kernels(
                root / "efa_xray_tpu_torch" / "csrc"))
        log(f"trace read in {t2 - t:.1f} s ({len(tr.events)} device, "
            f"{len(tr.host)} host events), work counted in "
            f"{time.perf_counter() - t2:.1f} s: {ctx.pairs}")
        for name, unit in cell.per_layer:
            value = spec.metric_reader(name).read(ctx)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": unit}
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = trace.breakdown(tr)

    readings = []
    t = time.perf_counter()
    for k in sorted(kept):
        want = reference.expected(inputs, k, sample)
        readings.append(check.parts(kept[k], want, reference))
        del want
    log(f"reference checked updates {sorted(kept)} in "
        f"{time.perf_counter() - t:.1f} s")
    nums = check.numbers(readings, reference)
    result["correct"] = bool(readings) and failed == 0 and check.verdict(
        nums, limits)
    result["gap_parts"] = {k: max(r[k] for r in readings)
                           for k in (readings[0] if readings else {})}
    result["checks"] = {n: {"value": nums[n], "limit": limits[n]}
                        for n in nums}
    return result
