"""Profiling hooks.

Counterpart of ``efa_xray_tpu/utils/profiling.py`` (``trace`` :17,
``annotate`` :31) on ``torch.profiler``: :func:`trace` records the host
and, where a card is present, the device, and writes a Chrome trace
(viewable in Perfetto or ``chrome://tracing``) into ``logdir``;
:func:`annotate` labels a span of user code in that trace.

The filter carries its own spans at each layer boundary, named by the
constants below.  They are recorded exactly while a ``torch.profiler``
session records (:func:`trace`, or any ``torch.profiler.profile``), and
land on the same timeline as the card's kernels and copies.  The prefix
of a name is its layer, the contract with the tools that read a trace:

efa.entry.init               entry        Assimilation.__init__
efa.entry.update             entry        EnSRF.update, LETKF.update, EnKF.update
efa.entry.format_prior       entry        Assimilation.format_prior_state
efa.entry.obs_arrays         entry        Assimilation.obs_arrays
efa.entry.outlier_check      entry        Assimilation.apply_outlier_check
efa.entry.diagnostics        entry        Assimilation.record_diagnostics
efa.entry.inflation          entry        Assimilation.maybe_update_adaptive_inflation
efa.entry.format_posterior   entry        Assimilation.format_posterior_state
efa.obs.taps                 observation  Assimilation.build_taps (the cache lookup)
efa.obs.taps_build           observation  forward.build_taps (a cache miss)
efa.obs.priors               observation  Assimilation.compute_ob_priors
efa.route.solve              route        KernelRoute.solve
efa.route.tail               route        ensrf_core.tail_scan_blocked
efa.route.tail_panel         route        each panel of the tail
efa.route.body               route        KernelRoute._body_apply
efa.route.letkf              route        letkf_core.letkf_update (the LETKF's route)
efa.ops.panel_weights        ops          ensrf_core.panel_weights
efa.ops.prepare              ops          ensrf_fused.prepare (B2's operands)
efa.ops.block_operands       ops          ensrf_grid.block_operands (one B4 block)
efa.ops.letkf_select         ops          a chunk's local obs (letkf_core._select_chunk),
                                          the obs-space letkf_core.select_local_obs
efa.ops.letkf_solve          ops          a chunk's solve (letkf_core._ChunkSolver: LG, NS)

A span never synchronizes, reads a tensor or allocates on the card, and
with no profiler recording it costs one check and a shared no-op.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch

ENTRY_INIT = "efa.entry.init"
ENTRY_UPDATE = "efa.entry.update"
ENTRY_FORMAT_PRIOR = "efa.entry.format_prior"
ENTRY_OBS_ARRAYS = "efa.entry.obs_arrays"
ENTRY_OUTLIER_CHECK = "efa.entry.outlier_check"
ENTRY_DIAGNOSTICS = "efa.entry.diagnostics"
ENTRY_INFLATION = "efa.entry.inflation"
ENTRY_FORMAT_POSTERIOR = "efa.entry.format_posterior"
OBS_TAPS = "efa.obs.taps"
OBS_TAPS_BUILD = "efa.obs.taps_build"
OBS_PRIORS = "efa.obs.priors"
ROUTE_SOLVE = "efa.route.solve"
ROUTE_TAIL = "efa.route.tail"
ROUTE_TAIL_PANEL = "efa.route.tail_panel"
ROUTE_BODY = "efa.route.body"
ROUTE_LETKF = "efa.route.letkf"
OPS_PANEL_WEIGHTS = "efa.ops.panel_weights"
OPS_PREPARE = "efa.ops.prepare"
OPS_BLOCK_OPERANDS = "efa.ops.block_operands"
OPS_LETKF_SELECT = "efa.ops.letkf_select"
OPS_LETKF_SOLVE = "efa.ops.letkf_solve"

_NOOP = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the block into ``logdir/trace.json``:

    >>> with profiling.trace("ensrf-trace"):
    ...     filt.update()

    Yields the ``torch.profiler.profile`` object, whose ``key_averages()``
    sum the time by operation."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named span of user code: ``torch.profiler.record_function(name)``
    while a profiler records, else one shared no-op context manager."""
    if not _recording():
        return _NOOP
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: every call of the function runs inside
    ``annotate(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
