"""Profiling hooks.

Counterpart of ``efa_xray_tpu/utils/profiling.py`` (``trace`` :17,
``annotate`` :31) on ``torch.profiler``: :func:`trace` records the host
and, where a card is present, the device, and writes a Chrome trace
(viewable in Perfetto or ``chrome://tracing``) into ``logdir``;
:func:`annotate` labels a span of user code in that trace.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the block into ``logdir/trace.json``:

    >>> with profiling.trace("ensrf-trace"):
    ...     filt.update()

    Yields the ``torch.profiler.profile`` object, whose ``key_averages()``
    sum the time by operation."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """``torch.profiler.record_function``: a named span of user code."""
    import torch

    return torch.profiler.record_function(name)
