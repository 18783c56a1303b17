"""What the traced run reads from ``torch.profiler``: the device's events
over the window, their union (busy time), and the breakdown.

The harness wraps the measured window in a span ``portbench.window`` and
each update in ``portbench.update``; the profiler records the device's
kernels, copies and sets (CUPTI) and the host's operations.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
from collections import defaultdict

WINDOW_SPAN = "portbench.window"
UPDATE_SPAN = "portbench.update"
# How far a device event may start outside its update's span.
EDGE_US = 1000.0
# Idle gaps shorter than this are summed under one name in the breakdown.
SHORT_GAP_US = 20.0
# A name in the breakdown keeps this many characters.
NAME_CHARS = 200


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start_us: float
    end_us: float
    # When the host issued it (its runtime call's start, on the host's
    # clock), where the trace links the two.
    launch_us: float | None = None

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    @property
    def is_kernel(self) -> bool:
        """A kernel launch, not a copy or a set."""
        return not self.name.startswith(("Memcpy", "Memset"))


@dataclasses.dataclass
class Trace:
    events: list  # [DeviceEvent] inside the window
    host: list  # [(start_us, end_us, name)] of the window's thread
    window: tuple  # (start_us, end_us) of the window span
    updates: list = dataclasses.field(default_factory=list)  # update spans

    @functools.cached_property
    def update_events(self) -> list:
        """The device events an update issued: those whose runtime call
        the host made inside an update's span (both on the host's clock),
        and, where the trace does not link an event to its call, those
        that start inside a span give or take ``EDGE_US`` (the device's
        clock is mapped onto the host's).  Each update ends by waiting for
        the card, and the harness pauses before it issues work of its own,
        so these are the updates' work and nothing else."""
        starts = [b for b, _ in self.updates]
        out = []
        for e in self.events:
            t, edge = ((e.launch_us, 0.0) if e.launch_us is not None
                       else (e.start_us, EDGE_US))
            i = bisect.bisect_right(starts, t + edge) - 1
            if i >= 0 and t <= self.updates[i][1] + edge:
                out.append(e)
        return out

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us([(e.start_us, e.end_us) for e in self.events]) / 1e6


def union_us(spans) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for b, e in sorted(spans):
        if end is None or b > end:
            total += e - b
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(spans) -> list:
    out = []
    for b, e in sorted(spans):
        if out and b <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([b, e])
    return out


def from_profiler(prof) -> Trace:
    """The window's device events and its thread's host events, read from
    the profiler's raw (Kineto) events: building ``prof.events()``'s tree
    takes minutes for a window of 1e5 events.  The spans' own device-side
    annotations are not device work and are left out."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    spans = [e for e in events if e.name() == WINDOW_SPAN
             and e.device_type() == DeviceType.CPU]
    if not spans:
        raise RuntimeError(f"the profile holds no {WINDOW_SPAN!r} span")
    win = spans[0]
    w0, w1 = win.start_ns() / 1e3, win.end_ns() / 1e3
    thread = win.start_thread_id()
    dev, host, ups, calls = [], [], [], {}
    for e in events:
        b, f = e.start_ns() / 1e3, e.end_ns() / 1e3
        if f <= w0 or b >= w1:
            continue
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and name not in (WINDOW_SPAN,
                                                           UPDATE_SPAN):
                dev.append((DeviceEvent(name, max(b, w0), min(f, w1)),
                            e.correlation_id()))
        elif e.start_thread_id() == thread:
            host.append((b, f, name))
            if name == UPDATE_SPAN:
                ups.append((b, f))
            elif name.startswith("cu") and e.correlation_id():
                calls[e.correlation_id()] = b
    for d, corr in dev:
        d.launch_us = calls.get(corr) if corr else None
    return Trace(events=[d for d, _ in dev], host=host, window=(w0, w1),
                 updates=sorted(ups))


def _innermost(host, points):
    """For each time in ``points`` (ascending), the name of the innermost
    host event that contains it (events of one thread nest), or None."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out, stack, j = [], [], 0
    for t in points:
        while j < len(host) and host[j][0] <= t:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle seconds by
    what the window's thread was doing (its innermost operation at the
    middle of each gap), ``top`` of each, as ``[name, seconds]``."""
    ops = defaultdict(float)
    for e in tr.events:
        ops[e.name] += e.seconds
    busy = merged([(e.start_us, e.end_us) for e in tr.events])
    gaps, t = [], tr.window[0]
    for b, e in busy:
        if b > t:
            gaps.append((t, b))
        t = max(t, e)
    if tr.window[1] > t:
        gaps.append((t, tr.window[1]))
    idle = defaultdict(float)
    long_gaps = [g for g in gaps if g[1] - g[0] >= SHORT_GAP_US]
    for g in gaps:
        if g[1] - g[0] < SHORT_GAP_US:
            idle[f"(gaps under {SHORT_GAP_US:g} us)"] += (g[1] - g[0]) / 1e6
    names = _innermost(tr.host, [(b + e) / 2 for b, e in long_gaps])
    for (b, e), name in zip(long_gaps, names):
        idle[name or "(no host operation)"] += (e - b) / 1e6
    rank = lambda d: [[k[:NAME_CHARS], v] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
