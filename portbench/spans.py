"""What the readers of the program's own spans share: for the traced
window's updates, the host time of the window's thread by the layer of its
innermost program span, with the host's waits on the card taken out, and
the number of the host's synchronizations with the card.

The program names its spans ``efa.<layer>.<what>`` (``entry``, ``obs``,
``route``, ``ops``); the prefix is the contract with these readers, which
import nothing of the program.  Inside each ``portbench.update`` span every
instant of the window's thread belongs to the layer of the innermost
program span that holds it; instants inside a CUDA runtime call that waits
on the card (:func:`waits`) belong to no layer.  The layers add up to the
host time spent in the program, less its waits.  The harness's own wait at
the end of each update lies outside every program span.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

PREFIX = "efa."
# Runtime calls that return when the card has done the work before them.
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize"})
# Runtime calls that put work on the card's queue.  They return in
# microseconds unless the queue is full, and then only once the card has
# taken work off it.
ENQUEUES = ("cudaLaunch", "cuLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
            "cudaGraphLaunch")
BLOCKED_US = 50.0


def waits(host) -> list:
    """The runtime calls among ``host`` events ``[(start_us, end_us,
    name)]`` that wait on the card, as ``(start_us, end_us, is_sync)``:

    * a synchronize (``SYNCS``; ``is_sync``);
    * a copy whose next runtime call is a ``cudaStreamSynchronize``:
      PyTorch's blocking copy, whose copy into pageable memory returns only
      once the card is done, the synchronize at once after it (the pair
      counts once, as the synchronize);
    * an enqueue that lasts longer than ``BLOCKED_US``: it waited for room
      in the card's queue.
    """
    calls = sorted(h for h in host if h[2].startswith("cu"))
    out = []
    for i, (b, e, name) in enumerate(calls):
        if name in SYNCS:
            out.append((b, e, True))
        elif (name.startswith("cudaMemcpy") and i + 1 < len(calls)
              and calls[i + 1][2] == "cudaStreamSynchronize"):
            out.append((b, e, False))
        elif name.startswith(ENQUEUES) and e - b > BLOCKED_US:
            out.append((b, e, False))
    return out


@dataclasses.dataclass
class Split:
    host_us: dict  # layer -> host microseconds over the window's updates
    syncs: int  # synchronizations inside a program span
    layers: frozenset  # layers that have a span in the window


def split(host, updates) -> Split | None:
    """The split of the window's thread's ``host`` events ``[(start_us,
    end_us, name)]`` inside the ``updates`` spans ``[(start_us,
    end_us)]``, or None where no program span lies inside an update."""
    starts = [b for b, _ in updates]
    events = ([(b, e, n.split(".", 2)[1], False) for b, e, n in host
               if n.startswith(PREFIX)]
              + [(b, e, None, sync) for b, e, sync in waits(host)])
    # (start, end, the layer or None for a wait, whether a synchronize)
    ivs = []
    for b, e, label, sync in events:
        i = bisect.bisect_right(starts, b) - 1
        if i >= 0 and b <= updates[i][1]:
            ivs.append((b, min(e, updates[i][1]), label, sync))
    layers = frozenset(lab for _, _, lab, _ in ivs if lab is not None)
    if not layers:
        return None
    host_us, syncs = defaultdict(float), 0

    def spend(label, us):
        if label is not None:
            host_us[label] += us

    # Events of one thread nest: a sweep in start order (outer first)
    # gives each instant to the innermost open event.
    stack, t = [], 0.0
    for b, e, label, sync in sorted(ivs, key=lambda iv: (iv[0], -iv[1])):
        while stack and stack[-1][0] <= b:
            end, lab = stack.pop()
            spend(lab, end - t)
            t = end
        if stack:
            spend(stack[-1][1], b - t)
            e = min(e, stack[-1][0])
            syncs += sync and stack[-1][1] is not None
        stack.append((e, label))
        t = b
    while stack:
        end, lab = stack.pop()
        spend(lab, end - t)
        t = end
    return Split(host_us=dict(host_us), syncs=syncs, layers=layers)


def layer_ms(ctx, layer: str):
    """Host milliseconds per update whose innermost program span is of
    ``layer``; None where the window has no span of that layer."""
    s = split(ctx.trace.host, ctx.trace.updates)
    if s is None or layer not in s.layers or ctx.updates == 0:
        return None
    return s.host_us.get(layer, 0.0) / 1e3 / ctx.updates


def syncs_per_update(ctx):
    """Synchronizations with the card inside a program span, per update;
    None where the window has no program span."""
    s = split(ctx.trace.host, ctx.trace.updates)
    if s is None or ctx.updates == 0:
        return None
    return s.syncs / ctx.updates
