"""What the per-layer metric readers (``portbench/metrics/<metric>.py``)
share: the traced window's context, the port's own kernel names, and a
kernel's roofline share.

A reader is ``read(ctx) -> float | None``; None, where the window holds
nothing to read, leaves the metric out of the result line.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

from portbench import peaks, spec

_GLOBAL = re.compile(r"__global__")
_CALL = re.compile(r"(\w+)\s*\(")


def own_kernels(csrc: Path) -> frozenset:
    """Names of the ``__global__`` functions in the program's CUDA
    sources: the port's own kernels, as a profiler names them."""
    names = set()
    for path in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        text = path.read_text()
        for m in _GLOBAL.finditer(text):
            for c in _CALL.finditer(text, m.end(), m.end() + 400):
                if c.group(1) not in ("__launch_bounds__", "void"):
                    names.add(c.group(1))
                    break
    return frozenset(names)


def base_name(event_name: str) -> str:
    """``void (anonymous namespace)::fused_body_kernel<false, 0>(float
    const*, ...)`` -> ``fused_body_kernel``."""
    name = event_name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ").strip()
    return re.split(r"[<(]", name, maxsplit=1)[0].strip().rsplit("::", 1)[-1]


@dataclasses.dataclass
class Context:
    trace: object  # trace.Trace of the window
    updates: int  # updates completed in the traced window
    pairs: dict  # the pair counter's dict of one update (pairs/<name>.py)
    own: frozenset  # the port's own kernel names

    def kernel_seconds(self, kernel: str) -> float:
        return sum(e.seconds for e in self.trace.update_events
                   if base_name(e.name) == kernel)


def roofline_pct(ctx: Context, kernel_id: str):
    """Percent of its roofline that kernel ``kernel_id``
    (``portbench/counts/<kernel_id>.py``) reaches over the window: the
    least time its work needs over the device time of its launches."""
    counts = spec.load_module("counts", kernel_id)
    seconds = ctx.kernel_seconds(counts.KERNEL)
    if seconds <= 0.0 or ctx.updates == 0:
        return None
    ops, nbytes = counts.ops_bytes(ctx.pairs)
    return 100.0 * peaks.bound_s(ops, nbytes) * ctx.updates / seconds
