"""select_device_ms: device milliseconds per update of the work that the
LETKF's neighbour selection issues: the device events whose runtime call
the host made inside a ``efa.ops.letkf_select`` span (each chunk's
selection and the obs-space one: the chordal dots, the int64 keys and
``topk``).  None where the window has no such span."""

import bisect

SPAN = "efa.ops.letkf_select"


def read(ctx):
    spans = sorted((b, e) for b, e, name in ctx.trace.host if name == SPAN)
    if not spans or ctx.updates == 0:
        return None
    starts = [b for b, _ in spans]
    seconds = 0.0
    for ev in ctx.trace.update_events:
        if ev.launch_us is None:
            continue
        i = bisect.bisect_right(starts, ev.launch_us) - 1
        if i >= 0 and ev.launch_us <= spans[i][1]:
            seconds += ev.seconds
    return 1e3 * seconds / ctx.updates
