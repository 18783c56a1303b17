"""device_idle_pct: percent of the traced window in which no operation
ran on the device (100 minus the union of its event intervals)."""


def read(ctx):
    if ctx.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
