"""launches_per_update: device kernel launches (not copies or sets) in
the traced window's updates, over the number of updates."""


def read(ctx):
    if ctx.updates == 0:
        return None
    return sum(e.is_kernel for e in ctx.trace.update_events) / ctx.updates
