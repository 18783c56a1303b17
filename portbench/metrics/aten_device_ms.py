"""aten_device_ms: device milliseconds per update in everything that is
not one of the port's own CUDA kernels: PyTorch's kernels (the torch
operands and glue), cuBLAS, copies and sets."""

from portbench import readers


def read(ctx):
    if ctx.updates == 0:
        return None
    s = sum(e.seconds for e in ctx.trace.update_events
            if readers.base_name(e.name) not in ctx.own)
    return 1e3 * s / ctx.updates
