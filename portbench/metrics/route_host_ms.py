"""route_host_ms: host milliseconds per update whose innermost program
span is of the route layer (``efa.route.*``: the solve, the tail's panels
and the body's issue of its kernels), the host's waits on the card taken
out."""

from portbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "route")
