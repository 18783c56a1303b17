"""operands_host_ms: host milliseconds per update whose innermost program
span is of the ops layer (``efa.ops.*``: the panel weights and the body
kernels' torch operands), the host's waits on the card taken out."""

from portbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "ops")
