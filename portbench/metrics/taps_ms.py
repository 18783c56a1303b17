"""taps_ms: host milliseconds per update whose innermost program span is
of the observation layer (``efa.obs.*``: the taps' lookup or build and the
obs priors' gather), the host's waits on the card taken out."""

from portbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "obs")
