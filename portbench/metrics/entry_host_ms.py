"""entry_host_ms: host milliseconds per update whose innermost program
span is of the entry layer (``efa.entry.*``: the filter's construction,
formatting, diagnostics), the host's waits on the card taken out."""

from portbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "entry")
