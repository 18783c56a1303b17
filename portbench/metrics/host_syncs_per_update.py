"""host_syncs_per_update: the host's synchronizations with the card
inside a program span, per update: each ``cudaStreamSynchronize``,
``cudaDeviceSynchronize`` or ``cudaEventSynchronize`` (a blocking copy
counts once, by its synchronize; ``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.syncs_per_update(ctx)
