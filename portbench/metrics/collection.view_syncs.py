"""Host-device synchronisations per pass of the collection's registration
loop in the traced job: the runtime's ``*Synchronize`` calls inside the host
copies of ``sfm.collection.view`` over their number (``portbench.spans``)."""
from portbench import spans


def read(ctx):
    return spans.mean_per_span(ctx, "sfm.collection.view", spans.is_sync)
