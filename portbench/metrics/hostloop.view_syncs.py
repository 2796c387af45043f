"""Host-device synchronisations per pass of the host loop's
``add_more_views`` in the traced job: the runtime's ``*Synchronize`` calls
inside the host copies of ``sfm.hostloop.view`` over their number, which
must be V - 2 (``portbench.spans``)."""
from portbench import spans


def read(ctx):
    return spans.mean_per_span(ctx, "sfm.hostloop.view", spans.is_sync, lambda v: v - 2)
