"""Kernel launches per FusedEngine add-view step in the traced job: the
launch calls inside the host copies of ``sfm.engine.step`` over their
number, which must be V - 2 (``portbench.spans``)."""
from portbench import spans


def read(ctx):
    return spans.mean_per_span(ctx, "sfm.engine.step", spans.is_launch, lambda v: v - 2)
