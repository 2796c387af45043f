"""Kernel launches per pass of the host loop's ``add_more_views`` (one view
registered, triangulated, merged and adjusted) in the traced job: the launch
calls inside the host copies of ``sfm.hostloop.view`` over their number,
which must be V - 2 (``portbench.spans``)."""
from portbench import spans


def read(ctx):
    return spans.mean_per_span(ctx, "sfm.hostloop.view", spans.is_launch, lambda v: v - 2)
