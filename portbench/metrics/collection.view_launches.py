"""Kernel launches per pass of the collection's registration loop (a PnP
attempt and, when the view registers, its triangulation and local BA) in the
traced job: the launch calls inside the host copies of
``sfm.collection.view`` over their number (``portbench.spans``). The
collection matches a window of pairs, so the count of passes is not checked
against the view count."""
from portbench import spans


def read(ctx):
    return spans.mean_per_span(ctx, "sfm.collection.view", spans.is_launch)
