"""Kernel launches per iteration of the dense LM (``ba/lm.py::lm_solve``) in
the traced job: the launch calls inside all host copies of
``sfm.ba.lm_iter`` over their number (``portbench.spans``)."""
from portbench import spans


def read(ctx):
    return spans.mean_per_span(ctx, "sfm.ba.lm_iter", spans.is_launch)
