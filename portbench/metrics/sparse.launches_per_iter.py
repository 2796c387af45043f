"""Kernel launches per iteration of the COO LM (``ba/sparse.py::
lm_solve_sparse``, its CG loop included) in the traced job: the launch calls
inside all host copies of ``sfm.sparse.lm_iter`` over their number
(``portbench.spans``)."""
from portbench import spans


def read(ctx):
    return spans.mean_per_span(ctx, "sfm.sparse.lm_iter", spans.is_launch)
