"""Share of the COO LM's iterations (``ba/sparse.py::lm_solve_sparse``)
replayed from a CUDA graph in the traced job, %: the host copies of
``sfm.sparse.lm_iter`` that hold a graph launch call (``cudaGraphLaunch``,
``cuGraphLaunch``) over their number (``portbench.spans``)."""
from portbench import spans

GRAPH_LAUNCH_CALLS = frozenset({"cudaGraphLaunch", "cuGraphLaunch"})


def read(ctx):
    iters = spans.sound_spans(ctx, "sfm.sparse.lm_iter")
    if iters is None:
        return None
    launches = spans.host_call_starts(ctx["events"], GRAPH_LAUNCH_CALLS.__contains__)
    return 100.0 * float((spans.counts_in(launches, iters) > 0).mean())
