"""Share of FusedEngine's add-view steps replayed from a CUDA graph in the
traced job, %: the host copies of ``sfm.engine.step`` that hold a graph
launch call (``cudaGraphLaunch``, ``cuGraphLaunch``) over their number,
which must be V - 2 (``portbench.spans``)."""
from portbench import spans

GRAPH_LAUNCH_CALLS = frozenset({"cudaGraphLaunch", "cuGraphLaunch"})


def read(ctx):
    steps = spans.sound_spans(ctx, "sfm.engine.step", lambda v: v - 2)
    if steps is None:
        return None
    launches = spans.host_call_starts(ctx["events"], GRAPH_LAUNCH_CALLS.__contains__)
    return 100.0 * float((spans.counts_in(launches, steps) > 0).mean())
