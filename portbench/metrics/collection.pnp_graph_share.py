"""Share of the collection's PnP registrations replayed from a CUDA graph in
the traced job, %: the host copies of ``sfm.collection.pnp`` that hold a
graph launch call (``cudaGraphLaunch``, ``cuGraphLaunch``) over their number
(``portbench.spans``). Their number is not checked against the view count:
a view with fewer than 8 correspondences opens no span."""
from portbench import spans

GRAPH_LAUNCH_CALLS = frozenset({"cudaGraphLaunch", "cuGraphLaunch"})


def read(ctx):
    calls = spans.sound_spans(ctx, "sfm.collection.pnp")
    if calls is None:
        return None
    launches = spans.host_call_starts(ctx["events"], GRAPH_LAUNCH_CALLS.__contains__)
    return 100.0 * float((spans.counts_in(launches, calls) > 0).mean())
