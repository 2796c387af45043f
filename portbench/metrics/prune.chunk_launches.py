"""Kernel launches per epipolar-prune call of the collection pipeline (one
E-RANSAC call over 128 window pairs) in the traced job: the launch calls
inside the host copies of ``sfm.prune.chunk`` over their number
(``portbench.spans``). Nothing is read unless there are ceil(P / 128) of
them, P the pairs of the job's K1 calls."""
from portbench import spans

PAIR_ROWS = 128     # pairs per prune call (tpusfm_torch/pipeline/collection.py::_PAIR_ROWS)


def read(ctx):
    pairs = sum(c[0] for c in (ctx.get("calls") or {}).get("match_top2", []))
    found = spans.sound_spans(ctx, "sfm.prune.chunk")
    if found is None or len(found) != -(-pairs // PAIR_ROWS):
        return None
    return spans.mean_per_span(ctx, "sfm.prune.chunk", spans.is_launch)
