"""K1's share of its roofline in the traced job, %: the least time its calls
could take on the card (``portbench.roofline.k1_bound_s`` of each call's
pairs and feature counts, as the job recorded them) over the device time of
the trace's K1 kernels (name holding ``match_top2``) in the job's span.
Nothing is read when those launches do not pair one to one with the
recorded calls."""
from portbench.roofline import k1_bound_s
from portbench.trace import kernel_times_ns

KERNEL = "match_top2"


def read(ctx):
    events, span, shapes = ctx.get("events"), ctx.get("span"), (ctx.get("calls") or {}).get(KERNEL)
    if not events or not span or not shapes:
        return None
    times = kernel_times_ns(events, span[0], span[1], KERNEL)
    if len(times) != len(shapes) or not sum(times):
        return None
    bound = sum(k1_bound_s(*s) for s in shapes)
    return 100.0 * bound / (sum(times) / 1e9)
