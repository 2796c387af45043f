"""Kernel launches in the traced job, counted in its profiler session."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["launches"]:
        return None
    return float(tr["launches"])
