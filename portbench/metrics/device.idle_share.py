"""Share of the traced job in which no operation ran on the card, %:
1 - (the union of the device's kernel, copy and set intervals) / (the job's
span), both from one profiler session."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["window_ns"]:
        return None
    return 100.0 * (1.0 - tr["busy_ns"] / tr["window_ns"])
