"""Per-layer metric readers: ``<metric>.py`` holds ``read(ctx) -> float | None``.

``ctx["jobs"]``: the window's jobs, each ``{"stats": the pipeline's timings,
"seconds": ...}``. With ``--trace 1``: ``ctx["events"]``, every event of the
traced job's profiler session as ``(name, kind, start_ns, end_ns)``
(``portbench.trace``); ``ctx["span"]``, the job's own (start_ns, end_ns);
``ctx["trace"]``, ``portbench.trace.summarize`` of them; ``ctx["calls"]``,
the calls the job kind recorded, by the name of the kernel each launches
(``{"match_top2": [(pairs, query features, key features), ...]}``).
Without a trace those are None (``calls``: empty). A reader that finds
nothing to read returns None and the metric is left out.
"""
from __future__ import annotations


def mean_stat(ctx, keys, only_with: str | None = None):
    """Mean over the window's jobs of a stage timing (or a sum of several),
    over the jobs whose timings hold it (and ``only_with``)."""
    keys = (keys,) if isinstance(keys, str) else keys
    vals = [sum(float(s.get(k, 0.0)) for k in keys) for s in (j["stats"] for j in ctx["jobs"])
            if any(k in s for k in keys) and (only_with is None or only_with in s)]
    return sum(vals) / len(vals) if vals else None
