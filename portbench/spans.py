"""The program's own spans in a traced job, and what the host did inside them.

While a profiler records, tpusfm_torch opens a span named ``sfm.*`` around
each stage (``tpusfm_torch/utils/profiling.py``), an operator-scope record
that ``portbench.trace.events_of`` gives the kind ``host``. A
``record_function`` span would come twice under one name: the host's copy,
from the block's entry to its exit, and the copy the profiler lays on the
device's timeline, from the start of the first device operation the block
launched to the end of its last (kind ``annotation`` where torch reports
activity types, else by the device it ran on). So a host copy is an event
of the kind ``host`` or ``annotation`` that does not start where a device
operation starts: the host opens a span before its block launches
anything. Launches and syncs are counted in host copies only, each once.

A launch is a CUDA runtime or driver call that launches a kernel, and a
sync a runtime call with ``Synchronize`` in its name (stream, device or
event); each counts in a span when it starts inside the span's host copy.
A reader reads nothing (None) when the host copies do not match what the
program did: one ``sfm.run`` holding them all, copies of one name that
never overlap, and as many as the program makes where that is known (one
per add-view step: V - 2, V from the pairs the job's K1 calls matched).
"""
from __future__ import annotations

import math

import numpy as np

from portbench.trace import DEVICE_KINDS

LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx"})


def is_launch(name: str) -> bool:
    return name in LAUNCH_CALLS


def is_sync(name: str) -> bool:
    return "Synchronize" in name


def host_spans(events, name: str) -> np.ndarray:
    """(n, 2) int64 [start, end) of the host copies of span ``name``, by start."""
    found = [(s, e, kind) for n, kind, s, e in events
             if n == name and kind in ("host", "annotation")]
    device_starts = ({s for _, kind, s, _ in events if kind in DEVICE_KINDS}
                     if any(kind == "annotation" for *_, kind in found) else set())
    rows = sorted((s, e) for s, e, kind in found if s not in device_starts)
    return np.array(rows, np.int64).reshape(-1, 2)


def host_call_starts(events, pred) -> np.ndarray:
    """Sorted starts of the host's calls whose name satisfies ``pred``."""
    return np.sort(np.array([s for n, kind, s, _ in events if kind == "host" and pred(n)],
                            np.int64))


def counts_in(starts: np.ndarray, spans: np.ndarray) -> np.ndarray:
    """For each [start, end) of ``spans``, how many sorted ``starts`` it holds."""
    return (np.searchsorted(starts, spans[:, 1], side="left")
            - np.searchsorted(starts, spans[:, 0], side="left"))


def views_of(calls) -> int | None:
    """The job's view count V from its K1 calls, which matched all V(V-1)/2
    pairs between them; None when the pairs are no such count."""
    pairs = sum(c[0] for c in (calls or {}).get("match_top2", []))
    v = int(round((1 + math.sqrt(1 + 8 * pairs)) / 2))
    return v if pairs and v * (v - 1) // 2 == pairs else None


def sound_spans(ctx, name: str, expected=None) -> np.ndarray | None:
    """The host copies of ``name`` in the traced job, or None when they do not
    match the program: no copy, a copy outside the job's one ``sfm.run``,
    two copies that overlap, or a count other than ``expected(V)``."""
    events = ctx.get("events")
    if not events:
        return None
    runs, spans = host_spans(events, "sfm.run"), host_spans(events, name)
    if len(runs) != 1 or not len(spans):
        return None
    if spans[0, 0] < runs[0, 0] or spans[-1, 1] > runs[0, 1]:
        return None
    if (spans[1:, 0] < spans[:-1, 1]).any():
        return None
    if expected is not None:
        v = views_of(ctx.get("calls"))
        if v is None or len(spans) != expected(v):
            return None
    return spans


def mean_per_span(ctx, name: str, pred, expected=None) -> float | None:
    """Host calls satisfying ``pred`` inside the host copies of ``name``, over
    the number of copies (``sound_spans``)."""
    spans = sound_spans(ctx, name, expected)
    if spans is None:
        return None
    return float(counts_in(host_call_starts(ctx["events"], pred), spans).sum()) / len(spans)
