"""What the benchmark reads from one torch.profiler session.

``events_of`` turns a finished profiler session into plain tuples
``(name, kind, start_ns, end_ns)``, kind one of ``kernel``, ``memcpy``,
``memset`` (the device's operations), ``annotation`` (the benchmark's own
``record_function`` spans) and ``host`` (every other host-side event: aten
operators and CUDA runtime calls). Everything else here reads such tuples,
so it can be tested on a recorded list.
"""
from __future__ import annotations

import collections

import numpy as np

DEVICE_KINDS = ("kernel", "memcpy", "memset")


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


def events_of(prof):
    """Plain tuples of a finished ``torch.profiler.profile`` session."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        dev = str(e.device_type()).split(".")[-1].upper()
        act = str(getattr(e, "activity_type", lambda: "")()).lower()
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        if name.startswith("portbench.") or "annotation" in act:
            kind = "annotation"          # a record_function span, on the host or the device
        elif dev == "CUDA":
            low = name.lower()
            kind = "memcpy" if "memcpy" in low else "memset" if "memset" in low else "kernel"
        else:
            kind = "host"
        out.append((name, kind, start, end))
    return out


def span(events, name: str):
    """(start_ns, end_ns) of the host's annotation ``name``: the earliest of
    those so called (the profiler copies a span onto the device's timeline,
    where it opens when the span's first device operation starts)."""
    found = [(s, e) for n, kind, s, e in events if kind == "annotation" and n == name]
    if not found:
        raise LookupError(f"no span {name!r} in the trace")
    return min(found)


def device_intervals(events, start: int, end: int):
    """Device operations clipped to [start, end], sorted: (names, (n, 2) int64)."""
    rows = [(n, max(s, start), min(e, end)) for n, kind, s, e in events
            if kind in DEVICE_KINDS and e > start and s < end]
    rows.sort(key=lambda r: r[1])
    iv = np.array([[s, e] for _, s, e in rows], np.int64).reshape(-1, 2)
    return [r[0] for r in rows], iv


def busy_ns(iv: np.ndarray) -> int:
    """Length of the union of sorted intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return int(total)


def idle_gaps(iv: np.ndarray, start: int, end: int):
    """Stretches of [start, end] in which no device operation runs: (n, 2)."""
    gaps, cur = [], start
    for s, e in iv:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if end > cur:
        gaps.append((cur, end))
    return np.array(gaps, np.int64).reshape(-1, 2)


def kernel_launches(events, start: int, end: int) -> int:
    return sum(1 for _, kind, s, _ in events if kind == "kernel" and start <= s < end)


def top_device_ops(events, start: int, end: int, k: int = 10):
    """[[name, seconds], ...]: device time by operation name, largest first."""
    names, iv = device_intervals(events, start, end)
    by = collections.Counter()
    for n, (s, e) in zip(names, iv):
        by[n] += int(e - s)
    return [[n[:120], t / 1e9] for n, t in by.most_common(k)]


def gaps_by_host(events, start: int, end: int, k: int = 10):
    """[[name, seconds], ...]: the device's idle time summed by what the host
    had last begun when each idle stretch started (the host event, an aten
    operator or a CUDA runtime call, with the latest start before it), the
    largest first."""
    _, iv = device_intervals(events, start, end)
    gaps = idle_gaps(iv, start, end)
    host = sorted((s, n) for n, kind, s, e in events if kind == "host" and start <= s < end)
    starts = np.array([s for s, _ in host], np.int64)
    last = np.searchsorted(starts, gaps[:, 0], side="right") - 1
    by = collections.Counter()
    for i, (gs, ge) in zip(last.tolist(), gaps.tolist()):
        by[host[i][1][:120] if i >= 0 else "(before any host event)"] += ge - gs
    return [[n, t / 1e9] for n, t in by.most_common(k)]


def kernel_times_ns(events, start: int, end: int, needle: str):
    """Durations of the kernels whose name contains ``needle``, in launch order."""
    return [e - s for n, kind, s, e in sorted(events, key=lambda r: r[2])
            if kind == "kernel" and needle in n and start <= s < end]


def summarize(events, window: str = "portbench.job"):
    """What the result line takes from a trace: the traced window, the
    device's busy time in it, its kernel launches and the ``breakdown``.
    Per-layer readers get the events and the span themselves."""
    start, end = span(events, window)
    _, iv = device_intervals(events, start, end)
    return {
        "window_ns": end - start,
        "busy_ns": busy_ns(iv),
        "launches": kernel_launches(events, start, end),
        "device_ops": top_device_ops(events, start, end),
        "idle_gaps": gaps_by_host(events, start, end),
    }
