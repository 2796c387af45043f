"""Profiling utilities (counterpart of ``tpusfm/utils/profiling.py``).

The reference's tracing surface: the CV_PROFILE wall-clock macro
(legacy/SfMToyLib_Old/Common.h:66-75, enabled by USE_PROFILING) and the
inline stage timers that print seconds and points/s
(FindCameraMatrices.cpp:385-487, Triangulation.cpp:150-232) — plus
device-side traces through ``torch.profiler``, viewable in
Perfetto/chrome://tracing.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable, Dict, Optional

_ACCUM: Dict[str, float] = {}
_COUNTS: Dict[str, int] = {}


@contextlib.contextmanager
def profile(name: str, verbose: bool = False, items: Optional[int] = None):
    """CV_PROFILE equivalent: time a block on the host's clock, accumulate
    by name. Device work is asynchronous: synchronize inside the block when
    the block must include it.

    With ``items`` set, also reports items/s (the reference's points/s
    prints, Triangulation.cpp:230-232).
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _ACCUM[name] = _ACCUM.get(name, 0.0) + dt
        _COUNTS[name] = _COUNTS.get(name, 0) + 1
        if verbose:
            rate = f", {items / dt:.0f}/s" if items else ""
            print(f"[profile] {name}: {dt * 1000:.1f} ms{rate}", flush=True)


def profiled(fn: Callable) -> Callable:
    """Decorator form of profile()."""

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with profile(fn.__qualname__):
            return fn(*a, **kw)

    return wrapper


def report() -> Dict[str, Dict[str, float]]:
    """Accumulated timings: {name: {total_s, calls, mean_ms}}."""
    return {
        k: {"total_s": v, "calls": _COUNTS[k], "mean_ms": 1000.0 * v / _COUNTS[k]}
        for k, v in sorted(_ACCUM.items(), key=lambda kv: -kv[1])
    }


def reset():
    _ACCUM.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def trace_to(logdir: str):
    """Device-level trace via ``torch.profiler`` (host ops, and CUDA kernels
    when a card is present): writes ``<logdir>/trace.json`` in the Chrome
    trace format and yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
