"""Where a reconstruction spends its time on the GPU.

    python -m tpusfm_torch.tools.profile_fused [--host-loop] [--matcher NAME] [--seed N] [--out DIR]

Renders the 7-view 1024x768 textured scene, runs the fused pipeline (or,
with --host-loop, the host-driven loop, ``fused=False``) at the
reference's operating point once cold, then:

  * one warm run with the CUDA sync-debug mode on, counting the host
    synchronisations and where they are made: around every add-view step
    of the fused engine (each a replay of the step's CUDA graph), or
    around the whole run of the host loop;
  * one warm run without instrumentation, for the wall time;
  * one warm run under torch.profiler, for the number of kernel launches,
    the kernels by device time and the idle share: 1 - the union of the
    device's operations inside the run's own ``sfm.run`` span / that
    span's length, both on the profiler's clock;
  * for the host loop, the matching stage alone under the profiler (its
    launches per pair and device time, without the epipolar prune).

--matcher of|dense|surf|stereo profiles another matcher strategy; the
fused path is the rich matcher's only, so any other takes the host loop.
Prints one JSON line; the profiler table goes to DIR/profile_table.txt
(profile_table_host_loop[_<matcher>].txt with --host-loop).
Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import time
import traceback
import warnings


def run_span_busy(prof, span: str = "sfm.run"):
    """(seconds of the profiled run's ``span`` on the host, seconds in it in
    which the device ran an operation): the span's length and the union of
    the device's kernel, copy and set intervals clipped to it."""
    import torch

    ops, run = [], None
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((start, end))
        elif e.name() == span:
            run = (start, end)
    if run is None:
        raise SystemExit(f"no {span} span in the profile")
    busy, reach = 0, run[0]
    for start, end in sorted(ops):
        start, end = max(start, reach), min(end, run[1])
        if end > start:
            busy += end - start
            reach = end
    return (run[1] - run[0]) / 1e9, busy / 1e9


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host-loop", action="store_true",
                    help="profile the host-driven loop (fused=False) instead of the fused path")
    ap.add_argument("--matcher", choices=["rich", "of", "dense", "surf", "stereo"],
                    default="rich", help="matcher strategy; any but rich takes the host loop")
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args()
    args.host_loop = args.host_loop or args.matcher != "rich"

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpusfm_torch import MatcherKind, SfMConfig
    from tpusfm_torch.pipeline import SfMPipeline
    from tpusfm_torch.tools.synthetic import make_scene
    from tpusfm_torch.types import Intrinsics

    if not torch.cuda.is_available():
        raise SystemExit("profile_fused needs a CUDA device")
    imgs, _, K = make_scene(n_views=7, h=768, w=1024, seed=args.seed)
    cfg = SfMConfig(max_features=5120, max_matches=2048, engine_point_capacity=4096,
                    console_debug_level=5, fused=not args.host_loop,
                    matcher=MatcherKind(args.matcher))
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]), device="cuda")
    pipe = SfMPipeline(imgs, cfg, intrinsics=intr, seed=args.seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)      # map capacity notice
        pipe.run()

        where = collections.Counter()

        def record(message, category, filename, lineno, file=None, line=None):
            frames = [f"{os.path.basename(f.filename)}:{f.lineno}"
                      for f in traceback.extract_stack()[:-1] if "tpusfm_torch" in f.filename]
            where[" < ".join(reversed(frames[-3:]))] += 1

        def counted(fn):
            def call(*a, **k):
                shown = warnings.showwarning
                warnings.showwarning = record
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("always")
                        return fn(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                    warnings.showwarning = shown
            return call

        pipe.reset(args.seed)
        if args.host_loop:
            counted(pipe.run)()
        else:
            from tpusfm_torch.utils import cuda_graph

            replay = cuda_graph.Graph.replay
            cuda_graph.Graph.replay = counted(replay)
            try:
                pipe.run()
            finally:
                cuda_graph.Graph.replay = replay

        pipe.reset(args.seed)
        t0 = time.perf_counter()
        warm = pipe.run()
        wall_s = time.perf_counter() - t0              # warm, no profiler attached

        pipe.reset(args.seed)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rec = pipe.run()

        matching = None
        if args.host_loop:
            # the matching stage alone, without the epipolar prune that
            # match() runs after it: launches and device time per pair
            pipe.reset(args.seed)
            pipe.extract()
            pipe.cfg = dataclasses.replace(cfg, epipolar_prune=False)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as mprof:
                pipe.match()
            pipe.cfg = cfg
            mk = [e for e in mprof.key_averages() if e.device_type.name == "CUDA"]
            n_pairs = len(pipe.pairs)
            matching = {"pairs": n_pairs, "launches": sum(e.count for e in mk),
                        "launches_per_pair": sum(e.count for e in mk) / n_pairs,
                        "device_s": sum(e.self_device_time_total for e in mk) / 1e6,
                        "warm_matching_s": warm.stats["matching_s"]}
    run_s, busy_s = run_span_busy(prof)
    events = prof.key_averages()
    # kernel rows only: the aten rows repeat their kernels' device time
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    launches = sum(e.count for e in kernels)
    os.makedirs(args.out, exist_ok=True)
    table = ("profile_table.txt" if not args.host_loop else "profile_table_host_loop.txt"
             if args.matcher == "rich" else f"profile_table_host_loop_{args.matcher}.txt")
    with open(os.path.join(args.out, table), "w") as fh:
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "path": "host_loop" if args.host_loop else "fused",
        "matcher": args.matcher,
        "syncs_in_run" if args.host_loop else "syncs_in_add_view_steps": sum(where.values()),
        "sync_sites": dict(where.most_common(12 if args.host_loop else 6)),
        "warm_wall_s": wall_s,
        "warm_stage_s": warm.stats,
        "profiled_stage_s": rec.stats,
        "profiled_run_s": run_s,
        "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / run_s,
        "kernel_launches": launches,
        "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
        "matching_stage": matching,
    }), flush=True)


if __name__ == "__main__":
    main()
