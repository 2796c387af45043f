"""The collection-scale reconstruction on the GPU, timed and profiled.

    python -m tpusfm_torch.tools.collection_run [--views N] [--seed S] [--no-syncs]
                                [--no-profile] [--profile-every N] [--out DIR]

Renders the textured ring collection (``tools/synthetic.py::
make_collection_scene``, 256x192) at N views (default 500) and reconstructs
it with ``CollectionPipeline`` at the configuration of the reference's
500-image benchmark: 1024 features, 512 matches, window 6 with wraparound,
local BA over 8 cameras, global BA every 50 registrations,
``ba_incremental_iterations=10``, ``ba_max_iterations=75``,
``ba_share_focal=False``, ``min_point_count_for_homography=60``.

Runs, in order (a run on the first 24 views first absorbs the kernel build
and the libraries' start-up):

  1. one run without instrumentation: stage timings, registered cameras,
     points, observations, mean reprojection, ATE to the rendered orbit after
     similarity alignment, BA iterations, K1 launches;
  2. the last final global solve of that run again, twice, on the same
     inputs: how far two runs of one solve differ (``index_add_`` adds with
     atomics in no fixed order);
  3. the host synchronisations (CUDA sync-debug mode) made inside one LM step
     of that solve, CG loop included, and inside one ``tri_multi`` call; and,
     unless --no-syncs, one whole run with the mode on, counting them by site;
  4. unless --no-profile: one run in which every --profile-every-th call of
     each device stage (matcher chunk, prune, PnP, triangulation, one local
     solve, one chunk of a global solve, ...) runs under torch.profiler,
     device activity only, and the other calls are timed between two
     synchronisations (a profile of a whole run's millions of launches
     takes many times the run). Per stage: calls, launches, device time and
     host time per call; for the run: launches and device busy time
     estimated as calls x the profiled calls' mean, and the idle share
     1 - busy / the wall time of run 1.

Prints one JSON line after run 3's single calls and the whole of it as the
last line; the kernels by device time go to DIR/collection_kernels.txt.
Needs one NVIDIA GPU (``--device cpu`` rehearses runs 1 and 2 at a small N;
it measures nothing of the device).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import time
import traceback
import warnings

BENCH_CONFIG = dict(max_features=1024, max_matches=512, collection_window=6,
                    collection_wraparound=True, collection_local_ba_cams=8,
                    collection_global_ba_interval=50, ba_incremental_iterations=10,
                    ba_max_iterations=75, ba_share_focal=False,
                    min_point_count_for_homography=60)
ORBIT_DIAMETER = 12.0
DEVICE_STAGES = ("_extract", "_match_chunk", "_epi_prune", "_h_rank", "_two_view", "_tri_rows",
                 "_pnp", "_tri_multi", "_local_ba", "_global_ba", "_final_ba")


def make_pipeline(imgs, K, seed, device, console_debug_level=5, **overrides):
    from tpusfm_torch import SfMConfig
    from tpusfm_torch.pipeline import CollectionPipeline
    from tpusfm_torch.types import Intrinsics

    cfg = SfMConfig(**dict(BENCH_CONFIG, **overrides), console_debug_level=console_debug_level)
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
    return CollectionPipeline(imgs, cfg, intrinsics=intr, seed=seed, device=device)


def quality(rec, gt_poses):
    """The numbers a reconstruction is judged by."""
    from tpusfm_torch.eval import ate_rmse

    pv = rec.pose_valid
    return {
        "registered_cameras": int(pv.sum()),
        "points": int(rec.num_points),
        "observations": int(len(rec.obs_point)),
        "mean_reprojection_px": float(rec.mean_reprojection_error),
        "ate": ate_rmse(rec.poses[pv], gt_poses[pv]) if pv.sum() >= 3 else float("inf"),
        "orbit_diameter": ORBIT_DIAMETER,
        "ba_iterations": int(rec.stats.get("ba_iters", 0)),
        "ba_iterations_local": int(rec.stats.get("ba_iters_local", 0)),
        "ba_iterations_global": int(rec.stats.get("ba_iters_global", 0)),
    }


class SyncCounter:
    """Counts host synchronisations (CUDA sync-debug warnings) by call site
    while active."""

    def __init__(self):
        self.where = collections.Counter()

    def _record(self, message, category, filename, lineno, file=None, line=None):
        frames = [f"{os.path.basename(f.filename)}:{f.lineno}"
                  for f in traceback.extract_stack()[:-1] if "tpusfm_torch" in f.filename
                  and "collection_run" not in f.filename]
        self.where[" < ".join(reversed(frames[-3:]))] += 1

    def __enter__(self):
        import torch

        self._shown = warnings.showwarning
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._record
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(0)
        warnings.showwarning = self._shown
        self._catch.__exit__(*exc)

    @property
    def total(self) -> int:
        return sum(self.where.values())


class SampledProfile:
    """torch.profiler around every ``every``-th call of each device stage of
    a pipeline (the first call of each stage included), device activity
    only; the other calls are timed on the host clock between two
    synchronisations. A profile of a whole run's millions of launches
    takes many times the run, so the run's launches and busy time are
    estimated per stage: calls x the mean of the profiled calls."""

    def __init__(self, every: int):
        self.every = every
        self.rows = {}
        self.by_kernel = collections.Counter()

    def wrap(self, pipe):
        import torch
        from torch.profiler import ProfilerActivity, profile

        for name in DEVICE_STAGES:
            row = self.rows[name] = dict(calls=0, timed=0, wall_s=0.0, profiled=0,
                                         launches=0, device_us=0.0)

            def call(*a, _fn=getattr(pipe, name), _row=row, **k):
                _row["calls"] += 1
                torch.cuda.synchronize()
                if _row["calls"] % self.every == 1 or self.every == 1:
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        out = _fn(*a, **k)
                        torch.cuda.synchronize()
                    _row["profiled"] += 1
                    # kernel rows only (the runtime's launch calls are host rows)
                    for e in prof.key_averages():
                        if e.device_type.name == "CUDA":
                            _row["launches"] += e.count
                            _row["device_us"] += e.self_device_time_total
                            self.by_kernel[e.key] += e.self_device_time_total
                else:
                    t0 = time.perf_counter()
                    out = _fn(*a, **k)
                    torch.cuda.synchronize()
                    _row["wall_s"] += time.perf_counter() - t0
                    _row["timed"] += 1
                return out

            setattr(pipe, name, call)

    def summary(self):
        """Per stage: calls, launches and device ms per call (profiled calls),
        host ms per call (the other calls), and the run's estimated totals."""
        stages, launches, busy_s = {}, 0.0, 0.0
        for name, r in self.rows.items():
            if not r["profiled"]:
                continue
            per_launches = r["launches"] / r["profiled"]
            per_busy_ms = r["device_us"] / 1e3 / r["profiled"]
            launches += r["calls"] * per_launches
            busy_s += r["calls"] * per_busy_ms / 1e3
            stages[name] = {"calls": r["calls"], "profiled_calls": r["profiled"],
                            "launches_per_call": per_launches, "device_ms_per_call": per_busy_ms,
                            "host_ms_per_call": (r["wall_s"] * 1e3 / r["timed"]
                                                 if r["timed"] else None)}
        return stages, launches, busy_s


def solve_spread(pipe, last_final):
    """Run the last final global solve twice more on its own inputs."""
    import torch

    outs = [pipe._final_ba(*last_final) for _ in range(2)]
    (Rt_a, X_a, _, s_a), (Rt_b, X_b, _, s_b) = outs
    return {
        "lm_iterations": [int(s_a.iterations), int(s_b.iterations)],
        "final_cost": [float(s_a.final_cost), float(s_b.final_cost)],
        "max_abs_pose_diff": float((Rt_a - Rt_b).abs().max()),
        "max_abs_point_diff": float((X_a - X_b).abs().max()),
        "bit_identical": bool(torch.equal(Rt_a, Rt_b) and torch.equal(X_a, X_b)),
        "observations": int(last_final[3].shape[0]), "points": int(last_final[2].shape[0]),
    }


def unit_syncs(pipe, last_final):
    """Host syncs inside one LM step of the final solve (the CG loop and all
    around it) and inside one tri_multi call, counted on their own."""
    import torch

    from tpusfm_torch import camera
    from tpusfm_torch.ba.sparse import SparseBAProblem, _lm_step_sparse

    poses, free, pts, ci, pi, uv, w, K = last_final
    prob = SparseBAProblem(
        cams=torch.cat([camera.matrix_to_rodrigues(poses[..., :3]), poses[..., 3]], 1),
        points=pts, focal=K[0, 0], cam_idx=ci, pt_idx=pi, uv=uv - K[:2, 2], w=w,
        cam_free=free.to(pts.dtype))
    lam = torch.full((), 1e-3, device=pts.device)
    B = 4096
    Rt = poses[torch.arange(B * 8, device=pts.device).reshape(B, 8) % len(poses)]
    uv8 = torch.rand(B, 8, 2, device=pts.device) * 100.0
    m8 = torch.ones(B, 8, device=pts.device)
    torch.cuda.synchronize()
    with SyncCounter() as lm_short:
        _lm_step_sparse(prob, lam, False, 8, pipe.cfg.collection_huber_px)
    with SyncCounter() as lm:
        _lm_step_sparse(prob, lam, False, pipe._final_cg, pipe.cfg.collection_huber_px)
    with SyncCounter() as tri:
        pipe._tri_multi(Rt, uv8, m8, pipe.intr.K, pipe.intr.Kinv)
    torch.cuda.synchronize()
    return {"lm_step_with_cg_loop": lm.total, "cg_iterations": pipe._final_cg,
            "lm_step_with_8_cg_iterations": lm_short.total,
            "tri_multi": tri.total, "sites": dict((lm.where + tri.where).most_common(6))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-syncs", action="store_true",
                    help="skip the whole run that counts host syncs by site")
    ap.add_argument("--no-profile", action="store_true", help="skip the profiler run")
    ap.add_argument("--profile-every", type=int, default=10,
                    help="profile every N-th call of each device stage")
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args()

    import torch

    from tpusfm_torch.features import pallas_match
    from tpusfm_torch.tools.common import device_and_card
    from tpusfm_torch.tools.synthetic import make_collection_scene

    device, card = device_and_card(args.device)
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    imgs, gt_poses, K = make_collection_scene(n_views=args.views, seed=args.seed)
    render_s = time.perf_counter() - t0
    print(f"# rendered {imgs.shape} in {render_s:.1f}s on {card}", flush=True)

    if on_card:       # the build and the libraries' start-up, outside every timing
        try:
            make_pipeline(imgs[:24], K, args.seed, args.device, collection_wraparound=False).run()
        except RuntimeError as e:        # an arc this short may find no baseline: still warm
            print(f"# warm-up run: {e}", flush=True)

    # ---- 1. the run that is timed
    pipe = make_pipeline(imgs, K, args.seed, args.device, console_debug_level=1)
    last_final = []
    final_ba = pipe._final_ba

    def spy_final(*a):
        last_final[:] = [x.clone() for x in a]
        return final_ba(*a)

    pipe._final_ba = spy_final
    pallas_match.match_topk2.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = pipe.run()
    if on_card:
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    pipe._final_ba = final_ba
    out = {"card": card, "views": args.views, "seed": args.seed, "render_s": render_s,
           "wall_s": wall_s, "stage_s": rec.stats, **quality(rec, gt_poses),
           "match_top2_launches": pallas_match.match_topk2.launches,
           "pairs": int(len(pipe.pairs)),
           "cg_iterations": {"local": 32, "interval": pipe._interval_cg, "final": pipe._final_cg}}
    if on_card:
        out["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()

    # ---- 2. one solve, twice
    out["final_solve_twice"] = solve_spread(pipe, last_final)

    # ---- 3. host syncs
    if on_card:
        out["unit_syncs"] = unit_syncs(pipe, last_final)
    print(json.dumps(out), flush=True)          # kept if a later run is cut
    if on_card and not args.no_syncs:
        pipe = make_pipeline(imgs, K, args.seed, args.device)
        with SyncCounter() as syncs:
            rec_s = pipe.run()
        out.update(syncs_in_run=syncs.total, sync_sites=dict(syncs.where.most_common(12)),
                   sync_run_ba_iterations=int(rec_s.stats["ba_iters"]))
        print(json.dumps(out), flush=True)

    # ---- 4. launches and device time, sampled
    if on_card and not args.no_profile:
        pipe = make_pipeline(imgs, K, args.seed, args.device)
        sampled = SampledProfile(args.profile_every)
        sampled.wrap(pipe)
        rec_p = pipe.run()
        stages, launches, busy_s = sampled.summary()
        top = sampled.by_kernel.most_common(40)
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "collection_kernels.txt"), "w") as fh:
            fh.write(f"{card}, {args.views} views, every {args.profile_every}th call of each "
                     "stage: kernels by device time (ms)\n")
            fh.writelines(f"{us / 1e3:12.3f}  {name}\n" for name, us in top)
        out.update(profile_every=args.profile_every, profiled_stages=stages,
                   kernel_launches_estimated=launches, device_busy_s_estimated=busy_s,
                   device_idle_share_estimated=1.0 - busy_s / wall_s,
                   profiled_run_ba_iterations=int(rec_p.stats["ba_iters"]),
                   top_kernels_ms={name[:60]: us / 1e3 for name, us in top[:8]})
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
