#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py [--seed N]

Needs one NVIDIA GPU (Hopper, sm_90a) and nvcc; imports nothing of JAX.
Phases, each of which must pass or the script exits non-zero:

  1. build every CUDA kernel of the main path from the sources in
     tpusfm_torch/csrc (one nvcc per source, all started together);
  2. hold each kernel against its plain PyTorch version on the card,
     bit for bit (K1 at P=21, F=5120 with 5% invalid rows, at F=1536 and
     1792, on ties with an all-invalid pair, with F1 != F2, with the
     best and its equal in different key tiles and different threads of
     a quad, and at the collection pipeline's chunks, P=256 and P=192 at
     F=1024);
  3. time each kernel with CUDA events (median over windows of
     back-to-back launches, after warm-up) beside its plain version and
     its bound, at the main path's shape, at P=210, F=2048, at the
     collection's P=256, F=1024, at the scale bench's P=128, F=5120 and at
     the Strecha fixture's P=36, F=2048, and time the bare int8 product
     through torch._int_mm for comparison;
  4. render the 7-view 1024x768 textured scene from --seed and run
     tpusfm_torch.pipeline.SfMPipeline(...).run() at the reference's
     operating point (5120 features, 2048 matches, 4096 map points), once
     cold and once warm with every launch counter set to 0 just before;
     check the device, the launch counts, the registered cameras, the
     reprojection error and the ATE to the ground truth; and hold the
     card's keypoints, descriptors and matches against the CPU's;
  5. the host-driven loop at the same width, once through the command
     line (tpusfm_torch.cli.main on a directory of PNGs with an OpenCV
     calibration YAML, --live-html, --html and --sor-filter: the live
     viewer is a listener, so the pipeline leaves the fused path) and once
     by stages (extract, match, find_baseline_triangulation,
     save_checkpoint; load_checkpoint into a second pipeline,
     add_more_views). Checks: tensors on the card, K1 launched, the
     listener's calls, the same gates as phase 4 for both runs, and the
     exported files against the reported number of points. Then the native
     C++ runtime's build report (tpusfm_torch/native.py, built from csrc/):
     the track graph must build (the image decoder may not, for want of
     jpeglib.h; its reason is printed), and the host loop runs once on its
     merge and once on the numpy merge from the same seed, both held to the
     gates (the two merges are not the same function, in tpusfm either);
  6. the collection-scale path: render the textured ring collection at
     256x192 and run tpusfm_torch.pipeline.CollectionPipeline(...).run() at
     the widths of the 500-image configuration (1024 features, 512 matches,
     window 6 with wraparound, local BA over 8 cameras, global BA every 50
     registrations) on COLLECTION_VIEWS views. Checks: K1 launched once per
     chunk of 256 window pairs, every solver's tensors on the card,
     registered cameras, reprojection error, ATE against the orbit's
     diameter, BA iterations, and the two PLY files' counts;
  7. the other matcher strategies (optical flow, dense, stereo, SURF blobs) at
     the operating point of phase 4: SfMPipeline(...).run() on the card for
     each (the host-driven loop: the fused path is the rich matcher's only),
     and, on pairs (0,1), (2,3) and (0,6), the front half again on the CPU.
     Checks: tensors on the card, no K1 launch, the card's keypoints and
     matches against the CPU's (phase 4's bars), and the gates: where tpusfm
     meets phase 4's bars with a strategy on this scene (STRATEGY_REFERENCE),
     the card meets them too; where it does not, the card registers at least
     tpusfm's cameras less one. Then python -m tpusfm_torch.cli on phase 5's
     directory with --matcher of.
  8. the distributed path (tpusfm_torch.dist), which one card shows two ways.
     (a) A world of one NCCL rank in this process: match_all_pairs_sharded at
     the collection's chunk (P=256 pairs, F=1024, 512 matches), K1 launched
     once and equal bit for bit to the unsharded match_pairs and to K1's
     plain version; match_all_pairs_ring on 8 views (one launch); the dense
     sharded adjuster at SCALE_BENCH's 16,384 points x 32 cameras and the COO
     one at 500 cameras x 200,000 points x 800,000 observations (32 CG
     iterations per LM step), both from --seed with 0.4 px of pixel noise,
     solved to convergence (function tolerance 1e-8 or five rejected steps,
     within 200 LM iterations) and equal bit for bit to the unsharded
     solves; then the checks of tools/dryrun_multichip.py. (b) Two gloo
     ranks on the one card,
     in processes of their own (this script with --dist-worker): both
     adjusters at those sizes against (a)'s one-process solves, final cost
     within 5% and camera centres within 2e-3 after similarity alignment.
     Prints the wall time per LM iteration of each solve and which
     collectives went through host tensors (gloo takes CUDA tensors for
     all_reduce only).
  9. the reference's self-rendering benchmarks, through the port's tools
     (tpusfm_torch/tools/). (a) strecha_eval: the Strecha-format fixture (9
     views, 512x384, k1=-0.2, k2=0.05) rendered on the card, its view 0 held
     to the CPU's render (<= 1 LSB), then the calibrated fused run at each of
     FIXTURE_SEEDS with the coefficients and without: every run >= 8/9
     cameras and one K1 launch, at least FIXTURE_MIN_GOOD of the runs with
     the coefficients < 1 px and ATE < 1% of the camera spread (the
     reconstruction is bimodal, in tpusfm too) and their median ATE under
     that limit, the undistortion moving keypoints by more than 5 px
     somewhere, the runs without the coefficients worse in median
     reprojection error and ATE, and K1 on seed 0's descriptors (36 pairs,
     F=2048) equal to its plain version bit for bit.
     (b) stress4k: 7 views at 3072x2048, 5120 features, cold and warm:
     >= 6/7 cameras, < 1 px, ATE < 5% of the spread, K1 launched once in the
     warm run. (c) scale_bench: K1 at P=128, F=5120 (bit for bit against its
     plain version on 4 of the pairs), then its pairs/s, the dense sharded
     LM on a world of one NCCL rank and the COO LM at 500 x 200k x 800k,
     each solve lowering its cost. (d) config5_partial at BENCH_C5_VIEWS
     views (cut from 5000): window 8 with wraparound, pairs = 8 V, K1 once
     per 256 pairs, tracks, one global Huber BA from perturbed ground truth
     lowering its cost, < 1 px. Each sub-phase prints its seconds.

The last lines are the host loop's, the collection run's, the strategies'
and the benchmarks' numbers (JSON), the kernel table (JSON), the card's name
and power limit, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# H100 SXM peaks (NVIDIA data sheet, dense): int8 tensor-core ops and HBM3 bytes
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

OPERATING_POINT = dict(max_features=5120, max_matches=2048, engine_point_capacity=4096,
                       console_debug_level=5)
MIN_CAMERAS = 6         # of 7: every pair of the arc overlaps; allow one failed registration
MAX_REPROJ_PX = 1.0
MAX_ATE_FRAC = 0.05     # ATE to ground truth, as a fraction of the camera spread
# Card vs CPU front half. Harris scores differ in the last float bits between
# the devices' convolutions, so a keypoint tied with another to round-off may
# fall on either side of the top-k cut (and its matches with it); a keypoint
# found on both lies within round-off of itself, a different one >= 1 px away.
KEYPOINT_TOL_PX = 0.01
MIN_SAME_KEYPOINTS = 0.99
MIN_SAME_MATCHES = 0.97
# Phase 6. The ring is always the full circle, so fewer views mean a wider
# step between neighbours and a harder scene: at 120 views (3 degrees) the
# ATE lands on either side of its gate, in tpusfm as in the port (0.51-0.67
# of the 0.6 allowed); 160 views (2.25 degrees) meet every gate and have
# three interval global BAs (at 50, 100 and 150 registrations) before the
# two final ones.
COLLECTION_VIEWS = 160
COLLECTION_MIN_CAMERAS = 0.95       # of the views
COLLECTION_ORBIT_DIAMETER = 12.0    # ATE < MAX_ATE_FRAC of it
# Phase 7. tpusfm on the CPU with each strategy on phase 4's scene (--seed 0),
# as tests/reference_strategies.py prints it: registered cameras and whether
# it meets phase 4's bars. Stereo assumes rectified pairs and seeds only its
# baseline; optical flow registers 6 of 7 with an ATE of 0.49 (12% of the
# spread).
STRATEGY_REFERENCE = {"of": (6, False), "dense": (7, True), "stereo": (2, False),
                      "surf": (7, True)}
STRATEGY_PAIRS = ((0, 1), (2, 3), (0, 6))
# Phase 8: the sizes of SCALE_BENCH.json's two bundle adjusters, solved to convergence
# (converged solves stop by tolerance or stall well inside DIST_ITERS). Each COO point is
# seen by four cameras obs_stride apart along the ring: seen by four neighbours (0.24
# units of baseline at depths of 20-80) the optimum is so flat along the chain that one
# process and two ranks, whose sums add in different orders, both converge (67 LM
# iterations) with camera centres 5.7e-3 apart after alignment (seed 0; the 2e-3 bar is
# dryrun_multichip's).
DIST_DENSE = dict(n_points=16384, n_cams=32)
DIST_COO = dict(n_cams=500, n_points=200_000, obs_per_pt=4, obs_stride=25)
DIST_ITERS, DIST_FTOL, DIST_CG, DIST_NOISE_PX = 200, 1e-8, 32, 0.4
DIST_COST_RTOL, DIST_POSE_TOL = 0.05, 2e-3
DIST_MATCH = dict(P=256, F=1024, M=512, V=48)
# Phase 9 (a). The fixture's reconstruction is bimodal in both packages: whether the
# trajectory is right depends on which baseline pair the random ranking tries first
# (the port's seed 0 on the card starts from views 0 and 4 and ends with ATE 1.02; its
# good runs, ATE 0.009-0.020). A run counts as good at ATE < FIXTURE_MAX_ATE_FRAC of
# the camera spread (0.0500 of 4.996), between the good runs' largest ATE (the port
# 0.0198 on the card, tpusfm 0.0184 on the CPU) and the smallest without the
# coefficients (0.171 on the card), which the 5% bar of phases 4-6 (0.250) does not
# separate. tpusfm meets these bars at 20 of seeds 0-23 on the CPU, the port at 20 of
# 24 on the card; 5 of 8 is the least tpusfm's rate gives 8 runs at a one-sided 5% (3.3%).
FIXTURE_SEEDS = tuple(range(8))
FIXTURE_MIN_GOOD = 5
FIXTURE_MAX_ATE_FRAC = 0.01
# Phase 9 (d): the config-5 probe's views, cut from 5000 (its other widths as they are)
BENCH_C5_VIEWS = 1000
COLLECTION_SOLVERS = ("_match_chunk", "_epi_prune", "_h_rank", "_two_view", "_tri_rows", "_pnp",
                      "_tri_multi", "_local_ba", "_global_ba", "_final_ba")


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def check_gates(what, poses, pose_valid, n_points, reproj_px, gt_poses, bars=True):
    """The reconstruction gates: cameras, reprojection error, ATE to the
    ground truth. Prints the numbers and returns them; bars=False only
    prints them."""
    import numpy as np

    from tpusfm_torch.eval import ate_rmse, camera_centers

    n_cam = int(pose_valid.sum())
    gt_c = camera_centers(gt_poses[pose_valid])
    spread = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
    ate_gt = ate_rmse(poses[pose_valid], gt_poses[pose_valid]) if n_cam >= 3 else float("inf")
    print(f"{what}: {n_cam}/{len(pose_valid)} cameras, {n_points} points, mean reprojection "
          f"{reproj_px:.4f} px, ATE {ate_gt:.5f} (spread {spread:.3f})", flush=True)
    if not bars:
        return n_cam, ate_gt, spread
    check(n_cam >= MIN_CAMERAS, f"{what}: only {n_cam}/{len(pose_valid)} cameras registered")
    check(reproj_px < MAX_REPROJ_PX, f"{what}: reprojection error {reproj_px} too large")
    check(ate_gt < MAX_ATE_FRAC * spread,
          f"{what}: ATE {ate_gt} >= {MAX_ATE_FRAC} x spread {spread}")
    return n_cam, ate_gt, spread


def spy_devices(pipe, seen: set):
    """Record the device of what pipe's matcher and bundle adjustment return."""
    match_fn, ba_fn = pipe._match, pipe._ba

    def match(feats, pairs):
        m = match_fn(feats, pairs)
        seen.update({("features", feats.xy.device.type), ("matches", m.idx.device.type)})
        return m

    def ba(*a, **k):
        out = ba_fn(*a, **k)
        seen.add(("ba", out[0].device.type))
        return out

    pipe._match, pipe._ba = match, ba


def collection_phase(seed, pallas_match, card):
    """Phase 6: the collection-scale path on the card. Returns the K1
    launches of the run."""
    import math

    import numpy as np

    from tpusfm_torch.eval import ate_rmse
    from tpusfm_torch.tools.collection_run import make_pipeline
    from tpusfm_torch.tools.synthetic import make_collection_scene

    V = COLLECTION_VIEWS
    t0 = time.perf_counter()
    imgs, gt_poses, K = make_collection_scene(n_views=V, seed=seed)
    print(f"phase 6: rendered {imgs.shape} in {time.perf_counter() - t0:.1f}s", flush=True)
    pipe = make_pipeline(imgs, K, seed, "cuda", console_debug_level=1)
    check(pipe.device.type == "cuda" and pipe.intr.K.device.type == "cuda" and pipe.mesh is None,
          "the collection pipeline is not on the card")
    seen = set()
    for name in COLLECTION_SOLVERS:
        def spied(*a, _fn=getattr(pipe, name), _name=name, **k):
            out = _fn(*a, **k)
            first = out[0] if isinstance(out, tuple) else getattr(out, "idx", out)
            seen.update({(_name, first.device.type)}
                        | {(_name, x.device.type) for x in a if hasattr(x, "device")})
            return out
        setattr(pipe, name, spied)
    pallas_match.match_topk2.launches = 0
    rec = pipe.run()
    launches = pallas_match.match_topk2.launches
    P = len(pipe.pairs)
    check(P == 6 * V, f"{P} window pairs for {V} views")
    check(launches == math.ceil(P / 256), f"K1 launched {launches} times for {P} pairs")
    check(seen == {(name, "cuda") for name in COLLECTION_SOLVERS},
          f"collection solvers off the card or not run: {sorted(seen)}")
    check(pipe.features is None, "the descriptors were not freed after matching")
    pv = rec.pose_valid
    n_cam = int(pv.sum())
    ate = ate_rmse(rec.poses[pv], gt_poses[pv]) if n_cam >= 3 else float("inf")
    said = {"collection_stage_timings": {k: rec.stats[k] for k in (
                "features_s", "matching_s", "prune_s", "tracks_s", "baseline_s", "solve_s",
                "pnp_s", "triangulate_s", "local_ba_s", "global_ba_s", "total_s")},
            "views": V, "registered_cameras": n_cam, "points": rec.num_points,
            "observations": int(len(rec.obs_point)),
            "mean_reprojection_px": rec.mean_reprojection_error, "ate": ate,
            "orbit_diameter": COLLECTION_ORBIT_DIAMETER, "ba_iterations": rec.stats["ba_iters"],
            "ba_iterations_local": rec.stats["ba_iters_local"],
            "ba_iterations_global": rec.stats["ba_iters_global"],
            "match_top2_launches": launches, "card": card}
    print(json.dumps(said), flush=True)
    check(n_cam >= COLLECTION_MIN_CAMERAS * V, f"collection: only {n_cam}/{V} cameras registered")
    check(rec.mean_reprojection_error < MAX_REPROJ_PX,
          f"collection: reprojection error {rec.mean_reprojection_error} too large")
    check(ate < MAX_ATE_FRAC * COLLECTION_ORBIT_DIAMETER,
          f"collection: ATE {ate} >= {MAX_ATE_FRAC} x {COLLECTION_ORBIT_DIAMETER}")
    check(rec.stats["ba_iters"] > 0, "collection: no BA iteration ran")
    check(np.isfinite(rec.xyz).all() and rec.xyz.shape == (rec.num_points, 3)
          and len(rec.obs_point) == len(rec.obs_view), "collection: bad points")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        rec.save_ply(os.path.join(tmp, "rec"))
        check_ply_files(os.path.join(tmp, "rec"), rec.num_points, n_cam, "collection")
    return launches


def write_image_dir(tmp, imgs, K):
    """The scene as a directory of 8-bit PNGs plus an OpenCV calibration YAML
    under tmp. Returns (image directory, calibration path)."""
    import numpy as np
    from PIL import Image

    img_dir = os.path.join(tmp, "images")
    os.makedirs(img_dir)
    for v, img in enumerate((np.clip(imgs, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)):
        Image.fromarray(img).save(os.path.join(img_dir, f"view_{v:02d}.png"))
    calib = os.path.join(tmp, "out_camera_data.yml")
    with open(calib, "w") as fh:
        fh.write("%YAML:1.0\ncamera_matrix: !!opencv-matrix\n   rows: 3\n   cols: 3\n"
                 "   dt: d\n   data: [ " + ", ".join(repr(float(x)) for x in K.ravel())
                 + " ]\ndistortion_coefficients: !!opencv-matrix\n   rows: 5\n"
                 "   cols: 1\n   dt: d\n   data: [ 0., 0., 0., 0., 0. ]\n")
    return img_dir, calib


def check_ply_files(prefix, n_points, n_cameras, what):
    with open(prefix + "_points.ply") as fh:
        check(f"element vertex {n_points}\n" in fh.read(2000), f"{what}: points PLY: wrong count")
    with open(prefix + "_cameras.ply") as fh:
        check(f"element vertex {5 * n_cameras}\n" in fh.read(2000),
              f"{what}: cameras PLY: wrong count")


def host_loop_phase(tmp, img_dir, calib, imgs, gt_poses, K, seed, pallas_match):
    """Phase 5: the host-driven loop through the command line and by stages,
    then on each merge. Returns (stage timings of the command-line run, K1
    launches of that run, what the native runtime reported)."""
    import numpy as np

    from tpusfm_torch import SfMConfig, cli, native
    from tpusfm_torch.pipeline import SfMPipeline
    from tpusfm_torch.types import Intrinsics

    want_devices = {("features", "cuda"), ("matches", "cuda"), ("ba", "cuda")}
    prefix = os.path.join(tmp, "rec")
    live = os.path.join(tmp, "live.html")

    # ---- through the command line; the live viewer is a listener
    got, seen = {}, set()
    run = SfMPipeline.run

    def spied_run(pipe):
        spy_devices(pipe, seen)
        got.update(pipe=pipe, fused=pipe._fused_applicable())
        got["rec"] = run(pipe)
        return got["rec"]

    SfMPipeline.run = spied_run
    pallas_match.match_topk2.launches = 0
    said = io.StringIO()
    try:
        with contextlib.redirect_stdout(said):
            rc = cli.main([img_dir, "--max-features", str(OPERATING_POINT["max_features"]),
                           "--max-matches", str(OPERATING_POINT["max_matches"]),
                           "--calibration", calib, "--live-html", live, "--html",
                           "--sor-filter", "--output-prefix", prefix, "--seed", str(seed)])
    finally:
        SfMPipeline.run = run
        print(said.getvalue(), end="", flush=True)
    launches = pallas_match.match_topk2.launches
    check(rc == 0, f"cli.main returned {rc}")
    pipe, rec = got["pipe"], got["rec"]
    check(not got["fused"], "a pipeline with a listener took the fused path")
    check(pipe.device.type == "cuda" and pipe.intr.K.device.type == "cuda",
          "the command line did not run on the card")
    check(seen == want_devices, f"host loop ran off the card: {sorted(seen)}")
    check(launches >= 1, "K1 was not launched by the host loop")
    check(np.allclose(pipe._init_intr.K.cpu().numpy(), K, atol=1e-3),
          "the calibration file's K did not reach the pipeline")
    check_gates("host loop (command line)", rec.poses, rec.pose_valid, rec.num_points,
                rec.mean_reprojection_error, gt_poses)
    with open(os.path.join(tmp, "frames.json")) as fh:
        frames = json.load(fh)
    check(len(frames) >= 2, f"the listener fired {len(frames)} times")
    check(len(frames[0]["cams"]) == 2, "the listener's first call did not see two cameras")
    check(len(frames[-1]["pts"]) == 6 * rec.num_points and os.path.getsize(live) > 0,
          "the live viewer does not hold the reconstruction")
    reported = int(re.search(r"saved (\d+) points", said.getvalue()).group(1))
    check(0 < reported <= rec.num_points, f"reported {reported} of {rec.num_points} points")
    check_ply_files(prefix, reported, int(rec.pose_valid.sum()), "host loop (command line)")
    with open(prefix + "_viewer.html") as fh:
        check(f"{reported} points" in fh.read(), "HTML viewer: wrong count")
    timings = {k: rec.stats[k] for k in ("features_s", "matching_s", "prune_s", "baseline_s",
                                         "add_views_s", "pnp_s", "triangulate_s", "merge_s",
                                         "ba_s", "total_s")}

    # ---- by stages, resumed from a checkpoint in a second pipeline
    cfg = SfMConfig(**OPERATING_POINT, fused=False)
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]), device="cuda")
    calls, seen = [], set()
    listener = lambda xyz, rgb, poses, valid: calls.append((len(xyz), int(valid.sum())))
    first = SfMPipeline(imgs, cfg, intrinsics=intr, seed=seed, device="cuda")
    second = SfMPipeline(imgs, cfg, intrinsics=intr, seed=seed, device="cuda")
    for p in (first, second):
        p.add_listener(listener)
        spy_devices(p, seen)
    t0 = time.perf_counter()
    first.extract()
    first.match()
    check(first.find_baseline_triangulation(), "staged run: no baseline pair")
    ckpt = os.path.join(tmp, "state.npz")
    first.save_checkpoint(ckpt)
    second.load_checkpoint(ckpt)
    check(second.n_points == first.n_points and second.done_views == first.done_views
          and second.features.desc.device.type == "cuda", "checkpoint did not round-trip")
    second.add_more_views()
    print(f"staged host loop: {time.perf_counter() - t0:.2f}s, listener calls {calls}",
          flush=True)
    check(seen == want_devices, f"staged host loop ran off the card: {sorted(seen)}")
    check(len(calls) >= 2 and calls[0][1] == 2, f"listener calls {calls}")
    check(np.isfinite(second.xyz[: second.n_points]).all(), "staged run: bad points")
    check_gates("host loop (stages, resumed)", second.poses, second.pose_valid,
                second.n_points, second.mean_reprojection_error(), gt_poses)

    # ---- the native runtime: built or why not; then its merge against numpy's
    report = native.build_report()
    print(f"native runtime: {json.dumps(report)}", flush=True)
    check(report["trackgraph"] == "built",
          f"the track graph did not build on the card: {report['trackgraph']}")
    runs = {}
    for merge in ("native", "numpy"):
        available = native.available
        if merge == "numpy":
            native.available = lambda: False
        try:
            rec = SfMPipeline(imgs, cfg, intrinsics=intr, seed=seed, device="cuda").run()
        finally:
            native.available = available
        check(rec.stats["native"] == (merge == "native"), f"the {merge} merge did not run")
        check_gates(f"host loop ({merge} merge)", rec.poses, rec.pose_valid, rec.num_points,
                    rec.mean_reprojection_error, gt_poses)
        runs[merge] = (int(rec.pose_valid.sum()), rec.num_points, rec.mean_reprojection_error)
    print(f"native and numpy merges from seed {seed}: {runs} "
          f"({'equal' if runs['native'] == runs['numpy'] else 'different'})", flush=True)
    return timings, launches, report


def strategies_phase(tmp, img_dir, calib, imgs, gt_poses, K, seed, pallas_match, card):
    """Phase 7: every other matcher strategy on the card at the operating
    point, its front half against the CPU's, then the command line with
    --matcher of. Returns {strategy: stage timings and outcome}."""
    import numpy as np
    import torch

    from tpusfm_torch import MatcherKind, SfMConfig
    from tpusfm_torch.pipeline import SfMPipeline
    from tpusfm_torch.types import Intrinsics, Matches

    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]), device="cuda")
    gray_cpu = torch.as_tensor(imgs)
    out = {}
    for kind, (ref_cameras, ref_meets) in STRATEGY_REFERENCE.items():
        pipe = SfMPipeline(imgs, SfMConfig(**OPERATING_POINT, matcher=MatcherKind(kind)),
                           intrinsics=intr, seed=seed, device="cuda")
        check(not pipe._fused_applicable(), f"{kind}: took the fused path")
        seen, raw = set(), {}
        plain_match, flow_fn, flow_pairs = pipe._match, pipe._flow_match, pipe._match_optical_flow
        spy_devices(pipe, seen)

        def flow_match(*a, **k):
            m = flow_fn(*a, **k)
            seen.update({("features", a[2].device.type), ("matches", m.idx.device.type)})
            return m

        def spied_pairs(pairs):
            raw["m"] = flow_pairs(pairs)[0]
            return [raw["m"]]

        pipe._flow_match, pipe._match_optical_flow = flow_match, spied_pairs
        match_fn = pipe._match
        pipe._match = lambda feats, pairs: raw.setdefault("m", match_fn(feats, pairs))
        pallas_match.match_topk2.launches = 0
        rec = pipe.run()
        check(pallas_match.match_topk2.launches == 0, f"{kind}: K1 was launched")
        check(seen == {("features", "cuda"), ("matches", "cuda"), ("ba", "cuda")},
              f"{kind}: ran off the card: {sorted(seen)}")
        check(np.isfinite(rec.xyz).all() and rec.xyz.shape == (rec.num_points, 3),
              f"{kind}: bad points")
        n_cam, ate, spread = check_gates(f"strategy {kind}", rec.poses, rec.pose_valid,
                                         rec.num_points, rec.mean_reprojection_error, gt_poses,
                                         bars=ref_meets)
        if not ref_meets:
            print(f"strategy {kind}: tpusfm registers {ref_cameras} cameras and misses phase 4's "
                  "bars", flush=True)
            check(n_cam >= ref_cameras - 1,
                  f"strategy {kind}: {n_cam} cameras, tpusfm registers {ref_cameras}")

        # the front half again on the CPU: features, then this strategy's
        # matches on three pairs, against the card's from the run above
        t0 = time.perf_counter()
        rows = [pipe.pair_of[p] for p in STRATEGY_PAIRS]
        f_cpu = pipe._extract(gray_cpu)
        pairs_cpu = torch.tensor(STRATEGY_PAIRS)
        if kind == "surf":
            m_cpu = plain_match(f_cpu, pairs_cpu)
        else:
            i, j = pairs_cpu[:, 0], pairs_cpu[:, 1]
            extra = (dict(feats1_desc=f_cpu.desc[i], feats2_desc=f_cpu.desc[j])
                     if kind == "dense" else {})
            m_cpu = flow_fn(gray_cpu[i], gray_cpu[j], f_cpu.xy[i], f_cpu.valid[i], f_cpu.xy[j],
                            f_cpu.valid[j], **extra)
        sel = torch.tensor(rows, device="cuda")
        m_gpu = Matches(idx=raw["m"].idx[sel], dist=raw["m"].dist[sel], valid=raw["m"].valid[sel])
        kp_frac, desc_frac, match_frac = compare_front_half(pipe.features, m_gpu, f_cpu, m_cpu,
                                                            STRATEGY_PAIRS)
        print(f"strategy {kind}, card vs CPU ({time.perf_counter() - t0:.1f}s on the CPU): "
              f"{kp_frac:.5f} of keypoints, {desc_frac:.5f} of their descriptors and "
              f"{match_frac:.5f} of the matches of pairs {list(STRATEGY_PAIRS)} found on both",
              flush=True)
        check(kp_frac >= MIN_SAME_KEYPOINTS, f"{kind}: card and CPU detectors disagree")
        check(match_frac >= MIN_SAME_MATCHES, f"{kind}: card and CPU matchers disagree")
        out[kind] = dict({k: rec.stats[k] for k in ("features_s", "matching_s", "prune_s",
                                                     "baseline_s", "add_views_s", "total_s")},
                         cameras=n_cam, points=rec.num_points,
                         mean_reprojection_px=rec.mean_reprojection_error, ate=ate,
                         spread=spread, native=rec.stats.get("native"),
                         matches_card_vs_cpu=match_frac, keypoints_card_vs_cpu=kp_frac)
        print(json.dumps({"strategy": kind, **out[kind], "card": card}), flush=True)

    # ---- the command line with a flow strategy, in a process of its own
    prefix = os.path.join(tmp, "of")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpusfm_torch.cli", img_dir, "--matcher", "of",
                           "--max-features", str(OPERATING_POINT["max_features"]),
                           "--max-matches", str(OPERATING_POINT["max_matches"]),
                           "--calibration", calib, "--output-prefix", prefix,
                           "--seed", str(seed)],
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    print(proc.stdout[-2000:], end="", flush=True)
    check(proc.returncode == 0, f"python -m tpusfm_torch.cli --matcher of exited with "
                                f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    said = re.search(r"saved (\d+) points, (\d+)/\d+ cameras", proc.stdout)
    check(said is not None, "the command line did not report what it saved")
    check_ply_files(prefix, int(said.group(1)), int(said.group(2)), "command line --matcher of")
    print(f"command line --matcher of: {said.group(0)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return out


def compare_front_half(f_gpu, m_gpu, f_cpu, m_cpu, pairs):
    """Fractions of the CPU's keypoints that the card found too (within
    KEYPOINT_TOL_PX), of those whose descriptors are equal (float ones to
    1e-4), and of the CPU's
    matches that the card made too, after mapping the card's feature indices
    onto the CPU's (tied scores may order the same keypoints differently)."""
    import torch

    V, F = f_cpu.valid.shape
    to_cpu = torch.full((V, F), -1, dtype=torch.int64)       # card index -> CPU index
    n_kp = n_same = n_desc = 0
    for v in range(V):
        ig = f_gpu.valid[v].cpu().nonzero()[:, 0]
        ic = f_cpu.valid[v].nonzero()[:, 0]
        dist, nn = torch.cdist(f_cpu.xy[v, ic].double(), f_gpu.xy[v, ig].cpu().double()).min(1)
        hit = dist < KEYPOINT_TOL_PX
        n_kp += len(ic)
        n_same += int(hit.sum())
        gap = (f_cpu.desc[v, ic[hit]] - f_gpu.desc[v, ig[nn[hit]]].cpu()).abs()
        n_desc += int((gap.amax(1) <= 1e-4).sum())          # exact for +-1 descriptors
        to_cpu[v, ig[nn[hit]]] = ic[hit]

    def match_set(m, index_map):
        idx, valid = m.idx.cpu().long(), m.valid.cpu()
        out = set()
        for p, (a, b) in enumerate(pairs):
            sel = idx[p][valid[p]]
            out.update((p, int(l), int(r)) for l, r in zip(index_map(a, sel[:, 0]),
                                                           index_map(b, sel[:, 1])))
        return out

    on_cpu = match_set(m_cpu, lambda v, i: i)
    on_gpu = match_set(m_gpu, lambda v, i: to_cpu[v, i])
    return (n_same / max(n_kp, 1), n_desc / max(n_same, 1),
            len(on_cpu & on_gpu) / max(len(on_cpu), 1))


def dist_problems(seed):
    """Phase 8's two bundle-adjustment problems from ``seed`` (the geometry of
    benchmarks/scale_bench.py with DIST_NOISE_PX of pixel noise, the COO
    points seen by cameras DIST_COO["obs_stride"] apart), numpy:
    {"dense": (poses, points, uv (N,V,2), mask (N,V), K),
     "coo": (poses, points, cam_idx, pt_idx, uv (O,2), w (O,), K)}."""
    import numpy as np

    rng = np.random.default_rng(seed)
    K = np.array([[700.0, 0, 640.0], [0, 700.0, 480.0], [0, 0, 1]], np.float32)

    def ring(n, step, t):
        Rt = []
        for v in range(n):
            c, s = np.cos(step * v), np.sin(step * v)
            R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            Rt.append(np.concatenate([R, np.array(t(v), np.float32)[:, None]], 1))
        return np.stack(Rt)

    N, V = DIST_DENSE["n_points"], DIST_DENSE["n_cams"]
    pts = np.stack([rng.uniform(-8, 8, N), rng.uniform(-6, 6, N),
                    rng.uniform(10, 40, N)], 1).astype(np.float32)
    poses = ring(V, 0.01, lambda v: (-0.1 * v, 0.0, 1.0))
    pc = np.einsum("vij,nj->nvi", poses[:, :, :3], pts) + poses[None, :, :, 3]
    uv = pc[..., :2] / np.maximum(pc[..., 2:], 1e-6) * K[0, 0] + K[:2, 2]
    uv = (uv + rng.normal(0.0, DIST_NOISE_PX, uv.shape)).astype(np.float32)
    mask = rng.uniform(0, 1, (N, V)) < 0.3              # each point seen by ~10 cameras
    dense = ((poses + 0.002 * rng.standard_normal(poses.shape)).astype(np.float32),
             (pts + 0.02 * rng.standard_normal(pts.shape)).astype(np.float32), uv, mask, K)

    V, N, k = DIST_COO["n_cams"], DIST_COO["n_points"], DIST_COO["obs_per_pt"]
    pts = np.stack([rng.uniform(-40, 40, N), rng.uniform(-10, 10, N),
                    rng.uniform(20, 80, N)], 1).astype(np.float32)
    poses = ring(V, 2 * np.pi / V * 0.05, lambda v: (-0.08 * v, 0.0, 2.0))
    base = rng.integers(0, V, N)                        # each point seen by k cameras
    cidx = ((base[:, None] + DIST_COO["obs_stride"] * np.arange(k)[None, :]) % V)
    cidx = cidx.ravel().astype(np.int32)
    pidx = np.repeat(np.arange(N, dtype=np.int32), k)
    pc = np.einsum("oij,oj->oi", poses[cidx, :, :3], pts[pidx]) + poses[cidx, :, 3]
    uvc = pc[:, :2] / np.maximum(pc[:, 2:], 1e-6) * K[0, 0] + K[:2, 2]
    uvc = (uvc + rng.normal(0.0, DIST_NOISE_PX, uvc.shape)).astype(np.float32)
    coo = ((poses + 0.001 * rng.standard_normal(poses.shape)).astype(np.float32),
           (pts + 0.01 * rng.standard_normal(pts.shape)).astype(np.float32), cidx, pidx, uvc,
           (pc[:, 2] > 0).astype(np.float32), K)
    return {"dense": dense, "coo": coo}


def dist_solves(problems, mesh=None):
    """Both adjusters on ``problems``: sharded over ``mesh``, or in one process
    (ba.adjust_bundle, ba.sparse.adjust_bundle_sparse) without one, each
    after an untimed one-iteration solve that warms the allocator and the
    libraries. Returns {kind: (poses, final cost, iterations, wall s per LM
    iteration, the returns)}. Fails unless each solve converged."""
    import numpy as np
    import torch

    from tpusfm_torch.ba import adjust_bundle
    from tpusfm_torch.ba.sparse import adjust_bundle_sparse
    from tpusfm_torch.dist import adjust_bundle_sharded, adjust_bundle_sparse_sharded

    T = lambda a: torch.as_tensor(a, device="cuda")
    out = {}
    for kind, prob in problems.items():
        def solve(iterations):
            kw = dict(max_iterations=iterations, function_tolerance=DIST_FTOL)
            if kind == "dense":
                poses, pts, uv, mask, K = prob
                args = (T(poses), T(np.ones(len(poses), bool)), T(pts),
                        T(np.ones(len(pts), bool)), T(uv), T(mask), T(K))
                return (adjust_bundle_sharded(mesh, *args, **kw) if mesh is not None
                        else adjust_bundle(*args, **kw))
            poses, pts, cidx, pidx, uv, w, K = prob
            cam_ok = T(np.ones(len(poses), bool))
            return (adjust_bundle_sparse_sharded(mesh, T(poses), cam_ok, pts, cidx, pidx, uv, w,
                                                 T(K), cg_iterations=DIST_CG, **kw)
                    if mesh is not None else
                    adjust_bundle_sparse(T(poses), cam_ok, T(pts), T(cidx).long(),
                                         T(pidx).long(), T(uv), T(w), T(K),
                                         cg_iterations=DIST_CG, **kw))

        solve(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(DIST_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        its = int(res[3].iterations)
        check(bool(res[3].converged) and its < DIST_ITERS,
              f"phase 8: the {kind} adjuster did not converge in {DIST_ITERS} iterations")
        out[kind] = (res[0], float(res[3].final_cost), its, wall / its, res)
    return out


def dist_worker(out_path, seed):
    """Phase 8 (b): one of two gloo ranks on the one card (--dist-worker)."""
    import torch
    import torch.distributed as dist

    from tpusfm_torch.dist import initialize_distributed, make_mesh
    from tpusfm_torch.dist.mesh import spawned_coordinates

    coordinator, world, rank = spawned_coordinates()
    initialize_distributed(coordinator, world, rank, backend="gloo", device="cuda")
    try:
        mesh = make_mesh(device="cuda")
        check(mesh.size == 2 and mesh.device.type == "cuda", f"dist worker: {mesh}")
        solved = dist_solves(dist_problems(seed), mesh)
        if rank == 0:
            import numpy as np

            np.savez(out_path, staged=json.dumps(dict(mesh.staged)),
                     **{f"{k}_{f}": np.asarray(v) for k, (Rt, cost, its, per_it, _)
                        in solved.items() for f, v in (("Rt", Rt.cpu().numpy()), ("cost", cost),
                                                       ("iters", its), ("per_iter_s", per_it))})
    finally:
        dist.destroy_process_group()
    return 0


def dist_phase(seed, pallas_match, card):
    """Phase 8: the distributed path, (a) a world of one NCCL rank here, (b) two
    gloo ranks on the one card. Returns the K1 launches of the sharded
    matchers and of the dry run."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpusfm_torch.dist import (make_mesh, match_all_pairs_ring, match_all_pairs_sharded,
                                   ring_matches_to_matrix)
    from tpusfm_torch.dist.mesh import spawn
    from tpusfm_torch.eval import ate_rmse
    from tpusfm_torch.features.match import select_matches
    from tpusfm_torch.tools import dryrun_multichip
    from tpusfm_torch.types import Features

    t_phase = time.perf_counter()
    mesh = make_mesh()
    check(mesh.size == 1 and mesh.device.type == "cuda" and dist.get_backend() == "nccl",
          f"phase 8: not a world of one NCCL rank on the card: {mesh}")
    launches = {}
    try:
        # ---- matching at the collection's chunk: views of noisy copies of one
        # descriptor set (so the ratio test keeps matches), 5% invalid rows
        rng = np.random.default_rng(seed)
        V, F, P, M = (DIST_MATCH[k] for k in ("V", "F", "P", "M"))
        base = rng.standard_normal((F, 256)) > 0
        desc = np.stack([np.where(base[rng.permutation(F)] ^ (rng.uniform(size=(F, 256)) < 0.1),
                                  1.0, -1.0) for _ in range(V)]).astype(np.float32)
        valid = rng.uniform(size=(V, F)) > 0.05
        feats = Features(xy=torch.zeros(V, F, 2, device="cuda"),
                         desc=torch.as_tensor(desc, device="cuda"),
                         score=torch.zeros(V, F, device="cuda"),
                         angle=torch.zeros(V, F, device="cuda"),
                         valid=torch.as_tensor(valid, device="cuda"))
        all_pairs = np.array([(i, j) for i in range(V) for j in range(i + 1, V)], np.int64)
        pairs = torch.as_tensor(all_pairs[np.sort(rng.choice(len(all_pairs), P, replace=False))],
                                device="cuda")
        pallas_match.match_topk2.launches = 0
        got = match_all_pairs_sharded(mesh, feats, pairs, max_matches=M)
        launches["sharded"] = pallas_match.match_topk2.launches
        check(launches["sharded"] == 1, f"phase 8: K1 launched {launches['sharded']} times")
        want = pallas_match.match_pairs(feats.desc, feats.valid, pairs, max_matches=M)
        signs = pallas_match.descriptor_signs(feats.desc)
        i, j = pairs[:, 0], pairs[:, 1]
        plain = select_matches(*pallas_match.match_topk2_plain(signs[i], signs[j],
                                                               feats.valid[j]),
                               feats.valid[i], ratio=0.8, max_matches=M)
        for name, ref in (("unsharded match_pairs", want), ("K1's plain version", plain)):
            check(all(torch.equal(a, b) for a, b in ((got.idx, ref.idx), (got.dist, ref.dist),
                                                       (got.valid, ref.valid))),
                  f"phase 8: the sharded matcher differs from {name}")
        n_match = int(got.valid.sum())
        check(n_match > P * 10, f"phase 8: only {n_match} matches in {P} pairs")

        ring_feats = Features(*(x[:8] for x in (feats.xy, feats.desc, feats.score, feats.angle,
                                                 feats.valid)))
        pallas_match.match_topk2.launches = 0
        ring, gid = match_all_pairs_ring(mesh, ring_feats, max_matches=M)
        launches["ring"] = pallas_match.match_topk2.launches
        check(launches["ring"] == 1, f"phase 8: ring launched K1 {launches['ring']} times")
        ring_pairs = torch.tensor([(a, b) for a in range(8) for b in range(a + 1, 8)],
                                  device="cuda")
        ref = pallas_match.match_pairs(ring_feats.desc, ring_feats.valid, ring_pairs,
                                       max_matches=M)
        r_idx, r_dist, r_ok = ring_matches_to_matrix(ring, gid, 8)
        check(np.array_equal(r_idx, ref.idx.cpu().numpy())
              and np.array_equal(r_ok, ref.valid.cpu().numpy())
              and np.array_equal(r_dist, ref.dist.cpu().numpy()),
              "phase 8: the ring's match matrix differs from match_pairs")
        print(f"phase 8 (a): sharded matcher (P={P}, F={F}, M={M}; {n_match} matches) and ring "
              f"(8 views) equal match_pairs and K1's plain version bit for bit; K1 launches "
              f"{launches}", flush=True)

        # ---- both adjusters: one process against a world of one, bit for bit
        t0 = time.perf_counter()
        problems = dist_problems(seed)
        print(f"phase 8 (a): made the problems in {time.perf_counter() - t0:.1f}s", flush=True)
        single = dist_solves(problems)
        world1 = dist_solves(problems, mesh)
        for kind in problems:
            a, b = single[kind][4], world1[kind][4]
            same = all(torch.equal(x, y) for x, y in zip((*a[:3], *a[3]), (*b[:3], *b[3])))
            print(f"phase 8 (a): {kind} adjuster: cost {float(a[3].initial_cost):.6f} -> "
                  f"{single[kind][1]:.6f} in {single[kind][2]} iterations; world of one "
                  f"{'equal bit for bit' if same else 'DIFFERENT'} ({world1[kind][1]:.6f} in "
                  f"{world1[kind][2]})", flush=True)
            check(same, f"phase 8: the {kind} adjuster at world 1 differs from one process")
            check(single[kind][1] > 0.0 and np.isfinite(single[kind][1]),
                  f"phase 8: {kind} cost {single[kind][1]}")

        # ---- the dry run's four checks on this world of one
        pallas_match.match_topk2.launches = 0
        said = dryrun_multichip.run(mesh)
        launches["dryrun"] = pallas_match.match_topk2.launches
        print(dryrun_multichip.summary_lines(1, said), flush=True)
        check(launches["dryrun"] >= 2, "phase 8: the dry run's collections did not launch K1")
    finally:
        dist.destroy_process_group()

    # ---- (b) two gloo ranks on the one card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        out_path = os.path.join(tmp, "rank0.npz")
        t0 = time.perf_counter()
        spawn([sys.executable, os.path.abspath(__file__), "--dist-worker", out_path,
               "--seed", str(seed)], 2, timeout=600,
              cwd=os.path.dirname(os.path.abspath(__file__)))
        two = dict(np.load(out_path))
    print(f"phase 8 (b): two gloo ranks took {time.perf_counter() - t0:.1f}s", flush=True)
    numbers = {}
    for kind in problems:
        Rt2, cost2 = two[f"{kind}_Rt"], float(two[f"{kind}_cost"])
        Rt1, cost1 = single[kind][0].cpu().numpy(), single[kind][1]
        delta = ate_rmse(Rt2, Rt1)
        numbers[kind] = dict(cost_1=cost1, cost_2=cost2, pose_rmse=delta,
                             iterations=[single[kind][2], world1[kind][2],
                                         int(two[f"{kind}_iters"])],
                             per_iteration_s=dict(one_process=single[kind][3],
                                                  world_1_nccl=world1[kind][3],
                                                  world_2_gloo=float(two[f"{kind}_per_iter_s"])))
        check(abs(cost2 - cost1) / cost1 < DIST_COST_RTOL,
              f"phase 8: two-rank {kind} cost {cost2} != one process {cost1}")
        check(delta < DIST_POSE_TOL, f"phase 8: two-rank {kind} aligned pose rmse {delta}")
    staged = json.loads(str(two["staged"]))
    print(f"phase 8 (b): collectives staged through host tensors: {staged}", flush=True)
    print(json.dumps({"dist": numbers, "dryrun": said, "staged_collectives": staged,
                      "launches": launches, "phase_s": time.perf_counter() - t_phase,
                      "card": card}), flush=True)
    return launches


def fixture_subphase(pallas_match, card):
    """Phase 9 (a): the Strecha-format fixture, rendered on the card, then the
    calibrated fused run at each of FIXTURE_SEEDS with the coefficients and
    without them. Returns (K1 launches of the seed-0 run, report)."""
    import numpy as np
    import torch
    from PIL import Image

    from tpusfm_torch import SfMConfig
    from tpusfm_torch.tools import strecha_eval
    from tpusfm_torch.tools.synthetic import fixture_poses, make_fixture, render_fixture_view

    with tempfile.TemporaryDirectory(prefix="chip_smoke_strecha_") as d:
        make_fixture(d, dist=strecha_eval.FIXTURE_DIST, device="cuda")
        poses, K = fixture_poses()
        on_cpu = render_fixture_view(poses[0], K, strecha_eval.FIXTURE_DIST, 384, 512,
                                     device="cpu").numpy().astype(int)
        on_card = np.asarray(Image.open(os.path.join(d, "0000.png"))).astype(int)
        lsb = int(np.abs(on_card - on_cpu).max())
        print(f"phase 9 (a): the card's render of view 0 against the CPU's: max {lsb} LSB, "
              f"{float((on_card == on_cpu).mean()):.6f} of the pixels equal", flush=True)
        check(lsb <= 1, f"phase 9 (a): the card's render differs from the CPU's by {lsb} LSB")

        cfg = SfMConfig(**strecha_eval.FIXTURE_CONFIG, console_debug_level=5)
        runs, launches, matched = {}, [], []
        for coefficients in (True, False):
            pipe, gt_poses = strecha_eval.calibrated_pipeline(
                d, 1.0, cfg, "cuda", dist=None if coefficients else (0.0, 0.0, 0.0))
            check(pipe._fused_applicable() and pipe.device.type == "cuda",
                  "phase 9 (a): not the fused path on the card")
            for s in FIXTURE_SEEDS:
                pipe.reset(s)
                pallas_match.match_topk2.launches = 0
                if coefficients and s == FIXTURE_SEEDS[0]:
                    match = pipe._match

                    def spy(feats, pairs):
                        matched.append((feats, pairs))
                        return match(feats, pairs)
                    pipe._match = spy
                    rec, shift = strecha_eval.run_with_undistortion_shift(pipe)
                    pipe._match = match
                else:
                    rec = pipe.run()
                launches.append(pallas_match.match_topk2.launches)
                runs[coefficients, s] = strecha_eval.score(rec, gt_poses)
    check(launches == [1] * len(launches), f"phase 9 (a): K1 launches per run {launches}")
    # K1 on the descriptors seed 0's run gave it, against its plain version
    (feats, pairs), = matched
    signs = pallas_match.descriptor_signs(feats.desc)
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    args = (signs[i].contiguous(), signs[j].contiguous(), feats.valid[j].contiguous())
    check(all(torch.equal(g, w) for g, w in zip(pallas_match.match_topk2(*args),
                                                pallas_match.match_topk2_plain(*args))),
          f"phase 9 (a): K1 on the fixture's descriptors {tuple(args[0].shape)} differs "
          "from its plain version")
    print(f"phase 9 (a): K1 on seed 0's descriptors {tuple(args[0].shape)} equals its plain "
          "version bit for bit", flush=True)
    del matched, feats, signs, args
    spread = runs[True, FIXTURE_SEEDS[0]]["detail"]["camera_spread"]
    table, good = {}, []
    for coefficients in (True, False):
        rows = [runs[coefficients, s] for s in FIXTURE_SEEDS]
        table[coefficients] = dict(
            cameras=[r["detail"]["cameras"] for r in rows],
            reprojection_px=[r["detail"]["mean_reprojection_px"] for r in rows],
            ate=[r["value"] for r in rows])
        med_px = float(np.median(table[coefficients]["reprojection_px"]))
        med_ate = float(np.median(table[coefficients]["ate"]))
        table[coefficients].update(median_reprojection_px=med_px, median_ate=med_ate)
        print(f"phase 9 (a): Strecha fixture 9 x 512x384 {'with' if coefficients else 'without'} "
              f"the coefficients, seeds {list(FIXTURE_SEEDS)}: cameras "
              f"{table[coefficients]['cameras']}, px "
              f"{[round(x, 4) for x in table[coefficients]['reprojection_px']]}, ATE "
              f"{[round(x, 5) for x in table[coefficients]['ate']]} (spread {spread:.3f}); "
              f"medians {med_px:.4f} px, ATE {med_ate:.5f}", flush=True)
    for s in FIXTURE_SEEDS:
        cameras = runs[True, s]["detail"]["cameras"]
        check(int(cameras.split("/")[0]) >= 8,
              f"phase 9 (a): seed {s}: only {cameras} cameras registered")
        good.append(strecha_eval.meets_bars(runs[True, s], FIXTURE_MAX_ATE_FRAC))
    max_ate = FIXTURE_MAX_ATE_FRAC * spread
    print(f"phase 9 (a): {sum(good)} of {len(good)} seeds meet the bars, ATE < {max_ate:.4f} "
          f"(at least {FIXTURE_MIN_GOOD}); undistortion moved keypoints by up to "
          f"{shift.max():.2f} px", flush=True)
    check(sum(good) >= FIXTURE_MIN_GOOD,
          f"phase 9 (a): {sum(good)} of {len(good)} seeds meet the bars")
    check(table[True]["median_ate"] < max_ate,
          f"phase 9 (a): median ATE {table[True]['median_ate']} >= {max_ate}")
    check(shift.max() > 5.0, f"phase 9 (a): undistortion moved keypoints by {shift.max()} px")
    check(table[True]["median_reprojection_px"] < table[False]["median_reprojection_px"]
          and table[True]["median_ate"] < table[False]["median_ate"],
          "phase 9 (a): the coefficients did not lower the reprojection error and the ATE")
    said = dict(runs[True, FIXTURE_SEEDS[0]], card=card, seeds=list(FIXTURE_SEEDS),
                seeds_meeting_bars=sum(good), max_ate=max_ate,
                undistortion_shift_max_px=float(shift.max()),
                with_coefficients=table[True], without_coefficients=table[False])
    return launches[0], said


def stress_subphase(pallas_match, card):
    """Phase 9 (b): stress4k at full size, cold then warm. Returns (K1
    launches of both runs, report)."""
    from tpusfm_torch.tools import stress4k

    pallas_match.match_topk2.launches = 0
    res = stress4k.run(device="cuda", card=card)
    launches = pallas_match.match_topk2.launches
    print(f"phase 9 (b): {res['config']}: {res['cameras']} cameras, {res['points']} points, "
          f"{res['mean_reprojection_px']:.4f} px, ATE {res['ate_rmse']:.5f} (spread "
          f"{res['camera_spread']:.3f}); cold {res['cold_s']:.3f}s, warm {res['warm_s']:.3f}s; "
          f"the warm run's undistortion moved keypoints by up to "
          f"{res['undistortion_shift_max_px']:.2f} px", flush=True)
    check(res["fused"], "phase 9 (b): the stress run did not take the fused path")
    check(res["match_top2_launches_warm"] == 1 and launches == 2,
          f"phase 9 (b): K1 launched {res['match_top2_launches_warm']} times in the warm run, "
          f"{launches} in both")
    check(int(res["cameras"].split("/")[0]) >= MIN_CAMERAS,
          f"phase 9 (b): only {res['cameras']} cameras registered")
    check(res["mean_reprojection_px"] < MAX_REPROJ_PX,
          f"phase 9 (b): reprojection error {res['mean_reprojection_px']} too large")
    check(res["ate_rmse"] < MAX_ATE_FRAC * res["camera_spread"],
          f"phase 9 (b): ATE {res['ate_rmse']} >= {MAX_ATE_FRAC} x {res['camera_spread']}")
    check(res["undistortion_shift_max_px"] > 5.0, "phase 9 (b): the warm run did not undistort")
    return launches, res


def scale_subphase(pallas_match, card):
    """Phase 9 (c): the scale bench's three metrics. Returns (K1 launches of
    the matching bench, its three lines)."""
    import torch

    from tpusfm_torch.tools import scale_bench

    problem = scale_bench.matching_problem(device="cuda")
    d1, d2, v2 = problem
    got = pallas_match.match_topk2(d1, d2, v2)
    want = pallas_match.match_topk2_plain(d1[:4], d2[:4], v2[:4])
    check(all(torch.equal(g[:4], w) for g, w in zip(got, want)),
          "phase 9 (c): K1 at P=128, F=5120 differs from its plain version")
    del got, want, d1, d2, v2
    pallas_match.match_topk2.launches = 0
    lines = [scale_bench.bench_matching(device="cuda", problem=problem)]
    launches = pallas_match.match_topk2.launches
    del problem
    try:
        lines.append(scale_bench.bench_distributed_ba(device="cuda"))
    finally:
        torch.distributed.destroy_process_group()
    lines.append(scale_bench.bench_sparse_ba(device="cuda"))
    for line in lines:
        print(f"phase 9 (c): {json.dumps(dict(line, card=card))}", flush=True)
    check(launches == 4, f"phase 9 (c): K1 launched {launches} times")
    for line in lines[1:]:
        det = line["detail"]
        check(det["final_cost"] < det["initial_cost"] and det["iterations"] > 0,
              f"phase 9 (c): {line['metric']} did not lower the cost: {det}")
    return launches, lines


def config5_subphase(pallas_match, card):
    """Phase 9 (d): the config-5 probe at BENCH_C5_VIEWS views. Returns (K1
    launches, report)."""
    import math

    from tpusfm_torch.tools import config5_partial

    pallas_match.match_topk2.launches = 0
    res = config5_partial.run(views=BENCH_C5_VIEWS, device="cuda", card=card)
    launches = pallas_match.match_topk2.launches
    print(f"phase 9 (d): config-5 probe at {BENCH_C5_VIEWS} views: {res['pairs']} pairs, "
          f"{res['tracks']} tracks ({res['tracks_triangulated']} triangulated), "
          f"{res['observations']} observations, BA {res['ba_initial_cost']:.1f} -> "
          f"{res['ba_final_cost']:.1f} in {res['ba_iterations']} iterations, "
          f"{res['mean_reprojection_px']:.4f} px", flush=True)
    check(res["pairs"] == BENCH_C5_VIEWS * 8, f"phase 9 (d): {res['pairs']} window pairs")
    check(launches == math.ceil(res["pairs"] / 256),
          f"phase 9 (d): K1 launched {launches} times for {res['pairs']} pairs")
    check(res["tracks"] > 0 and res["ba_iterations"] > 0, "phase 9 (d): no tracks or no BA")
    check(res["ba_final_cost"] < res["ba_initial_cost"], "phase 9 (d): BA did not lower the cost")
    check(res["mean_reprojection_px"] < MAX_REPROJ_PX,
          f"phase 9 (d): reprojection error {res['mean_reprojection_px']}")
    return launches, res


def benchmarks_phase(pallas_match, card):
    """Phase 9: the reference's self-rendering benchmarks through the port's
    tools (tpusfm_torch/tools/), each sub-phase timed. Returns {sub-phase: K1
    launches}."""
    launches, said, seconds = {}, {}, {}
    for key, fn in (("strecha", fixture_subphase), ("stress", stress_subphase),
                    ("scale", scale_subphase), ("config5", config5_subphase)):
        t0 = time.perf_counter()
        launches[key], said[key] = fn(pallas_match, card)
        seconds[key] = time.perf_counter() - t0
        print(f"phase 9: {key} took {seconds[key]:.1f}s", flush=True)
    print(json.dumps({"benchmarks": said, "launches": launches, "seconds": seconds,
                      "card": card}), flush=True)
    return launches


def bound(P, F1, F2, D=256):
    """(ms, "operations" | "bytes"): the least time the card could take for K1."""
    ops = 2.0 * P * F1 * F2 * D
    nbytes = P * (F1 + F2) * D + P * F2 + 3 * 4 * P * F1
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dist-worker", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if args.dist_worker:
        return dist_worker(args.dist_worker, args.seed)
    from tpusfm_torch.features import pallas_match
    from tpusfm_torch import SfMConfig
    from tpusfm_torch.pipeline import SfMPipeline
    from tpusfm_torch.tools.bench_match import cuda_time_ms, make_case
    from tpusfm_torch.tools.synthetic import make_scene
    from tpusfm_torch.types import Intrinsics

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---- 1. build every kernel of the path, one nvcc per source in parallel
    kernels = {"match_top2": pallas_match}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(kernels)) as ex:
        futures = {name: ex.submit(mod.build) for name, mod in kernels.items()}
        built = {name: f.result() for name, f in futures.items()}
    print(f"phase 1: built {sorted(built)} in {time.perf_counter() - t0:.3f}s", flush=True)

    # ---- 2. K1 against its plain version, bit for bit
    max_err = 0.0
    for P, F1, F2, invalid, kind in ((21, 5120, 5120, 0.05, "random"), (1, 1536, 1536, 0.0, "random"),
                                     (1, 1792, 1792, 0.0, "random"),
                                     (2, 512, 512, 0.1, "ties_none_valid"),
                                     (2, 512, 768, 0.1, "random"), (2, 512, 768, 0.1, "cross"),
                                     (256, 1024, 1024, 0.05, "random"),
                                     (192, 1024, 1024, 0.05, "random"),
                                     (36, 2048, 2048, 0.05, "random")):
        d1, d2, v2 = make_case(P, F1, F2, invalid, args.seed + F1, kind)
        got = pallas_match.match_topk2(d1, d2, v2)
        torch.cuda.synchronize()
        want = pallas_match.match_topk2_plain(d1, d2, v2)
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"K1 output type at P={P} F1={F1} F2={F2}")
            err = float((g.double() - w.double()).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(g, w), f"K1 differs from its plain version at P={P} F1={F1} "
                                     f"F2={F2} ({kind}): {err}")
    print(f"phase 2: K1 equals its plain version bit for bit (max abs err {max_err})", flush=True)

    # ---- 3. times at the main path's shape, at a many-pairs shape and at the
    # collection pipeline's chunk, beside the bound
    D = 256
    timed = {}
    for P, F in ((21, OPERATING_POINT["max_features"]), (210, 2048), (256, 1024), (128, 5120),
                 (36, 2048)):
        d1, d2, v2 = make_case(P, F, F, 0.05, args.seed)
        row = {"match_top2": cuda_time_ms(lambda: pallas_match.match_topk2(d1, d2, v2), reps=10)[0]}
        # the plain version's P x F x F float32 matrices, in chunks of pairs above 3.5 GB each
        ch = P if P * F * F <= 210 * 2048 * 2048 else 32
        row["plain"] = cuda_time_ms(lambda: [pallas_match.match_topk2_plain(
            d1[s:s + ch], d2[s:s + ch], v2[s:s + ch]) for s in range(0, P, ch)], reps=1)[0]
        row["bound"], row["bound_by"] = bound(P, F, F, D)
        timed[P, F] = row
        print(f"phase 3: P={P}, F={F} on {card}: " + json.dumps(row), flush=True)
        if P == 21:
            # the bare product through the library, which writes the F x F matrix per pair that
            # K1 never writes; information only, used nowhere in the port
            int_mm = cuda_time_ms(lambda: [torch._int_mm(d1[p], d2[p].t()) for p in range(P)],
                                  reps=2)[0]
            print(json.dumps({"int_mm_product_ms": int_mm, "P": P, "F": F}), flush=True)
        del d1, d2, v2
    main_shape = timed[21, OPERATING_POINT["max_features"]]

    # ---- 4. the main path at the operating point
    t0 = time.perf_counter()
    imgs, gt_poses, K = make_scene(n_views=7, h=768, w=1024, seed=args.seed)
    print(f"phase 4: rendered {imgs.shape} in {time.perf_counter() - t0:.1f}s", flush=True)
    cfg = SfMConfig(**OPERATING_POINT)
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]), device=dev)
    pipe = SfMPipeline(imgs, cfg, intrinsics=intr, seed=args.seed)
    seen = {}
    match_fn = pipe._match

    def spy(feats, pairs):
        m = match_fn(feats, pairs)
        seen.update(feats=feats, matches=m)
        return m

    pipe._match = spy
    t0 = time.perf_counter()
    pipe.run()
    cold_s = time.perf_counter() - t0
    pipe.reset(args.seed)
    pallas_match.match_topk2.launches = 0
    rec = pipe.run()
    launches = {"match_top2": pallas_match.match_topk2.launches}
    timings = {k: round(v, 6) for k, v in rec.stats.items()}
    print("stage timings (warm): " + json.dumps(dict(timings, cold_total_s=round(cold_s, 3))),
          flush=True)
    devices = {seen["feats"].xy.device.type, seen["matches"].idx.device.type}
    check(devices == {"cuda"}, f"main path ran off the card: {devices}")
    check(pipe._engine.device.type == "cuda", "engine not on cuda")
    check(all(n >= 1 for n in launches.values()), f"a kernel was not launched: {launches}")
    check(np.isfinite(rec.xyz).all() and rec.xyz.shape == (rec.num_points, 3), "bad points")
    check_gates("reconstruction", rec.poses, rec.pose_valid, rec.num_points,
                rec.mean_reprojection_error, gt_poses)

    # ---- the card's features and matches against the CPU's (same code; on
    # the CPU the matcher is K1's plain version). The RANSAC stages after
    # them draw from per-device random streams, so they are held to the
    # ground truth above instead.
    feats_gpu, m_gpu = seen["feats"], seen["matches"]
    u8 = (np.clip(imgs, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    feats_cpu = pipe._extract(torch.as_tensor(u8).to(torch.float32) / 255.0)
    m_cpu = pallas_match.match_pairs(feats_cpu.desc, feats_cpu.valid, pipe._engine._pairs.cpu(),
                                     ratio=cfg.match_ratio, max_matches=cfg.max_matches)
    kp_frac, desc_frac, match_frac = compare_front_half(feats_gpu, m_gpu, feats_cpu, m_cpu,
                                                        pipe._engine.pairs_list)
    print(f"card vs CPU: {kp_frac:.5f} of keypoints, {desc_frac:.5f} of their descriptors "
          f"and {match_frac:.5f} of matches found on both", flush=True)
    check(kp_frac >= MIN_SAME_KEYPOINTS and desc_frac >= MIN_SAME_KEYPOINTS,
          "card and CPU detectors disagree")
    check(match_frac >= MIN_SAME_MATCHES, "card and CPU matchers disagree")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        img_dir, calib = write_image_dir(tmp, imgs, K)
        # ---- 5. the host-driven loop: command line, then stages with a resume
        host_timings, host_launches, native_report = host_loop_phase(
            tmp, img_dir, calib, imgs, gt_poses, K, args.seed, pallas_match)
        print(json.dumps({"host_loop_stage_timings": host_timings, "native": native_report,
                          "card": card}), flush=True)

        # ---- 6. the collection-scale path
        collection_launches = collection_phase(args.seed, pallas_match, card)

        # ---- 7. the other matcher strategies
        strategies = strategies_phase(tmp, img_dir, calib, imgs, gt_poses, K, args.seed,
                                      pallas_match, card)
    print(json.dumps({"strategy_stage_timings": strategies, "card": card}), flush=True)

    # ---- 8. the distributed path
    dist_launches = dist_phase(args.seed, pallas_match, card)

    # ---- 9. the reference's self-rendering benchmarks through the port's tools
    bench_launches = benchmarks_phase(pallas_match, card)

    table = [{
        "name": "match_top2", "route": "cuda", "source": "tpusfm_torch/csrc/match_top2.cu",
        "replaces": "tpusfm/features/pallas_match.py:101", "launches": launches["match_top2"],
        "launches_host_loop": host_launches, "launches_collection": collection_launches,
        "launches_strategies": 0, "launches_dist": sum(dist_launches.values()),
        "launches_benchmarks": bench_launches,
        "max_abs_err": max_err, "ms": main_shape["match_top2"], "plain_ms": main_shape["plain"],
        "bound_ms": main_shape["bound"], "bound_by": main_shape["bound_by"], "library_ms": None,
        "shapes": [{"P": P, "F": F, "ms": row["match_top2"], "plain_ms": row["plain"],
                    "bound_ms": row["bound"], "bound_by": row["bound_by"]}
                   for (P, F), row in timed.items()],
    }]
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
