"""The port's outcome with each matcher strategy on the 7-view scene, over seeds.

    python -m tpusfm_torch.tools.strategy_seeds [--matchers of,dense] [--seeds 0-23]
        [--device cuda|cpu] [--out PATH]

For each seed, renders ``tools/synthetic.py::make_scene(n_views=7, h=768,
w=1024, seed=s)`` and runs ``SfMPipeline(..., seed=s).run()`` at the
operating point of ``chip_smoke.py`` (5120 features, 2048 matches, a map of
4096 points) once per strategy: the rich matcher takes the fused path, every
other the host-driven loop. Prints one JSON line per (strategy, seed) with
the keys of ``tests/reference_strategies.py`` (tpusfm's counterpart):
cameras, points, mean reprojection error, ATE to the ground truth after
similarity alignment, the camera spread, and whether the run meets the bars
(>= 6 of 7 cameras, < 1 px, ATE < 5% of the spread); then, with several
seeds, a line per strategy with the count of seeds in the bars. Wall and
stage times are the host's clock around a run on the device; the card's
name and power limit (``nvidia-smi``) stand beside them. ``--device cpu`` runs on the CPU and
measures nothing of the device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

OPERATING_POINT = dict(max_features=5120, max_matches=2048, engine_point_capacity=4096,
                       console_debug_level=5)
MIN_CAMERAS = 6
MAX_REPROJ_PX = 1.0
MAX_ATE_FRAC = 0.05


def parse_seeds(text: str) -> range:
    first, _, last = text.partition("-")
    return range(int(first), int(last or first) + 1)


def outcome(matcher: str, seed: int, rec, gt_poses) -> dict:
    """The keys both packages' sweeps print for one reconstruction."""
    from tpusfm_torch.eval import ate_rmse, camera_centers

    pv = np.asarray(rec.pose_valid, bool)
    n_cam = int(pv.sum())
    gt_c = camera_centers(gt_poses[pv])
    spread = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0))) if n_cam else 0.0
    ate = ate_rmse(rec.poses[pv], gt_poses[pv]) if n_cam >= 3 else float("inf")
    err = float(rec.mean_reprojection_error)
    return {"matcher": matcher, "seed": seed, "cameras": n_cam, "views": len(pv),
            "points": int(rec.num_points), "mean_reprojection_px": err, "ate": float(ate),
            "spread": spread,
            "meets_bars": bool(n_cam >= MIN_CAMERAS and err < MAX_REPROJ_PX
                               and ate < MAX_ATE_FRAC * spread),
            "native": rec.stats.get("native"),
            "stage_timings_s": {k: v for k, v in rec.stats.items() if k.endswith("_s")}}


def run_one(imgs, gt_poses, K, matcher: str, seed: int, device) -> dict:
    from tpusfm_torch import MatcherKind, SfMConfig
    from tpusfm_torch.pipeline import SfMPipeline
    from tpusfm_torch.tools.common import synchronize
    from tpusfm_torch.types import Intrinsics

    cfg = SfMConfig(**OPERATING_POINT, matcher=MatcherKind(matcher))
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]), device=device)
    t0 = time.perf_counter()
    pipe = SfMPipeline(imgs, cfg, intrinsics=intr, seed=seed, device=device)
    rec = pipe.run()
    synchronize(device)
    wall = time.perf_counter() - t0
    return dict(outcome(matcher, seed, rec, gt_poses), wall_s=wall,
                path="fused" if pipe._fused_applicable() else "host loop")


def sweep(run, seeds, matchers, device_label: str, out: str | None = None) -> dict:
    """Render each seed's scene and call ``run(imgs, gt_poses, K, matcher,
    seed)`` for each matcher; print (and append to ``out``) one JSON line per
    run and, with several seeds, the count in the bars per matcher. Returns
    {matcher: count}. Both packages' sweeps go through here."""
    from tpusfm_torch.tools.synthetic import make_scene

    good = {m: 0 for m in matchers}

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            with open(out, "a") as fh:
                fh.write(line + "\n")

    for seed in seeds:
        imgs, gt_poses, K = make_scene(n_views=7, h=768, w=1024, seed=seed)
        for m in matchers:
            r = run(imgs, gt_poses, K, m, seed)
            good[m] += r["meets_bars"]
            emit(dict(r, device=device_label))
    if len(seeds) > 1:
        for m in matchers:
            emit({"matcher": m, "seeds": f"{seeds[0]}-{seeds[-1]}", "runs": len(seeds),
                  "meeting_bars": good[m], "device": device_label})
    return good


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--matchers", default="of,dense")
    ap.add_argument("--seeds", default="0", help="a seed or first-last")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also append the JSON lines here")
    args = ap.parse_args(argv)

    from tpusfm_torch.tools.common import device_and_card

    device, card = device_and_card(args.device)
    sweep(lambda *a: run_one(*a, device), parse_seeds(args.seeds), args.matchers.split(","),
          card, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
