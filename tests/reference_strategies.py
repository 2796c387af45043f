"""tpusfm's outcome with each matcher strategy on the port's 7-view scene.

    JAX_PLATFORMS=cpu python -m tests.reference_strategies [--seed 0] [--matchers of,dense,...]

Renders ``tpusfm_torch.tools.synthetic.make_scene`` (7 views, 1024x768, the
scene of ``chip_smoke.py`` phases 4, 5 and 7) and runs the reference's
``SfMPipeline(...).run()`` on the CPU at the same operating point (5120
features, 2048 matches) once per strategy, with the reference's native
runtime when it builds. Prints one JSON line per strategy: cameras, points,
mean reprojection error, ATE to the ground truth and the camera spread,
whether the strategy meets the bars of ``chip_smoke.py`` (>= 6 of 7 cameras,
< 1 px, ATE < 5% of the spread), and the stage timings (host clock of this
CPU, not a device number). ``chip_smoke.py`` phase 7 holds the port to what
this prints; it never imports tpusfm itself.
"""
from __future__ import annotations

import argparse
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from tpusfm import SfMConfig  # noqa: E402
from tpusfm import native  # noqa: E402
from tpusfm.config import MatcherKind  # noqa: E402
from tpusfm.pipeline import SfMPipeline  # noqa: E402
from tpusfm.types import Intrinsics  # noqa: E402
from tpusfm_torch.eval import ate_rmse, camera_centers  # noqa: E402
from tpusfm_torch.tools.synthetic import make_scene  # noqa: E402

OPERATING_POINT = dict(max_features=5120, max_matches=2048, engine_point_capacity=4096,
                       console_debug_level=5)


def run_one(imgs, gt_poses, K, matcher: str, seed: int) -> dict:
    cfg = SfMConfig(**OPERATING_POINT, matcher=MatcherKind(matcher))
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
    t0 = time.perf_counter()
    rec = SfMPipeline(imgs, cfg, intrinsics=intr, seed=seed).run()
    wall = time.perf_counter() - t0
    pv = rec.pose_valid
    n_cam = int(pv.sum())
    gt_c = camera_centers(gt_poses[pv])
    spread = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0))) if n_cam else 0.0
    ate = ate_rmse(rec.poses[pv], gt_poses[pv]) if n_cam >= 3 else float("inf")
    err = float(rec.mean_reprojection_error)
    return {"matcher": matcher, "cameras": n_cam, "views": len(pv), "points": rec.num_points,
            "mean_reprojection_px": err, "ate": ate, "spread": spread,
            "meets_bars": bool(n_cam >= 6 and err < 1.0 and ate < 0.05 * spread),
            "native": native.available(), "cpu_wall_s": wall,
            "stage_timings_cpu_s": {k: v for k, v in rec.stats.items() if k.endswith("_s")}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--matchers", default="of,dense,stereo,surf")
    args = ap.parse_args()
    imgs, gt_poses, K = make_scene(n_views=7, h=768, w=1024, seed=args.seed)
    for m in args.matchers.split(","):
        print(json.dumps(run_one(imgs, gt_poses, K, m, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
