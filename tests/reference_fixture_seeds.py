"""tpusfm's outcome on the distorted Strecha-format fixture, seed by seed.

    JAX_PLATFORMS=cpu python -m tests.reference_fixture_seeds [--seeds 0-23]

Renders ``benchmarks/strecha_fixture.py::make_fixture`` (9 views, 512x384,
k1=-0.2, k2=0.05) and runs the calibrated reconstruction of
``benchmarks/strecha_eval.py`` (2048 features, 1024 matches,
``ba_share_focal=False``) once per seed through ``SfMPipeline(..., seed=)``
on the CPU. Prints one JSON line per seed (cameras, mean reprojection error,
ATE, whether it meets the bars of ``chip_smoke.py`` phase 9 (a): >= 8 of 9
cameras, < 1 px, ATE < 1% of the camera spread) and a last line with the
count that does. The reconstruction is bimodal, in tpusfm as in the port
(``python -m tpusfm_torch.tools.strecha_eval --fixture --seeds 0-23``):
``chip_smoke.py`` holds the port to this rate over its seeds.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from benchmarks.strecha_eval import load_strecha_camera  # noqa: E402
from benchmarks.strecha_fixture import make_fixture  # noqa: E402
from tpusfm import SfMConfig  # noqa: E402
from tpusfm.eval import ate_rmse, camera_centers  # noqa: E402
from tpusfm.io import load_image_directory  # noqa: E402
from tpusfm.pipeline import SfMPipeline  # noqa: E402
from tpusfm.types import Intrinsics  # noqa: E402

DIST = (-0.20, 0.05, 0.0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0-23", help="first-last, inclusive")
    args = ap.parse_args()
    first, last = (int(x) for x in args.seeds.split("-"))
    with tempfile.TemporaryDirectory(prefix="strecha_fixture_") as d:
        make_fixture(d, dist=DIST)
        cams = sorted(f for f in os.listdir(d) if f.endswith(".camera"))
        gt = [load_strecha_camera(os.path.join(d, f)) for f in cams]
        imgs = load_image_directory(d, 1.0)
    K, gt_poses = gt[0][0], np.stack([g[2] for g in gt])
    gt_c = camera_centers(gt_poses)
    spread = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
    intr = Intrinsics.create(K[0, 0], K[0, 2], K[1, 2], dist=[DIST[0], DIST[1], 0.0, 0.0, DIST[2]])
    cfg = SfMConfig(downscale=1.0, ba_share_focal=False, max_features=2048, max_matches=1024,
                    console_debug_level=5)
    good = 0
    for seed in range(first, last + 1):
        t0 = time.perf_counter()
        rec = SfMPipeline(imgs.gray, cfg, images_rgb=imgs.rgb, intrinsics=intr, seed=seed).run()
        sel = rec.pose_valid
        ate = ate_rmse(rec.poses[sel], gt_poses[sel]) if sel.sum() >= 3 else float("inf")
        ok = bool(sel.sum() >= 8 and rec.mean_reprojection_error < 1.0 and ate < 0.01 * spread)
        good += ok
        print(json.dumps({"seed": seed, "cameras": f"{int(sel.sum())}/{len(sel)}",
                          "mean_reprojection_px": float(rec.mean_reprojection_error),
                          "ate": ate, "spread": spread, "meets_bars": ok,
                          "cpu_s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"seeds": f"{first}-{last}", "meeting_bars": good}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
