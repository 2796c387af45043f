"""tpusfm's outcome with each matcher strategy on the port's 7-view scene.

    JAX_PLATFORMS=cpu python -m tests.reference_strategies [--seed 0 | --seeds 0-11]
        [--matchers of,dense,...] [--out PATH]

Renders ``tpusfm_torch.tools.synthetic.make_scene`` (7 views, 1024x768, the
scene of ``chip_smoke.py`` phases 4, 5 and 7) and runs the reference's
``SfMPipeline(...).run()`` on the CPU at the same operating point (5120
features, 2048 matches) once per strategy, with the reference's native
runtime when it builds (``rich`` takes the fused path, every other strategy
the host-driven loop). ``--seeds first-last`` sets the render seed and the
pipeline seed alike, one after the other. Prints one JSON line per
(strategy, seed) with the keys of the port's sweep,
``tpusfm_torch/tools/strategy_seeds.py``: cameras, points, mean reprojection
error, ATE to the ground truth and the camera spread, whether the strategy
meets the bars of ``chip_smoke.py`` (>= 6 of 7 cameras, < 1 px, ATE < 5% of
the spread), and the stage timings (host clock of this CPU, not a device
number); then, per strategy, the count of seeds in the bars.
``chip_smoke.py`` phase 7 holds the port to what this prints; it never
imports tpusfm itself.
"""
from __future__ import annotations

import argparse
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from tpusfm import SfMConfig  # noqa: E402
from tpusfm import native  # noqa: E402
from tpusfm.config import MatcherKind  # noqa: E402
from tpusfm.pipeline import SfMPipeline  # noqa: E402
from tpusfm.types import Intrinsics  # noqa: E402
from tpusfm_torch.tools.strategy_seeds import (  # noqa: E402
    OPERATING_POINT,
    outcome,
    parse_seeds,
    sweep,
)


def run_one(imgs, gt_poses, K, matcher: str, seed: int) -> dict:
    cfg = SfMConfig(**OPERATING_POINT, matcher=MatcherKind(matcher))
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
    t0 = time.perf_counter()
    rec = SfMPipeline(imgs, cfg, intrinsics=intr, seed=seed).run()
    wall = time.perf_counter() - t0
    return dict(outcome(matcher, seed, rec, gt_poses), native=native.available(), wall_s=wall)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", help="first-last: one run per seed (overrides --seed)")
    ap.add_argument("--matchers", default="of,dense,stereo,surf")
    ap.add_argument("--out", help="also append the JSON lines here")
    args = ap.parse_args()
    seeds = parse_seeds(args.seeds) if args.seeds else [args.seed]
    sweep(run_one, seeds, args.matchers.split(","), "cpu", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
