"""BASELINE config 3 stress run on the port: 4K-class images (the
Herz-Jesu-P25 regime). Counterpart of ``benchmarks/stress4k.py``.

    python -m tpusfm_torch.tools.stress4k [--views 7] [--width 3072] [--height 2048]
        [--features 5120] [--matches 2048] [--device cpu] [--out PATH]

Renders the Strecha-format fixture (``tools/synthetic.py::make_fixture``) on
the device into a fresh temporary directory, at 3072x2048 with the focal
scaled from 520 px at 512 wide and radial distortion k1=-0.2, k2=0.05, then
reconstructs it calibrated through ``SfMPipeline(...).run()`` at
downscale 1 and the reference's 5000-feature operating point (5120, a
multiple of 256 for the streaming matcher): 6 pyramid levels on top of the
pixel-scale texture, a FAST threshold of 8/255 (the band-limited noise has
about a third of a photograph's pixel-scale gradient), a map of 8192 points.
One cold run, then ``reset()`` and a warm run, which undistorts the
keypoints again.

Prints one JSON object: cameras, points, mean reprojection error, ATE and
median rotation error against the fixture's cameras, cold and warm seconds,
load and render seconds, the warm run's stage seconds, K1 launches and
largest keypoint shift by the undistortion, and the card (``nvidia-smi``
name and power limit). It is written to ``--out`` only when one is given.
Runs on the card; ``--device cpu`` rehearses at a small ``--width`` and
``--height`` and measures nothing of the device.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

from tpusfm_torch.tools.strecha_eval import (FIXTURE_DIST, calibrated_pipeline,
                                             run_with_undistortion_shift, score)


def stress_config(features: int = 5120, matches: int = 2048):
    from tpusfm_torch import SfMConfig

    return SfMConfig(downscale=1.0, ba_share_focal=False, max_features=features,
                     max_matches=matches, pyramid_levels=6, fast_threshold=8.0,
                     engine_point_capacity=8192, console_debug_level=1)


def run(views: int = 7, width: int = 3072, height: int = 2048, features: int = 5120,
        matches: int = 2048, device="cuda", card: str = "") -> dict:
    """Render, then a cold and a warm reconstruction; returns the report."""
    from tpusfm_torch.features import pallas_match
    from tpusfm_torch.tools.common import synchronize
    from tpusfm_torch.tools.synthetic import make_fixture

    with tempfile.TemporaryDirectory(prefix="strecha4k_") as d:
        t0 = time.perf_counter()
        make_fixture(d, n_views=views, h=height, w=width, focal=520.0 * width / 512.0,
                     dist=FIXTURE_DIST, device=device)
        render_s = time.perf_counter() - t0
        print(f"# fixture at {width}x{height} rendered in {render_s:.3f}s", flush=True)
        t1 = time.perf_counter()
        pipe, gt_poses = calibrated_pipeline(d, 1.0, stress_config(features, matches), device)
        load_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    pipe.run()
    synchronize(device)
    cold_s = time.perf_counter() - t2
    pipe.reset()
    launches = pallas_match.match_topk2.launches
    t3 = time.perf_counter()
    rec, shift = run_with_undistortion_shift(pipe)
    synchronize(device)
    warm_s = time.perf_counter() - t3
    launches = pallas_match.match_topk2.launches - launches

    det = score(rec, gt_poses)
    return {
        "config": f"BASELINE config 3 stress: {views} views @ {width}x{height}, "
                  f"{features} features",
        "card": card,
        **{k: det["detail"][k] for k in ("cameras", "points", "mean_reprojection_px")},
        "ate_rmse": det["value"],
        **{k: det["detail"][k] for k in ("camera_spread", "median_rotation_error_deg")},
        "cold_s": cold_s,
        "warm_s": warm_s,
        "warm_frames_per_s": views / warm_s,
        "load_s": load_s,
        "render_s": render_s,
        "stage_s": det["detail"]["stage_s"],
        "match_top2_launches_warm": launches,
        "undistortion_shift_max_px": float(shift.max()),
        "fused": bool(pipe._fused_applicable()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=7)
    ap.add_argument("--width", type=int, default=3072)
    ap.add_argument("--height", type=int, default=2048)
    ap.add_argument("--features", type=int, default=5120)
    ap.add_argument("--matches", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)

    from tpusfm_torch.tools.common import device_and_card

    device, card = device_and_card(args.device)
    out = run(args.views, args.width, args.height, args.features, args.matches, device, card)
    text = json.dumps(out, indent=1)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
