"""Command-line interface (counterpart of ``tpusfm/cli.py``).

Mirrors the reference CLI (main.cpp:40-79, boost::program_options):
  --help, --console-debug <0-4>, --visual-debug <0-4>, --downscale <f>,
  --output-prefix <p>, and a positional input directory; extended with the
  feature/match capacities, the BA settings, the exports and ``--device``
  (``cuda`` unless the caller asks for ``cpu``).

Usage:
  python -m tpusfm_torch.cli [options] <input-directory>
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpusfm_torch",
        description="Incremental Structure-from-Motion on PyTorch/CUDA "
                    "(capability parity with SfM-Toy-Library's main.cpp CLI)",
    )
    p.add_argument("input_directory", help="directory of images to reconstruct")
    p.add_argument("--console-debug", type=int, default=2, metavar="LEVEL",
                   help="console verbosity 0=TRACE..4=ERROR (main.cpp:45)")
    p.add_argument("--visual-debug", type=int, default=4, metavar="LEVEL",
                   help="visual debug-dump verbosity (main.cpp:46); writes "
                        "match-overlay images instead of imshow windows")
    p.add_argument("--downscale", type=float, default=1.0,
                   help="image downscale factor (main.cpp:47)")
    p.add_argument("--output-prefix", default="output",
                   help="prefix for <prefix>_points.ply / <prefix>_cameras.ply "
                        "(main.cpp:49)")
    p.add_argument("--calibration", default=None,
                   help="OpenCV-style calibration YAML "
                        "(legacy MultiCameraDistance.cpp:78-89); default: "
                        "f=2500 mock intrinsics (SfM.cpp:70-74)")
    p.add_argument("--focal", type=float, default=None,
                   help="override focal length in (full-res) pixels")
    p.add_argument("--max-features", type=int, default=5120)
    p.add_argument("--max-matches", type=int, default=1024)
    p.add_argument("--matcher", choices=["rich", "of", "dense", "surf", "stereo"],
                   default="rich",
                   help="matcher strategy (legacy IDistance.h:32-35): "
                        "rich=detect+describe, of=LK flow, dense=grid flow, "
                        "surf=float blob descriptors, stereo=disparity sweep")
    p.add_argument("--decomposition", choices=["svd", "horn"], default="svd",
                   help="essential decomposition (FindCameraMatrices.cpp:45)")
    p.add_argument("--ba-refine-pp", action="store_true",
                   help="also refine the principal point in BA (legacy SSBA "
                        "FULL_BUNDLE_FOCAL_LENGTH_PP, BundleAdjuster.cpp:219)")
    p.add_argument("--no-ba-focal", action="store_true",
                   help="fix the shared focal during BA")
    p.add_argument("--pcd", action="store_true",
                   help="also export a .pcd cloud (legacy Visualization.cpp:360)")
    p.add_argument("--html", action="store_true",
                   help="also export an interactive HTML viewer "
                        "(stand-in for the legacy PCL/Qt viewers)")
    p.add_argument("--sor-filter", action="store_true",
                   help="statistical outlier removal before export "
                        "(meanK=50, stddev=1.0; the legacy viewer's 's'-key "
                        "toggle, legacy/Visualization.cpp:121-153)")
    p.add_argument("--live-html", default=None, metavar="PATH",
                   help="stream per-view reconstruction snapshots into a "
                        "browser viewer with a timeline slider (the legacy "
                        "Qt/QGLViewer SFMViewer role, sfmviewer.cpp:32-115)")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="with --live-html: serve the viewer over HTTP and "
                        "live-poll frames while the reconstruction runs")
    p.add_argument("--interactive", action="store_true",
                   help="interactive prompt session: directory chooser, "
                        "strategy toggles, match/run/visualize commands "
                        "(the legacy FLTK DistanceUI role, "
                        "legacy/DistanceUI.cpp:109-162)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device the reconstruction runs on (default: cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.interactive:
        from tpusfm_torch.ui import interactive_loop

        interactive_loop(args.input_directory, device=args.device)
        return 0

    from tpusfm_torch import SfMConfig
    from tpusfm_torch.config import EssentialDecomposition, MatcherKind
    from tpusfm_torch.io import load_calibration, load_image_directory
    from tpusfm_torch.pipeline import SfMPipeline

    cfg = SfMConfig(
        downscale=args.downscale,
        console_debug_level=args.console_debug,
        visual_debug_level=args.visual_debug,
        max_features=args.max_features,
        max_matches=args.max_matches,
        matcher={"of": MatcherKind.OPTICAL_FLOW,
                 "dense": MatcherKind.DENSE,
                 "surf": MatcherKind.SURF,
                 "stereo": MatcherKind.STEREO}.get(args.matcher, MatcherKind.RICH),
        decomposition=(EssentialDecomposition.HORN90 if args.decomposition == "horn"
                       else EssentialDecomposition.SVD_HZ),
        ba_share_focal=not args.no_ba_focal,
        ba_refine_pp=args.ba_refine_pp,
    )
    if args.focal is not None:
        cfg.default_focal = args.focal

    imgs = load_image_directory(args.input_directory, cfg.downscale)
    intr = None
    if args.calibration:
        h, w = imgs.shape
        intr = load_calibration(args.calibration, w, h, cfg.downscale, device=args.device)
    pipe = SfMPipeline(imgs.gray, cfg, images_rgb=imgs.rgb,
                       intrinsics=intr, seed=args.seed, device=args.device)
    if args.live_html:
        from tpusfm_torch.viz.live_viewer import LiveViewer

        viewer = LiveViewer(args.live_html)
        if args.serve:
            print(f"live viewer at {viewer.serve(args.serve)}")
        pipe.add_listener(viewer.update)
    rec = pipe.run()
    if args.sor_filter:
        from tpusfm_torch.viz import sor_filter_mask

        keep = sor_filter_mask(rec.xyz, device=args.device)
        print(f"SOR filter: {len(keep)} -> {int(keep.sum())} points")
        rec = rec.select_points(keep)
    rec.save_ply(args.output_prefix)
    if args.pcd:
        from tpusfm_torch.io import save_pcd

        save_pcd(args.output_prefix + "_points.pcd", rec.xyz, rec.rgb)
    if args.html:
        rec.save_html(args.output_prefix + "_viewer.html")
    print(f"saved {rec.num_points} points, "
          f"{int(rec.pose_valid.sum())}/{len(rec.pose_valid)} cameras "
          f"-> {args.output_prefix}_points.ply / _cameras.ply "
          f"(mean reprojection error {rec.mean_reprojection_error:.3f}px)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
