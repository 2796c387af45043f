"""Keypoint / epipolar-match visual debug tool.

Counterpart of ``tpusfm/tools/draw_keypoints.py``, the reference's
standalone DrawKeypoints app (legacy/DrawKeypoints.cpp:14-85): with one
image it detects keypoints and writes ``<image>_keypoints.png``; with two
images it detects + matches descriptors, filters the matches through an
epipolar (E-matrix) RANSAC consensus (the reference's GetFundamentalMat
re-filter), and writes a side-by-side match overlay.

``--detector rich`` (default) uses the FAST/BRIEF features of the main
path; ``--detector blob`` the reference tool's SURF-like blob features
(``features/blob.py``), matched by L2 distance.

Usage:
  python -m tpusfm_torch.tools.draw_keypoints [--detector rich|blob] [--device cuda] <image1> [image2]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpusfm_torch.tools.draw_keypoints")
    ap.add_argument("images", nargs="+", help="one image, or two of identical size")
    ap.add_argument("--detector", choices=["rich", "blob"], default="rich")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if len(args.images) > 2:
        ap.error("at most two images")

    import torch

    from tpusfm_torch.features import extract_features, match_pair
    from tpusfm_torch.features.blob import extract_blob_features
    from tpusfm_torch.geometry.essential import epipolar_inliers
    from tpusfm_torch.io.images import load_image
    from tpusfm_torch.types import Intrinsics, np_of
    from tpusfm_torch.viz import draw_keypoints, draw_matches

    grays = [load_image(p)[0] for p in args.images]
    # reference writes next to the input (DrawKeypoints.cpp:83); write to
    # the working directory instead so read-only datasets stay untouched
    out_path = os.path.basename(args.images[0]) + "_keypoints.png"
    if len(grays) == 2 and grays[1].shape != grays[0].shape:
        print("error: images must have identical dimensions")
        return 1
    blob = args.detector == "blob"
    extract = extract_blob_features if blob else extract_features
    f = extract(torch.as_tensor(np.stack(grays)).to(args.device), max_features=1024)
    if len(grays) == 1:
        draw_keypoints(out_path, grays[0], np_of(f.xy[0]), np_of(f.valid[0]))
        print(f"{int(f.valid.sum())} keypoints -> {out_path}")
        return 0

    m = match_pair(f.desc[0], f.valid[0], f.desc[1], f.valid[1], ratio=0.8, max_matches=1024,
                   metric="l2" if blob else "hamming")
    uv1 = f.xy[0][torch.clamp(m.idx[:, 0], min=0).long()]
    uv2 = f.xy[1][torch.clamp(m.idx[:, 1], min=0).long()]

    # epipolar re-filter (role of GetFundamentalMat in DrawKeypoints.cpp:71)
    h, w = grays[0].shape
    # mock K (legacy MultiCameraDistance.cpp:79-89)
    intr = Intrinsics.create(float(max(h, w)), w / 2, h / 2, device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(0)
    keep = epipolar_inliers(gen, uv1, uv2, m.valid, intr.K, intr.Kinv,
                            threshold_px=3.0, hypotheses=256)
    draw_matches(out_path, grays[0], grays[1], np_of(uv1), np_of(uv2), np_of(keep))
    print(f"{int(m.valid.sum())} matches, {int(keep.sum())} epipolar inliers -> {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
