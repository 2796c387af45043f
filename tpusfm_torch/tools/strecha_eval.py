"""Ground-truth evaluation on a Strecha-format dataset: the port's
counterpart of ``benchmarks/strecha_eval.py``.

    python -m tpusfm_torch.tools.strecha_eval DIR [--downscale N] [--device cpu] [--out PATH]
    python -m tpusfm_torch.tools.strecha_eval --fixture [--views N] [--seeds 0-23] [--device cpu]
        [--out PATH]

A dataset directory (EPFL/Strecha's fountain-P11, Herz-Jesu-P25, or the
rendered fixture) holds the images and one ``.camera`` file per image: K
(rows 1-3), the radial distortion k1 k2 k3 (row 4), R camera->world (rows
5-7), the camera centre in world coordinates (row 8), the image size (row 9).
The reconstruction is calibrated: K and the distortion of the first camera
file (the focal and principal point divided by the downscale; the
coefficients act on normalised coordinates, so they stay), and BA keeps the
focal fixed (``ba_share_focal=False``), as a free focal on a near-linear
trajectory drifts into the dolly-zoom ambiguity.

``--fixture`` renders the Strecha-format fixture of
``tools/synthetic.py::make_fixture`` (9 views, 512x384, k1=-0.2, k2=0.05)
on the device into a fresh temporary directory, removed afterwards, and
evaluates it at 2048 features and 1024 matches, the feature density of the
reference's 5000 at 1024x768.

Prints one JSON line per seed (``--seeds``, 0 by default): ATE RMSE of the
camera centres after similarity alignment, cameras, points, mean
reprojection error, median rotation error, the stage timings and the card
(``nvidia-smi`` name and power limit); with several seeds, a last line with
the count that meets the bars (all cameras but one, < 1 px, ATE < 5% of the
camera spread). The fixture's reconstruction is bimodal, in tpusfm as in the
port: whether the trajectory is right follows the baseline pair that the
seed's random ranking tries first. The lines are written to ``--out`` only
when one is given. Runs on the card; ``--device
cpu`` rehearses on the CPU and measures nothing of the device.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

FIXTURE_DIST = (-0.20, 0.05, 0.0)
FIXTURE_CONFIG = dict(downscale=1.0, ba_share_focal=False, max_features=2048, max_matches=1024)


def load_strecha_camera(path: str):
    """Parse one .camera file -> (K (3,3), dist (3,), Rt (3,4) world->camera)."""
    vals = []
    for line in open(path):
        vals.extend(float(x) for x in line.split())
    vals = np.asarray(vals, np.float64)
    K = vals[:9].reshape(3, 3)
    dist = vals[9:12]                  # radial distortion (k1 k2 k3)
    R_cw = vals[12:21].reshape(3, 3)   # camera -> world
    c = vals[21:24]                    # camera center, world coords
    R = R_cw.T                         # world -> camera
    t = -R @ c
    return K, dist, np.concatenate([R, t[:, None]], axis=1)


def load_ground_truth(dataset_dir: str):
    """(K (3,3), dist (3,), gt_poses (V,3,4)) of a dataset directory's .camera
    files, sorted by name."""
    cam_files = sorted(f for f in os.listdir(dataset_dir) if f.endswith(".camera"))
    if not cam_files:
        raise FileNotFoundError(f"no .camera ground-truth files in {dataset_dir}")
    gt = [load_strecha_camera(os.path.join(dataset_dir, f)) for f in cam_files]
    return gt[0][0], gt[0][1], np.stack([g[2] for g in gt])


def calibrated_pipeline(dataset_dir: str, downscale: float = 2.0, config=None, device="cuda",
                        dist=None):
    """The images of a dataset directory in an ``SfMPipeline`` calibrated from
    its first camera file; ``dist`` (k1, k2, k3) replaces the file's
    coefficients where given. Returns (pipeline, gt_poses (V,3,4))."""
    from tpusfm_torch import SfMConfig
    from tpusfm_torch.io import load_image_directory
    from tpusfm_torch.pipeline import SfMPipeline
    from tpusfm_torch.types import Intrinsics

    gt_K, gt_dist, gt_poses = load_ground_truth(dataset_dir)
    k1, k2, k3 = gt_dist if dist is None else dist
    imgs = load_image_directory(dataset_dir, downscale)
    f = 0.5 * (gt_K[0, 0] + gt_K[1, 1]) / downscale
    intr = Intrinsics.create(f, gt_K[0, 2] / downscale, gt_K[1, 2] / downscale,
                             dist=[k1, k2, 0.0, 0.0, k3])
    cfg = config or SfMConfig(downscale=downscale, ba_share_focal=False)
    pipe = SfMPipeline(imgs.gray, cfg, images_rgb=imgs.rgb, intrinsics=intr, device=device)
    return pipe, gt_poses


def score(rec, gt_poses) -> dict:
    """ATE and the outcome of a reconstruction against the ground truth."""
    from tpusfm_torch.eval import ate_rmse, camera_centers, rotation_errors_deg

    sel = rec.pose_valid
    gt_c = camera_centers(gt_poses)
    enough = int(sel.sum()) >= 3
    return {
        "metric": "strecha_ate_rmse",
        "value": ate_rmse(rec.poses[sel], gt_poses[sel]) if enough else float("inf"),
        "unit": "scene units (RMSE after similarity alignment)",
        "detail": {
            "cameras": f"{int(sel.sum())}/{len(sel)}",
            "points": rec.num_points,
            "mean_reprojection_px": rec.mean_reprojection_error,
            "median_rotation_error_deg": (float(np.median(rotation_errors_deg(
                rec.poses[sel], gt_poses[sel]))) if enough else float("inf")),
            "camera_spread": float(np.linalg.norm(gt_c.max(0) - gt_c.min(0))),
            "stage_s": {k: v for k, v in rec.stats.items() if isinstance(v, float)},
        },
    }


def run_with_undistortion_shift(pipe):
    """``pipe.run()``, and how far its undistortion moved the detector's
    keypoints: (reconstruction, shift in px of each valid keypoint)."""
    raw = {}
    extract = pipe._extract
    pipe._extract = lambda imgs: raw.setdefault("features", extract(imgs))
    try:
        rec = pipe.run()
    finally:
        pipe._extract = extract
    xy, valid = raw["features"].xy.cpu().numpy(), raw["features"].valid.cpu().numpy()
    return rec, np.linalg.norm(pipe.feat_xy - xy, axis=-1)[valid]


def evaluate(dataset_dir: str, downscale: float = 2.0, config=None, device="cuda") -> dict:
    """``benchmarks/strecha_eval.py::evaluate`` on the port: the calibrated
    reconstruction of ``dataset_dir`` scored against its camera files."""
    pipe, gt_poses = calibrated_pipeline(dataset_dir, downscale, config, device)
    return score(pipe.run(), gt_poses)


def evaluate_seeds(dataset_dir: str, seeds, downscale: float = 2.0, config=None,
                   device="cuda") -> list:
    """``evaluate`` once per seed of ``seeds`` (``SfMPipeline.reset(seed)``):
    the reconstruction's random streams, and so its basin, follow the seed."""
    pipe, gt_poses = calibrated_pipeline(dataset_dir, downscale, config, device)
    out = []
    for seed in seeds:
        pipe.reset(seed)
        out.append(dict(score(pipe.run(), gt_poses), seed=seed))
    return out


def meets_bars(result: dict, ate_frac: float = 0.05) -> bool:
    """All cameras but one, < 1 px, ATE < ``ate_frac`` of the camera spread."""
    det = result["detail"]
    n, of = (int(x) for x in det["cameras"].split("/"))
    return (n >= of - 1 and det["mean_reprojection_px"] < 1.0
            and result["value"] < ate_frac * det["camera_spread"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset", nargs="?", help="a Strecha-format directory")
    ap.add_argument("--fixture", action="store_true",
                    help="render the Strecha-format fixture and evaluate it")
    ap.add_argument("--views", type=int, default=9, help="fixture views")
    ap.add_argument("--downscale", type=float, default=2.0, help="for a dataset directory")
    ap.add_argument("--seeds", default="0",
                    help="a seed or first-last: one reconstruction per seed, and the count "
                         "that meets the bars")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    if args.fixture == bool(args.dataset):
        ap.error("give a dataset directory or --fixture")
    first, _, last = args.seeds.partition("-")
    seeds = range(int(first), int(last or first) + 1)

    from tpusfm_torch import SfMConfig
    from tpusfm_torch.tools.common import device_and_card
    from tpusfm_torch.tools.synthetic import make_fixture

    device, card = device_and_card(args.device)
    if args.fixture:
        with tempfile.TemporaryDirectory(prefix="strecha_fixture_") as d:
            make_fixture(d, n_views=args.views, dist=FIXTURE_DIST, device=device)
            results = evaluate_seeds(d, seeds, 1.0, SfMConfig(**FIXTURE_CONFIG), device)
        for r in results:
            r["detail"]["dataset"] = ("synthetic Strecha-format fixture "
                                      f"(k1={FIXTURE_DIST[0]}, k2={FIXTURE_DIST[1]})")
    else:
        results = evaluate_seeds(args.dataset, seeds, args.downscale, device=device)
    lines = [json.dumps(dict(r, card=card)) for r in results]
    if len(results) > 1:
        lines.append(json.dumps({"seeds": args.seeds, "card": card,
                                 "meeting_bars": sum(meets_bars(r) for r in results)}))
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
