"""The comparison that decides ``correct``, and the outcome bars.

Every job's reconstruction is judged by the plain float64 code of
``portbench.reference.geometry`` from what it returned (poses, points,
observations, the keypoints they index, K). For the jobs whose front half
the harness kept, the keypoints and descriptors are held against the plain
detector's own (``reference.detect``, from the same images) and every
matcher call against the plain matcher over the descriptors that call was
given (``reference.match``): the matcher is followed step by step from the
program's own descriptors, and the descriptors are judged on their own.

The control puts the plain code, run in bfloat16, in the program's place:
the detector (``reference_features(..., dtype=torch.bfloat16)``) and the
final refinement of points and cameras (``judge_reconstruction(...,
control=True)``); its numbers go through the same comparison.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import detect as ref_detect
from portbench.reference import geometry
from portbench.reference import match as ref_match

KP_TOL_PX = 0.05


def reference_features(images: np.ndarray, sfm_cfg, device, dtype=torch.float64):
    return ref_detect.detect(
        torch.as_tensor(images, device=device), max_features=sfm_cfg.max_features,
        bits=sfm_cfg.desc_bits, levels=sfm_cfg.pyramid_levels, scale=sfm_cfg.pyramid_scale,
        fast_threshold=sfm_cfg.fast_threshold / 255.0, dtype=dtype)


def compare_features(prog, ref):
    """(kp_miss, desc_miss): the larger share, over both sides, of valid
    keypoints with no keypoint of the other side within ``KP_TOL_PX``; and
    the share of descriptor bits that differ between co-located keypoints."""
    pxy, pdesc, pvalid = prog
    rxy, rdesc, rvalid = ref
    miss_r = miss_p = n_r = n_p = bits = diff = 0
    for v in range(pxy.shape[0]):
        P = pxy[v][pvalid[v]].to(torch.float64)
        R = rxy[v][rvalid[v]].to(torch.float64)
        n_r, n_p = n_r + len(R), n_p + len(P)
        if not len(R) or not len(P):
            miss_r, miss_p = miss_r + len(R), miss_p + len(P)
            continue
        d = torch.cdist(R, P)
        dr, ar = d.min(1)
        dp, _ = d.min(0)
        found = dr <= KP_TOL_PX
        miss_r += int((~found).sum())
        miss_p += int((dp > KP_TOL_PX).sum())
        pd = torch.where(pdesc[v][pvalid[v]] > 0, 1.0, -1.0).to(torch.float64)
        rd = rdesc[v][rvalid[v]]
        diff += int((pd[ar[found]] != rd[found]).sum())
        bits += int(found.sum()) * rd.shape[-1]
    kp = max(miss_r / max(n_r, 1), miss_p / max(n_p, 1))
    return kp, diff / max(bits, 1)


def compare_matches(feats, pairs, m, sfm_cfg) -> tuple[int, int]:
    """(mismatches, reference matches) of one matcher call: matches in one
    side and not the other, or at another distance."""
    desc = torch.where(feats.desc > 0, 1.0, -1.0)
    valid = feats.valid
    idx, mvalid, dist = m.idx.long(), m.valid, m.dist
    bad = total = 0
    for p, (i, j) in enumerate(pairs.tolist()):
        left, right, d = ref_match.match_pair(desc[i], valid[i], desc[j], valid[j],
                                              ratio=sfm_cfg.match_ratio,
                                              max_matches=sfm_cfg.max_matches)
        ref = {(a, b): c for a, b, c in zip(left.tolist(), right.tolist(), d.tolist())}
        sel = mvalid[p]
        got = {(a, b): c for (a, b), c in zip(idx[p][sel].tolist(), dist[p][sel].tolist())}
        bad += len(ref.keys() ^ got.keys())
        bad += sum(1 for k in ref.keys() & got.keys() if ref[k] != got[k])
        total += len(ref)
    return bad, total


def judge_reconstruction(out, scene, bars, huber: float, device, control: bool = False):
    """Float64 numbers of one job's reconstruction: cameras, points,
    observations, mean reprojection px (and its sum), ATE and spread, the
    point and camera gaps, and whether the job meets the bars. ``control``
    puts the plain refinement run in bfloat16 in the final bundle
    adjustment's place: the gaps are then those of the points that
    ``refine_points`` and of the cameras that ``refine_cameras`` make in
    bfloat16 from the returned state."""
    pv = np.asarray(out["pose_valid"], bool)
    sel = pv[out["obs_view"]]
    op, ov, of = out["obs_point"][sel], out["obs_view"][sel], out["obs_feat"][sel]
    uv = out["feat_xy"][ov, of]
    poses, xyz = out["poses"], out["xyz"]
    err = geometry.reprojection(poses, out["K"], xyz, op, ov, uv, device=device)
    gap_poses, gap_xyz = poses, xyz
    if control and len(op):
        low, _, _ = geometry.refine_points(poses, out["K"], xyz, op, ov, uv, huber=huber,
                                           dtype=torch.bfloat16, device=device)
        gap_xyz = low.double().cpu().numpy()
        low, _, _ = geometry.refine_cameras(poses, out["K"], xyz, op, ov, uv, huber=huber,
                                            dtype=torch.bfloat16, device=device)
        gap_poses = low.double().cpu().numpy()
    nan = float("nan")
    gaps = {
        "point_gap": (geometry.point_gap(poses, out["K"], gap_xyz, op, ov, uv, huber=huber,
                                         device=device) if len(op) else nan),
        "camera_gap": (geometry.camera_gap(gap_poses, out["K"], xyz, op, ov, uv, huber=huber,
                                           device=device) if len(op) else nan),
    }
    ate, spread = geometry.ate(poses[pv], scene["gt_poses"][pv])
    px = float(err.mean()) if len(err) else float("inf")
    cams = int(pv.sum())
    return {
        "cameras": cams, "views": len(pv), "points": int(len(xyz)), "obs": int(len(err)),
        "px": px, "px_sum": float(err.sum()), "reported_px": out["reported_px"],
        "ate": ate, "spread": spread, **gaps,
        "in_bars": bool(cams >= bars["min_cameras"] and px < bars["max_reprojection_px"]
                        and ate < bars["max_ate_of_spread"] * spread),
    }
