"""Reconstruction evaluation: similarity alignment, ATE, rotation error.

The port's own copy of ``tpusfm/eval.py`` (numpy only).

Evaluation utilities for the BASELINE metrics: reconstructions are defined
only up to a global similarity, so trajectories are Umeyama-aligned before
computing absolute trajectory error (ATE RMSE) — the standard protocol for
the EPFL/Strecha ground-truth comparisons named in BASELINE.md.
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray):
    """Closed-form similarity (s, R, t) minimizing ||dst - (s R src + t)||²
    (Umeyama 1991). src, dst: (N, 3)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (sc ** 2).sum() / len(src)
    s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    t = mu_d - s * R @ mu_s
    return s, R, t


def camera_centers(poses_Rt: np.ndarray) -> np.ndarray:
    """(V, 3, 4) world->camera [R|t] -> (V, 3) camera centers c = -R^T t."""
    poses_Rt = np.asarray(poses_Rt)
    return np.stack([-Rt[:, :3].T @ Rt[:, 3] for Rt in poses_Rt])


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """Absolute trajectory error (RMSE of camera centers) after
    similarity alignment. Both inputs (V, 3, 4)."""
    est_c = camera_centers(est_poses)
    gt_c = camera_centers(gt_poses)
    s, R, t = umeyama_alignment(est_c, gt_c)
    aligned = s * (est_c @ R.T) + t
    return float(np.sqrt(np.mean(np.sum((gt_c - aligned) ** 2, axis=1))))


def rotation_errors_deg(est_poses: np.ndarray, gt_poses: np.ndarray) -> np.ndarray:
    """Per-camera rotation error in degrees after removing the global
    rotation of the similarity alignment."""
    est_c = camera_centers(est_poses)
    gt_c = camera_centers(gt_poses)
    _, Rg, _ = umeyama_alignment(est_c, gt_c)
    errs = []
    for e, g in zip(np.asarray(est_poses), np.asarray(gt_poses)):
        # est camera-from-world after global alignment: R_e' = R_e Rg^T
        dR = g[:, :3] @ (e[:, :3] @ Rg.T).T
        c = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
        errs.append(np.degrees(np.arccos(c)))
    return np.asarray(errs)
