"""Batched homography estimation (DLT) + transfer-error scoring.

Counterpart of ``tpusfm/geometry/homography.py``: the weighted masked DLT
serves as the 4-point minimal solver and the all-inlier refit; all
functions take leading batch dimensions.
"""
from __future__ import annotations

import torch

from tpusfm_torch.geometry.linalg import hartley_normalize_2d, smallest_singular_vector
from tpusfm_torch.ransac import ransac

_EPS = 1e-12


def homography_dlt(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """H (..., 3, 3) with x2 ~ H x1 from (..., N, 2) correspondences, H[2,2]=1."""
    n1, T1 = hartley_normalize_2d(x1, w)
    n2, T2 = hartley_normalize_2d(x2, w)
    u, v = n1[..., 0], n1[..., 1]
    up, vp = n2[..., 0], n2[..., 1]
    zero = torch.zeros_like(u)
    one = torch.ones_like(u)
    r1 = torch.stack([u, v, one, zero, zero, zero, -up * u, -up * v, -up], -1)
    r2 = torch.stack([zero, zero, zero, u, v, one, -vp * u, -vp * v, -vp], -1)
    A = torch.cat([r1, r2], -2)
    ww = None if w is None else torch.cat([w, w], -1)
    Hn = smallest_singular_vector(A, ww).reshape(*A.shape[:-2], 3, 3)
    H = torch.linalg.inv_ex(T2)[0] @ Hn @ T1
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(h22.abs() < _EPS, _EPS, h22)


def homography_transfer_error(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Forward transfer error |H x1 - x2| in pixels, (..., N)."""
    xh = torch.cat([x1, torch.ones_like(x1[..., :1])], -1)
    y = xh @ H.transpose(-1, -2)
    z = y[..., 2:3]
    proj = y[..., :2] / torch.where(z.abs() < _EPS, _EPS, z)
    return torch.linalg.vector_norm(proj - x2, dim=-1)


def find_homography_inliers(generator, x1, x2, mask, threshold_px: float = 10.0,
                            hypotheses: int = 256, sample_idx=None):
    """H-RANSAC inlier count for baseline-pair ranking.
    Returns (num_inliers (...), H (..., 3, 3), inlier_mask (..., N))."""

    def solver(p1, p2):
        H = homography_dlt(p1, p2)
        return H, torch.isfinite(H).all(-1).all(-1)

    best_model, inliers, count = ransac(
        generator, (x1, x2), mask,
        solver=solver, scorer=homography_transfer_error,
        sample_size=4, hypotheses=hypotheses, threshold=threshold_px,
        sample_idx=sample_idx,
    )
    return count, best_model, inliers
