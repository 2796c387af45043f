"""Batched triangulation: linear DLT + Hartley–Sturm iterative refinement.

Counterpart of ``tpusfm/geometry/triangulation.py``. Points (and any
leading batch of view pairs) triangulate at once; the Hartley–Sturm
reweighting is a fixed-trip loop with a per-point converged mask.
"""
from __future__ import annotations

import torch

from tpusfm_torch import camera

_EPS = 1e-9


def inv3x3(A: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Closed-form (..., 3, 3) inverse via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A21 = f * g - d * i
    A31 = d * h - e * g
    det = a * A11 + b * A21 + c * A31
    det = torch.where(det.abs() < eps, eps, det)
    adj = torch.stack([
        torch.stack([A11, c * h - b * i, b * f - c * e], -1),
        torch.stack([A21, a * i - c * g, c * d - a * f], -1),
        torch.stack([A31, b * g - a * h, a * e - b * d], -1),
    ], -2)
    return adj / det[..., None, None]


def _dlt_rows(P: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """DLT rows x*p3 - p1, y*p3 - p2. P (..., 3, 4), xy (..., N, 2) -> (..., N, 2, 4)."""
    p0, p1, p2 = P[..., None, 0, :], P[..., None, 1, :], P[..., None, 2, :]
    return torch.stack([xy[..., 0, None] * p2 - p0, xy[..., 1, None] * p2 - p1], -2)


def _solve_homogeneous_4(A: torch.Tensor) -> torch.Tensor:
    """A (..., k, 4) rows [a | b]: least squares of A[..., :3] X = -A[..., 3]
    through closed-form 3x3 normal equations."""
    M = A[..., :3]
    b = -A[..., 3]
    Mt = M.transpose(-1, -2)
    G = Mt @ M + 1e-12 * torch.eye(3, dtype=A.dtype, device=A.device)
    return (inv3x3(G) @ (Mt @ b[..., None]))[..., 0]


def triangulate_dlt(P1, P2, x1, x2) -> torch.Tensor:
    """Linear DLT triangulation of normalized coords (..., N, 2) -> (..., N, 3)."""
    return _solve_homogeneous_4(torch.cat(
        torch.broadcast_tensors(_dlt_rows(P1, x1), _dlt_rows(P2, x2)), -2))


def triangulate_hartley_sturm(P1, P2, x1, x2, iterations: int = 10,
                              eps: float = 1e-4) -> torch.Tensor:
    """Iterative linear-LS triangulation with inverse-depth reweighting; a
    converged point (both depths moved <= eps) stops updating."""
    r1, r2 = torch.broadcast_tensors(_dlt_rows(P1, x1), _dlt_rows(P2, x2))
    X =_solve_homogeneous_4(torch.cat([r1, r2], -2))
    w1p = torch.ones_like(X[..., 0])
    w2p = torch.ones_like(X[..., 0])
    done = torch.zeros_like(X[..., 0], dtype=torch.bool)
    for _ in range(iterations):
        Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)
        w1 = torch.clamp((P1[..., None, 2, :] * Xh).sum(-1).abs(), min=_EPS)
        w2 = torch.clamp((P2[..., None, 2, :] * Xh).sum(-1).abs(), min=_EPS)
        conv = ((w1 - w1p).abs() <= eps) & ((w2 - w2p).abs() <= eps)
        A = torch.cat([r1 / w1[..., None, None], r2 / w2[..., None, None]], -2)
        X = torch.where(done[..., None], X, _solve_homogeneous_4(A))
        w1p, w2p, done = w1, w2, done | conv
    return X


def reprojection_errors(Rt, K, pts3d, uv) -> torch.Tensor:
    """Pixel reprojection error per point (..., N)."""
    return torch.linalg.vector_norm(camera.project_points(Rt, K, pts3d) - uv, dim=-1)


def depths(Rt, pts3d) -> torch.Tensor:
    """Per-point depth in the camera frame (..., N)."""
    return camera.transform_points(Rt, pts3d)[..., 2]


def triangulate_views(Rt1, Rt2, K, Kinv, uv1, uv2, mask,
                      max_reprojection_error: float = 10.0,
                      iterations: int = 10, eps: float = 1e-4):
    """Triangulate + the reference's gates (reprojection <= threshold in
    both views, in front of both cameras, finite).
    Returns (xyz (..., N, 3), keep (..., N), err1, err2)."""
    x1 = camera.normalize_points(Kinv, uv1)
    x2 = camera.normalize_points(Kinv, uv2)
    xyz = triangulate_hartley_sturm(Rt1, Rt2, x1, x2, iterations, eps)
    e1 = reprojection_errors(Rt1, K, xyz, uv1)
    e2 = reprojection_errors(Rt2, K, xyz, uv2)
    in_front = (depths(Rt1, xyz) > 0) & (depths(Rt2, xyz) > 0)
    keep = (mask & (e1 <= max_reprojection_error) & (e2 <= max_reprojection_error)
            & in_front & torch.isfinite(xyz).all(-1))
    return xyz, keep, e1, e2
