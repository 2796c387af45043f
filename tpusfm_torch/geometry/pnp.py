"""Batched PnP: DLT minimal solver + Gauss–Newton refinement + RANSAC.

Counterpart of ``tpusfm/geometry/pnp.py``; every function takes leading
batch dimensions (hypotheses).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpusfm_torch import camera
from tpusfm_torch.geometry.linalg import (
    batched_jacobian,
    hartley_normalize_2d,
    hartley_normalize_3d,
    smallest_eigenvector_psd,
)
from tpusfm_torch.ransac import ransac

_EPS = 1e-12


def _det3(M: torch.Tensor) -> torch.Tensor:
    return (M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :])).sum(-1)


def _orthogonal_polar_factor(M: torch.Tensor, iterations: int = 10) -> torch.Tensor:
    """Q of the polar decomposition M = Q H (..., 3, 3) by Newton's iteration
    with Frobenius-norm scaling (Higham 1986); quadratic once near Q."""
    X = M
    for _ in range(iterations):
        Xit = torch.linalg.inv_ex(X)[0].transpose(-1, -2)
        g = torch.sqrt(torch.linalg.matrix_norm(Xit) / torch.linalg.matrix_norm(X))
        X = 0.5 * (g[..., None, None] * X + Xit / g[..., None, None])
    return X


def pnp_dlt(X: torch.Tensor, x: torch.Tensor, w: torch.Tensor | None = None):
    """DLT PnP from (..., N, 3) world points and (..., N, 2) normalized
    coords. Returns (Rt (..., 3, 4), ok (...))."""
    Xn, T3 = hartley_normalize_3d(X, w)
    xn, T2 = hartley_normalize_2d(x, w)
    XX, YY, ZZ = Xn[..., 0], Xn[..., 1], Xn[..., 2]
    u, v = xn[..., 0], xn[..., 1]
    one = torch.ones_like(u)
    zero = torch.zeros_like(u)
    r1 = torch.stack([XX, YY, ZZ, one, zero, zero, zero, zero,
                      -u * XX, -u * YY, -u * ZZ, -u], -1)
    r2 = torch.stack([zero, zero, zero, zero, XX, YY, ZZ, one,
                      -v * XX, -v * YY, -v * ZZ, -v], -1)
    A = torch.cat([r1, r2], -2)
    if w is not None:
        A = A * torch.cat([w, w], -1)[..., None]
    Pn = smallest_eigenvector_psd(A.transpose(-1, -2) @ A).reshape(*A.shape[:-2], 3, 4)
    P = torch.linalg.inv_ex(T2)[0] @ Pn @ T3

    # tpusfm takes R from the SVD M = U S Vt; without an SVD (whose error
    # check syncs on CUDA) the same R comes from the polar factor Q = U Vt,
    # H = Q^T M = V S Vt and v3 (the last column of V): U diag(1,1,s) Vt is
    # Q - (1 - s) (Q v3) v3^T for s = +-1
    M = P[..., :3]
    Q = _orthogonal_polar_factor(M)
    H = Q.transpose(-1, -2) @ M
    H = 0.5 * (H + H.transpose(-1, -2))
    v3 = smallest_eigenvector_psd(H)[..., :, None]
    Qvv = (Q @ v3) @ v3.transpose(-1, -2)
    detUV = torch.where(_det3(M) < 0, -1.0, 1.0).to(M.dtype)
    R = Q - (1.0 - detUV)[..., None, None] * Qvv
    lam = torch.diagonal(H, dim1=-2, dim2=-1).mean(-1) * detUV       # mean(S) * det(U Vt)
    t = P[..., 3] / torch.where(lam.abs() < _EPS, _EPS, lam)[..., None]
    if w is None:
        w = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    z = camera.transform_points(camera.make_pose(R, t), X)[..., 2]
    front = torch.where(z > 0, w, 0.0).sum(-1)
    behind = torch.where(z < 0, w, 0.0).sum(-1)
    flip = behind > front
    Rf = -(Q - (1.0 + detUV)[..., None, None] * Qvv)                # U diag(1,1,-s) (-Vt)
    R = torch.where(flip[..., None, None], Rf, R)
    t = torch.where(flip[..., None], -t, t)
    ok = (torch.isfinite(R).all(-1).all(-1) & torch.isfinite(t).all(-1)
          & (lam.abs() > _EPS))
    return camera.make_pose(R, t), ok


def _pose_residuals(params: torch.Tensor, X: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Normalized reprojection residuals (..., 2N), params = (rvec, t) (..., 6)."""
    pc = camera.rotate_angle_axis(params[..., None, :3], X) + params[..., None, 3:]
    z = pc[..., 2:3]
    proj = pc[..., :2] / torch.where(z.abs() < _EPS, _EPS, z)
    return (proj - x).reshape(*proj.shape[:-2], -1)


def refine_pose_gn(Rt, X, x, w, iterations: int = 10, damping: float = 1e-6) -> torch.Tensor:
    """Fixed-iteration Gauss–Newton refinement of a pose on weighted
    correspondences (x normalized, w (..., N))."""
    params = torch.cat([camera.matrix_to_rodrigues(Rt[..., :3]), Rt[..., 3]], -1)
    w2 = torch.repeat_interleave(w, 2, dim=-1)
    eye6 = torch.eye(6, dtype=Rt.dtype, device=Rt.device)
    f = lambda p: _pose_residuals(p, X, x)
    for _ in range(iterations):
        r = f(params)
        J = batched_jacobian(f, params)                      # (..., 2N, 6)
        Jw = J * w2[..., None]
        H = Jw.transpose(-1, -2) @ J + damping * eye6
        g = Jw.transpose(-1, -2) @ r[..., None]
        new = params - torch.linalg.solve_ex(H, g)[0][..., 0]
        params = torch.where(torch.isfinite(new).all(-1, keepdim=True), new, params)
    return camera.make_pose(camera.rodrigues_to_matrix(params[..., :3]), params[..., 3:])


class PnPResult(NamedTuple):
    Rt: torch.Tensor
    inliers: torch.Tensor
    inlier_ratio: torch.Tensor
    ok: torch.Tensor


def find_camera_pose_2d3d(generator, X, uv, mask, K, Kinv, *,
                          threshold_px: float = 10.0, hypotheses: int = 256,
                          min_inlier_ratio: float = 0.5, sample_idx=None) -> PnPResult:
    """RANSAC PnP from 2D-3D matches (pixel coords) with the inlier-ratio gate."""
    x = camera.normalize_points(Kinv, uv)
    fxy = torch.stack([K[..., 0, 0], K[..., 1, 1]], -1)

    def solver(Xs, xs):
        Rt0, ok = pnp_dlt(Xs, xs)
        w6 = torch.ones(Xs.shape[:-1], dtype=Xs.dtype, device=Xs.device)
        Rt = refine_pose_gn(Rt0, Xs, xs, w6, iterations=8)
        bad = ~torch.isfinite(Rt).all(-1).all(-1)
        return torch.where(bad[..., None, None], Rt0, Rt), ok

    def scorer(Rt, Xs, xs):
        pc = camera.transform_points(Rt, Xs)
        z = pc[..., 2:3]
        proj = pc[..., :2] / torch.where(z.abs() < _EPS, _EPS, z)
        err = torch.linalg.vector_norm((proj - xs) * fxy, dim=-1)
        return torch.where(pc[..., 2] > 0, err, torch.inf)

    def refit(Rt, w, Xs, xs):
        return refine_pose_gn(Rt, Xs, xs, w)

    Rt, inl, count = ransac(
        generator, (X, x), mask,
        solver=solver, scorer=scorer, refit=refit,
        sample_size=6, hypotheses=hypotheses, threshold=threshold_px,
        sample_idx=sample_idx,
    )
    ratio = count / torch.clamp(mask.sum(-1), min=1)
    return PnPResult(Rt=Rt, inliers=inl, inlier_ratio=ratio, ok=ratio >= min_inlier_ratio)
