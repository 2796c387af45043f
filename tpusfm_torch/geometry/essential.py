"""Batched essential-matrix estimation and decomposition.

Counterpart of ``tpusfm/geometry/essential.py``: normalized 8-point as a
weighted masked DLT, Sampson scoring, manifold LM refinement, HZ and
Horn'90 decompositions, cheirality selection, and the RANSAC drivers.
Every function takes leading batch dimensions (pairs, hypotheses,
candidates). Convention: x2^T E x1 = 0, E = [t]x R, x_2cam = R x_1cam + t.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpusfm_torch import camera
from tpusfm_torch.geometry import triangulation as tri
from tpusfm_torch.geometry.linalg import (
    batched_jacobian,
    hartley_normalize_2d,
    skew,
    smallest_singular_vector_direct,
)
from tpusfm_torch.ransac import ransac, take

_EPS = 1e-12


def _epipolar_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Rows of the 8-point system, (..., N, 9)."""
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    return torch.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v,
                        torch.ones_like(u)], -1)


def _fro_normalize(E: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.matrix_norm(E)[..., None, None]
    return E / torch.clamp(n, min=_EPS)


def essential_8pt(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized 8-point E (..., 3, 3) from (..., N, 2) normalized coords,
    projected onto diag(1, 1, 0) by SVD, unit Frobenius norm."""
    n1, T1 = hartley_normalize_2d(x1, w)
    n2, T2 = hartley_normalize_2d(x2, w)
    f = smallest_singular_vector_direct(_epipolar_rows(n1, n2), w)
    F = T2.transpose(-1, -2) @ f.reshape(*f.shape[:-1], 3, 3) @ T1
    U, _, Vt = torch.linalg.svd(F)
    return _fro_normalize(U[..., :2] @ Vt[..., :2, :])    # U diag(1, 1, 0) Vt


def _sampson_parts(E, x1, x2):
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], -1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], -1)
    Ex1 = x1h @ E.transpose(-1, -2)
    Etx2 = x2h @ E
    num = (x2h * Ex1).sum(-1)
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num, torch.sqrt(torch.clamp(den, min=_EPS))


def _sampson_signed(E, x1, x2) -> torch.Tensor:
    """Signed first-order Sampson residual (..., N)."""
    num, den = _sampson_parts(E, x1, x2)
    return num / den


def sampson_error(E, x1, x2) -> torch.Tensor:
    """Sampson epipolar distance (..., N) in normalized coordinates."""
    num, den = _sampson_parts(E, x1, x2)
    return num.abs() / den


def refine_essential(E0, x1, x2, w, *, iters: int = 8) -> torch.Tensor:
    """Levenberg-Marquardt on weighted Sampson error over the essential
    manifold E = [t]x R (R in SO(3), t on the unit sphere). Falls back to
    E0 when fewer than 8 points carry weight."""
    Rt, _, _, _ = pick_pose_by_cheirality(decompose_essential_hz(E0), x1, x2, w > 0)
    R, t = Rt[..., :3], Rt[..., 3]
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=_EPS)

    def retract(theta, R, t):
        Rn = camera.exp_so3(theta[..., :3]) @ R
        dt = theta[..., 3:]
        tn = t + dt - t * (t * dt).sum(-1, keepdim=True)
        return Rn, tn / torch.clamp(torch.linalg.vector_norm(tn, dim=-1, keepdim=True), min=_EPS)

    def resid(theta, R, t):
        Rn, tn = retract(theta, R, t)
        return _sampson_signed(skew(tn) @ Rn, x1, x2) * w

    eye6 = torch.eye(6, dtype=x1.dtype, device=x1.device)
    lam = torch.full(R.shape[:-2], 1e-3, dtype=x1.dtype, device=x1.device)
    for _ in range(iters):
        z = torch.zeros(*R.shape[:-2], 6, dtype=x1.dtype, device=x1.device)
        r = resid(z, R, t)
        J = batched_jacobian(lambda th: resid(th, R, t), z)          # (..., N, 6)
        Jt = J.transpose(-1, -2)
        H = Jt @ J + lam[..., None, None] * eye6
        step = -torch.linalg.solve_ex(H, (Jt @ r[..., None]))[0][..., 0]
        r_new = resid(step, R, t)
        better = ((r_new * r_new).sum(-1) < (r * r).sum(-1)) & torch.isfinite(step).all(-1)
        lam = torch.where(better, lam * 0.3, lam * 10.0)
        R, t = retract(torch.where(better[..., None], step, 0.0), R, t)
    E = _fro_normalize(skew(t) @ R)
    ok = ((w > 0).sum(-1) >= 8) & torch.isfinite(E).all(-1).all(-1)
    return torch.where(ok[..., None, None], E, E0)


def essential_from_poses(Rt1, Rt2) -> torch.Tensor:
    """E = [t_rel]x R_rel for a pair of known world->camera poses."""
    rel = camera.relative_pose(Rt1, Rt2)
    return _fro_normalize(skew(rel[..., 3]) @ rel[..., :3])


def decompose_essential_hz(E: torch.Tensor) -> torch.Tensor:
    """HZ SVD decomposition -> 4 candidate poses (..., 4, 3, 4)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.zeros(3, 3, dtype=E.dtype, device=E.device)
    W[0, 1], W[1, 0], W[2, 2] = -1.0, 1.0, 1.0
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return torch.stack([camera.make_pose(R1, t), camera.make_pose(R1, -t),
                        camera.make_pose(R2, t), camera.make_pose(R2, -t)], -3)


def _cofactor(E: torch.Tensor) -> torch.Tensor:
    r0, r1, r2 = E[..., 0, :], E[..., 1, :], E[..., 2, :]
    return torch.stack([torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0),
                        torch.linalg.cross(r0, r1)], -2)


def decompose_essential_horn90(E: torch.Tensor) -> torch.Tensor:
    """Horn'90 closed-form decomposition -> 4 candidate poses (..., 4, 3, 4)."""
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    EEt = E @ E.transpose(-1, -2)
    M = 0.5 * EEt.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] * eye - EEt
    d = M.diagonal(dim1=-2, dim2=-1)
    i = d.argmax(-1)
    b = take(M, i) / torch.sqrt(torch.clamp(take(d, i), min=_EPS))[..., None]
    btb = torch.clamp((b * b).sum(-1), min=_EPS)[..., None, None]
    cof = _cofactor(E)
    BE = skew(b) @ E

    def orthonormalize(R):
        U, _, Vt = torch.linalg.svd(R)
        Rp = U @ Vt
        return Rp * torch.sign(torch.linalg.det(Rp))[..., None, None]

    Ra = orthonormalize((cof - BE) / btb)
    Rb = orthonormalize((cof + BE) / btb)
    return torch.stack([camera.make_pose(Ra, b), camera.make_pose(Ra, -b),
                        camera.make_pose(Rb, b), camera.make_pose(Rb, -b)], -3)


def pick_pose_by_cheirality(candidates, x1, x2, mask):
    """Triangulate under all 4 candidates (..., 4, 3, 4) and keep the one with
    the most points in front of both cameras.
    Returns (Rt (..., 3, 4), front (..., N), front_frac (...), mean_reproj (...))."""
    P1 = torch.eye(3, 4, dtype=x1.dtype, device=x1.device)
    a, b = x1[..., None, :, :], x2[..., None, :, :]
    xyz = tri.triangulate_dlt(P1, candidates, a, b)                   # (..., 4, N, 3)
    z1 = xyz[..., 2]
    pc2 = camera.transform_points(candidates, xyz)
    z2 = pc2[..., 2]
    good = (z1 > 0) & (z2 > 0) & mask[..., None, :] & torch.isfinite(xyz).all(-1)
    p1 = xyz[..., :2] / torch.where(z1.abs() < _EPS, _EPS, z1)[..., None]
    p2 = pc2[..., :2] / torch.where(pc2[..., 2:].abs() < _EPS, _EPS, pc2[..., 2:])
    e = 0.5 * (torch.linalg.vector_norm(p1 - a, dim=-1)
               + torch.linalg.vector_norm(p2 - b, dim=-1))
    errs = torch.where(good, e, 0.0).sum(-1) / torch.clamp(good.sum(-1), min=1)
    counts = good.sum(-1)
    best = counts.argmax(-1)
    frac = take(counts, best) / torch.clamp(mask.sum(-1), min=1)
    return take(candidates, best), take(good, best), frac, take(errs, best)


def epipolar_inliers(generator, uv1, uv2, mask, K, Kinv, *, threshold_px: float = 3.0,
                     hypotheses: int = 256, sample_idx=None) -> torch.Tensor:
    """Epipolar-consistency mask (..., N) of matched pairs (no pose recovery):
    E by batched-hypothesis RANSAC, keep the Sampson-consistent matches."""
    x1 = camera.normalize_points(Kinv, uv1)
    x2 = camera.normalize_points(Kinv, uv2)
    f = 0.5 * (K[..., 0, 0] + K[..., 1, 1])

    def solver(p1, p2):
        E = essential_8pt(p1, p2)
        return E, torch.isfinite(E).all(-1).all(-1)

    def refit(E, w, p1, p2):
        return refine_essential(essential_8pt(p1, p2, w), p1, p2, w, iters=4)

    _, inl, _ = ransac(
        generator, (x1, x2), mask,
        solver=solver, scorer=sampson_error, refit=refit,
        sample_size=8, hypotheses=hypotheses, threshold=threshold_px / f,
        lo_multipliers=(8.0, 2.0, 1.0), lo_candidates=1, sample_idx=sample_idx,
    )
    return inl & mask


class TwoViewResult(NamedTuple):
    Rt: torch.Tensor            # (..., 3, 4) pose of view2 relative to view1
    E: torch.Tensor             # (..., 3, 3)
    inliers: torch.Tensor       # (..., N) bool
    inlier_ratio: torch.Tensor  # (...)
    ok: torch.Tensor            # (...) bool


def find_camera_from_match(generator, uv1, uv2, mask, K, Kinv, *,
                           threshold_px: float = 1.0, hypotheses: int = 512,
                           use_horn: bool = False, min_front_frac: float = 0.0,
                           max_front_reproj_px: float = 0.0,
                           sample_idx=None) -> TwoViewResult:
    """Two-view relative pose from matched pixel coords: E-RANSAC (LO with 8
    candidates), decomposition, cheirality, and the optional legacy gates."""
    x1 = camera.normalize_points(Kinv, uv1)
    x2 = camera.normalize_points(Kinv, uv2)
    f = 0.5 * (K[..., 0, 0] + K[..., 1, 1])

    def solver(p1, p2):
        E = essential_8pt(p1, p2)
        return E, torch.isfinite(E).all(-1).all(-1)

    def refit(E, w, p1, p2):
        return refine_essential(essential_8pt(p1, p2, w), p1, p2, w)

    E, epi_inl, _ = ransac(
        generator, (x1, x2), mask,
        solver=solver, scorer=sampson_error, refit=refit,
        sample_size=8, hypotheses=hypotheses, threshold=threshold_px / f,
        lo_multipliers=(16.0, 8.0, 4.0, 2.0, 1.0, 1.0), lo_candidates=8,
        sample_idx=sample_idx,
    )
    decompose = decompose_essential_horn90 if use_horn else decompose_essential_hz
    Rt, front, frac, front_err = pick_pose_by_cheirality(decompose(E), x1, x2, epi_inl)
    inliers = epi_inl & front
    n_in = inliers.sum(-1)
    ratio = n_in / torch.clamp(mask.sum(-1), min=1)
    ok = torch.isfinite(ratio) & (n_in >= 8)
    if min_front_frac > 0.0:
        ok = ok & (frac >= min_front_frac)
    if max_front_reproj_px > 0.0:
        ok = ok & (front_err * f < max_front_reproj_px)
    return TwoViewResult(Rt=Rt, E=E, inliers=inliers, inlier_ratio=ratio, ok=ok)
