"""Plain float64 judgement of a reconstruction.

* ``reprojection``: each observation's pixel error, the returned points
  projected through the returned poses and pinhole K.
* ``ate``: camera centres after a similarity (Umeyama) alignment to the
  ground truth, and the ground truth's spread.
* ``point_gap``: how far the returned points are from the least cost the
  returned cameras allow. Every point is refined alone by damped
  Gauss-Newton on its own observations (the cameras held), with the loss
  the configuration's final bundle adjustment states (squared, or Huber);
  the gap is the share of the total cost that this removes. A bundle
  adjustment that converged leaves about nothing to remove.
* ``camera_gap``: the same of the cameras: every registered camera refined
  alone (its rotation and translation; the points and K held) by damped
  Gauss-Newton on its own observations.

The control puts ``refine_points`` and ``refine_cameras`` run in bfloat16
in the place of the program's final points and cameras and takes their gaps.
"""
from __future__ import annotations

import numpy as np
import torch


def _project(Rt, K, X):
    """Rt (O, 3, 4), K (3, 3), X (O, 3) -> pixels (O, 2), depth (O,)."""
    pc = (Rt[:, :, :3] @ X[:, :, None])[:, :, 0] + Rt[:, :, 3]
    z = pc[:, 2]
    zs = torch.where(z.abs() < 1e-12, 1e-12, z)
    uv = torch.stack([K[0, 0] * pc[:, 0] / zs + K[0, 2], K[1, 1] * pc[:, 1] / zs + K[1, 2]], -1)
    return uv, pc, zs


def reprojection(poses, K, xyz, obs_point, obs_view, obs_uv, device="cpu") -> np.ndarray:
    """Pixel error of every observation (O,), in float64."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    uv, _, _ = _project(t(poses)[obs_view], t(K), t(xyz)[obs_point])
    return torch.linalg.vector_norm(uv - t(obs_uv), dim=-1).cpu().numpy()


def _rho(s, huber: float):
    if huber <= 0:
        return s * s
    return torch.where(s <= huber, s * s, 2.0 * huber * s - huber * huber)


def _solve3(A, b):
    """Batched 3x3 solve by the adjugate, in any floating dtype: (N, 3, 3),
    (N, 3) -> (N, 3), zero where the matrix is singular."""
    c0 = torch.cross(A[:, 1], A[:, 2], dim=-1)
    c1 = torch.cross(A[:, 2], A[:, 0], dim=-1)
    c2 = torch.cross(A[:, 0], A[:, 1], dim=-1)
    det = (A[:, 0] * c0).sum(-1)
    x = (c0 * b[:, 0:1] + c1 * b[:, 1:2] + c2 * b[:, 2:3]) / torch.where(det == 0, 1, det)[:, None]
    return torch.where((det != 0)[:, None] & torch.isfinite(x), x, 0)


def refine_points(poses, K, xyz, obs_point, obs_view, obs_uv, *, huber: float = 0.0,
                  iterations: int = 8, dtype=torch.float64, device="cpu"):
    """Each point refined alone by damped Gauss-Newton on its observations,
    the cameras held, every operation in ``dtype``: (points (N, 3), the
    total cost before, after)."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)
    Rt_o, Kt, uv_o = t(poses)[obs_view], t(K), t(obs_uv)
    op = torch.as_tensor(np.asarray(obs_point, np.int64), device=device)
    X = t(xyz).clone()
    N = X.shape[0]
    R = Rt_o[:, :, :3]
    fx, fy = Kt[0, 0], Kt[1, 1]

    def per_point_cost(X):
        uv, _, _ = _project(Rt_o, Kt, X[op])
        c = _rho(torch.linalg.vector_norm(uv - uv_o, dim=-1), huber)
        return torch.zeros(N, dtype=dtype, device=device).index_add_(0, op, c)

    cost = per_point_cost(X)
    c0 = float(cost.double().sum())
    lam = torch.full((N,), 1e-3, dtype=dtype, device=device)
    for _ in range(iterations):
        uv, pc, z = _project(Rt_o, Kt, X[op])
        r = uv - uv_o                                                # (O, 2)
        s = torch.linalg.vector_norm(r, dim=-1)
        w = (torch.ones_like(s) if huber <= 0
             else torch.where(s <= huber, 1.0, huber / s.clamp_min(1e-12)).to(dtype))
        zero = torch.zeros_like(z)
        J_pc = torch.stack([torch.stack([fx / z, zero, -fx * pc[:, 0] / (z * z)], -1),
                            torch.stack([zero, fy / z, -fy * pc[:, 1] / (z * z)], -1)], 1)
        J = (J_pc[:, :, :, None] * R[:, None, :, :]).sum(2)           # (O, 2, 3) = J_pc @ R
        JtJ = (J[:, :, :, None] * J[:, :, None, :]).sum(1)           # (O, 3, 3)
        Jtr = (J * r[:, :, None]).sum(1)                              # (O, 3)
        H = torch.zeros(N, 3, 3, dtype=dtype, device=device).index_add_(
            0, op, w[:, None, None] * JtJ)
        g = torch.zeros(N, 3, dtype=dtype, device=device).index_add_(0, op, w[:, None] * Jtr)
        A = H + torch.diag_embed(lam[:, None] * torch.diagonal(H, dim1=1, dim2=2))
        step = _solve3(A, -g)
        trial = per_point_cost(X + step)
        better = trial < cost
        X = torch.where(better[:, None], X + step, X)
        cost = torch.where(better, trial, cost)
        lam = torch.where(better, lam * 0.3, lam * 10.0).clamp(1e-9, 1e9)
    return X, c0, float(cost.double().sum())


def _rodrigues(w):
    """Rotation matrices (N, 3, 3) of axis-angle vectors (N, 3), in their dtype."""
    th = torch.linalg.vector_norm(w, dim=-1).clamp_min(1e-12)[:, None, None]
    z = torch.zeros_like(w[:, 0])
    Wx = torch.stack([torch.stack([z, -w[:, 2], w[:, 1]], -1),
                      torch.stack([w[:, 2], z, -w[:, 0]], -1),
                      torch.stack([-w[:, 1], w[:, 0], z], -1)], 1)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand_as(Wx)
    return eye + torch.sin(th) / th * Wx + (1 - torch.cos(th)) / (th * th) * (Wx @ Wx)


def _solve_spd(A, b):
    """Batched solve of symmetric positive definite systems (N, n, n), (N, n)
    by elimination without pivoting, in any floating dtype; zero where a
    pivot vanishes."""
    A, b = A.clone(), b.clone()
    n = A.shape[-1]
    for k in range(n):
        piv = A[:, k, k]
        piv = torch.where(piv == 0, 1, piv)
        f = A[:, k + 1:, k] / piv[:, None]
        A[:, k + 1:, :] = A[:, k + 1:, :] - f[:, :, None] * A[:, k:k + 1, :]
        b[:, k + 1:] = b[:, k + 1:] - f * b[:, k:k + 1]
    x = torch.zeros_like(b)
    for k in reversed(range(n)):
        piv = A[:, k, k]
        x[:, k] = (b[:, k] - (A[:, k, k + 1:] * x[:, k + 1:]).sum(-1)) / torch.where(
            piv == 0, 1, piv)
    return torch.where(torch.isfinite(x), x, 0)


def refine_cameras(poses, K, xyz, obs_point, obs_view, obs_uv, *, huber: float = 0.0,
                   iterations: int = 8, dtype=torch.float64, device="cpu"):
    """Each camera refined alone by damped Gauss-Newton on its observations,
    the points and K held, every operation in ``dtype``: a camera's step is a
    rotation ``exp(w)`` and a shift ``v`` of its frame (x_cam -> exp(w) x_cam +
    v). Returns (poses (V, 3, 4), the total cost before, after)."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)
    Rt, Kt, uv_o, X_o = t(poses), t(K), t(obs_uv), t(xyz)[np.asarray(obs_point)]
    ov = torch.as_tensor(np.asarray(obs_view, np.int64), device=device)
    V = Rt.shape[0]
    fx, fy = Kt[0, 0], Kt[1, 1]

    def per_camera_cost(Rt):
        uv, _, _ = _project(Rt[ov], Kt, X_o)
        c = _rho(torch.linalg.vector_norm(uv - uv_o, dim=-1), huber)
        return torch.zeros(V, dtype=dtype, device=device).index_add_(0, ov, c)

    cost = per_camera_cost(Rt)
    c0 = float(cost.double().sum())
    lam = torch.full((V,), 1e-3, dtype=dtype, device=device)
    for _ in range(iterations):
        uv, pc, z = _project(Rt[ov], Kt, X_o)
        r = uv - uv_o                                                # (O, 2)
        s = torch.linalg.vector_norm(r, dim=-1)
        w = (torch.ones_like(s) if huber <= 0
             else torch.where(s <= huber, 1.0, huber / s.clamp_min(1e-12)).to(dtype))
        zero = torch.zeros_like(z)
        J_pc = torch.stack([torch.stack([fx / z, zero, -fx * pc[:, 0] / (z * z)], -1),
                            torch.stack([zero, fy / z, -fy * pc[:, 1] / (z * z)], -1)], 1)
        # d(exp(w) pc + v)/d(w, v) at 0 = [-[pc]x | I]
        x, y, q = pc[:, 0], pc[:, 1], pc[:, 2]
        one = torch.ones_like(z)
        D = torch.stack([torch.stack([zero, q, -y, one, zero, zero], -1),
                         torch.stack([-q, zero, x, zero, one, zero], -1),
                         torch.stack([y, -x, zero, zero, zero, one], -1)], 1)
        J = (J_pc[:, :, :, None] * D[:, None, :, :]).sum(2)           # (O, 2, 6)
        JtJ = (J[:, :, :, None] * J[:, :, None, :]).sum(1)           # (O, 6, 6)
        Jtr = (J * r[:, :, None]).sum(1)                              # (O, 6)
        H = torch.zeros(V, 6, 6, dtype=dtype, device=device).index_add_(
            0, ov, w[:, None, None] * JtJ)
        g = torch.zeros(V, 6, dtype=dtype, device=device).index_add_(0, ov, w[:, None] * Jtr)
        A = H + torch.diag_embed(lam[:, None] * torch.diagonal(H, dim1=1, dim2=2))
        step = _solve_spd(A, -g)
        Rw = _rodrigues(step[:, :3])
        trial_Rt = torch.cat([Rw @ Rt[:, :, :3], (Rw @ Rt[:, :, 3:])[:, :, 0:1]
                              + step[:, 3:, None]], -1)
        trial = per_camera_cost(trial_Rt)
        better = trial < cost
        Rt = torch.where(better[:, None, None], trial_Rt, Rt)
        cost = torch.where(better, trial, cost)
        lam = torch.where(better, lam * 0.3, lam * 10.0).clamp(1e-9, 1e9)
    return Rt, c0, float(cost.double().sum())


def parallax_deg(poses, xyz, obs_point, obs_view) -> np.ndarray:
    """Each point's parallax in degrees: twice the widest angle between one of
    its viewing rays (camera centre to point) and their mean direction."""
    X = np.asarray(xyz, np.float64)
    ray = X[obs_point] - centres(poses)[obs_view]
    ray /= np.maximum(np.linalg.norm(ray, axis=1, keepdims=True), 1e-300)
    mean = np.zeros_like(X)
    np.add.at(mean, obs_point, ray)
    mean /= np.maximum(np.linalg.norm(mean, axis=1, keepdims=True), 1e-300)
    ang = np.degrees(np.arccos(np.clip((ray * mean[obs_point]).sum(1), -1.0, 1.0)))
    widest = np.zeros(len(X))
    np.maximum.at(widest, obs_point, ang)
    return 2.0 * widest


def point_gap(poses, K, xyz, obs_point, obs_view, obs_uv, *, huber: float = 0.0,
              min_parallax_deg: float = 1.0, device="cpu") -> float:
    """Share of the float64 cost of the points the observations determine
    (parallax of at least ``min_parallax_deg``) that refining each such
    point alone removes: 0 when every one is at its optimum for the returned
    cameras. Points seen along nearly one ray lie anywhere along it at
    nearly the same cost (the port returns some at 1e14 and beyond), so
    their cost says nothing of how far a solve went."""
    keep, op, ov, sel = _determined(poses, xyz, obs_point, obs_view, min_parallax_deg)
    if not sel.any():
        return 0.0
    _, c0, c1 = refine_points(poses, K, np.asarray(xyz)[keep], op, ov, np.asarray(obs_uv)[sel],
                              huber=huber, device=device)
    return (c0 - c1) / max(c0, 1e-300)


def _determined(poses, xyz, obs_point, obs_view, min_parallax_deg):
    """The points with at least ``min_parallax_deg`` of parallax, renumbered,
    and the observations of them: (keep, obs_point, obs_view, selection)."""
    obs_point, obs_view = np.asarray(obs_point), np.asarray(obs_view)
    keep = parallax_deg(poses, xyz, obs_point, obs_view) >= min_parallax_deg
    sel = keep[obs_point]
    remap = np.cumsum(keep) - 1
    return keep, remap[obs_point[sel]], obs_view[sel], sel


def camera_gap(poses, K, xyz, obs_point, obs_view, obs_uv, *, huber: float = 0.0,
               min_parallax_deg: float = 1.0, device="cpu") -> float:
    """Share of the float64 cost of the observations of the points the
    observations determine (``point_gap``'s rule) that refining each camera
    alone removes, the points held: 0 when every camera is at its optimum
    for the returned points."""
    keep, op, ov, sel = _determined(poses, xyz, obs_point, obs_view, min_parallax_deg)
    if not sel.any():
        return 0.0
    _, c0, c1 = refine_cameras(poses, K, np.asarray(xyz)[keep], op, ov,
                               np.asarray(obs_uv)[sel], huber=huber, device=device)
    return (c0 - c1) / max(c0, 1e-300)


def umeyama(src: np.ndarray, dst: np.ndarray):
    """Similarity (s, R, t) minimising |dst - (s R src + t)|^2 (Umeyama 1991)."""
    src, dst = np.asarray(src, np.float64), np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(dc.T @ sc / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / max((sc ** 2).sum() / len(src), 1e-300)
    return s, R, mu_d - s * R @ mu_s


def centres(poses: np.ndarray) -> np.ndarray:
    poses = np.asarray(poses, np.float64)
    return -np.einsum("vji,vj->vi", poses[:, :, :3], poses[:, :, 3])


def ate(est_poses: np.ndarray, gt_poses: np.ndarray):
    """(ATE RMSE of camera centres after similarity alignment, spread of the
    ground-truth centres as the norm of their bounding box's diagonal)."""
    e, g = centres(est_poses), centres(gt_poses)
    spread = float(np.linalg.norm(g.max(0) - g.min(0)))
    if len(e) < 3:
        return float("inf"), spread
    s, R, t = umeyama(e, g)
    return float(np.sqrt(np.mean(np.sum((g - (s * e @ R.T + t)) ** 2, axis=1)))), spread
