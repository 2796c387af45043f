"""Batched camera / SE(3) math: Rodrigues, projection, composition.

Counterpart of ``tpusfm/camera.py``. Every function takes arbitrary
leading batch dimensions (``...``) where the JAX version is written for
one instance and vmapped; float32 throughout.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-12


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]x."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def rodrigues_to_matrix(rvec: torch.Tensor) -> torch.Tensor:
    """Angle-axis (..., 3) -> rotation matrix (..., 3, 3). Safe at theta=0."""
    theta2 = (rvec * rvec).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)[..., None, None]
    Kx = skew(rvec / torch.sqrt(theta2 + _EPS)[..., None])
    R = _eye3(rvec) + torch.sin(theta) * Kx + (1.0 - torch.cos(theta)) * (Kx @ Kx)
    Rsmall = _eye3(rvec) + skew(rvec)
    return torch.where((theta2 < 1e-16)[..., None, None], Rsmall, R)


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (w, x, y, z), branchless
    Shepperd selection of the best-conditioned candidate."""
    m = lambda i, j: R[..., i, j]
    tr = m(0, 0) + m(1, 1) + m(2, 2)
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m(0, 0) - m(1, 1) - m(2, 2), min=0.0)
    qy2 = torch.clamp(1.0 - m(0, 0) + m(1, 1) - m(2, 2), min=0.0)
    qz2 = torch.clamp(1.0 - m(0, 0) - m(1, 1) + m(2, 2), min=0.0)
    cand = torch.stack([
        torch.stack([qw2, m(2, 1) - m(1, 2), m(0, 2) - m(2, 0), m(1, 0) - m(0, 1)], -1),
        torch.stack([m(2, 1) - m(1, 2), qx2, m(0, 1) + m(1, 0), m(0, 2) + m(2, 0)], -1),
        torch.stack([m(0, 2) - m(2, 0), m(0, 1) + m(1, 0), qy2, m(1, 2) + m(2, 1)], -1),
        torch.stack([m(1, 0) - m(0, 1), m(0, 2) + m(2, 0), m(1, 2) + m(2, 1), qz2], -1),
    ], -2)                                                   # (..., 4, 4)
    pick = torch.stack([qw2, qx2, qy2, qz2], -1).argmax(-1)  # first max
    q = torch.gather(cand, -2, pick[..., None, None].expand(*pick.shape, 1, 4))[..., 0, :]
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def matrix_to_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> angle-axis (..., 3), robust near 0 and pi."""
    q = matrix_to_quaternion(R)
    w, v = q[..., 0], q[..., 1:]
    vnorm = torch.linalg.vector_norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vnorm, w)
    scale = torch.where(vnorm < 1e-9, 2.0 / torch.clamp(w, min=_EPS),
                        theta / torch.clamp(vnorm, min=_EPS))
    return v * scale[..., None]


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential (..., 3) -> (..., 3, 3), derivative-safe at 0."""
    th2 = (w * w).sum(-1)
    safe = th2 > 1e-12
    one = torch.ones_like(th2)
    th = torch.sqrt(torch.where(safe, th2, one))
    A = torch.where(safe, torch.sin(th) / th, 1.0 - th2 / 6.0)
    B = torch.where(safe, (1.0 - torch.cos(th)) / torch.where(safe, th2, one),
                    0.5 - th2 / 24.0)
    Wx = skew(w)
    return _eye3(w) + A[..., None, None] * Wx + B[..., None, None] * (Wx @ Wx)


def rotate_angle_axis(rvec: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate points p (..., 3) by angle-axis rvec (..., 3) (broadcast),
    ceres::AngleAxisRotatePoint semantics."""
    theta2 = (rvec * rvec).sum(-1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS)
    w = rvec / theta
    c, s = torch.cos(theta), torch.sin(theta)
    w, p_b = torch.broadcast_tensors(w, p)
    wxp = torch.linalg.cross(w, p_b)
    wdp = (w * p_b).sum(-1, keepdim=True)
    big = c * p_b + s * wxp + (1.0 - c) * wdp * w
    r_b, _ = torch.broadcast_tensors(rvec, p)
    small = p_b + torch.linalg.cross(r_b, p_b)
    return torch.where(theta2 < 1e-16, small, big)


def euler_to_matrix(rx: float, ry: float, rz: float) -> torch.Tensor:
    """XYZ Euler angles (radians) -> R = Rz @ Ry @ Rx (3, 3) float32
    (the reference test fixture's convention, SfMUnitTests.cpp:80-95)."""
    cx, sx = math.cos(rx), math.sin(rx)
    cy, sy = math.cos(ry), math.sin(ry)
    cz, sz = math.cos(rz), math.sin(rz)
    Rx = torch.tensor([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], dtype=torch.float32)
    Ry = torch.tensor([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=torch.float32)
    Rz = torch.tensor([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype=torch.float32)
    return Rz @ Ry @ Rx


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 3, 4) [R|t]."""
    return torch.cat([R, t[..., None]], -1)


def pose_R(Rt: torch.Tensor) -> torch.Tensor:
    return Rt[..., :3, :3]


def pose_t(Rt: torch.Tensor) -> torch.Tensor:
    return Rt[..., :3, 3]


def camera_center(Rt: torch.Tensor) -> torch.Tensor:
    """World-space camera center c = -R^T t, (..., 3)."""
    return -torch.einsum("...ji,...j->...i", pose_R(Rt), pose_t(Rt))


def transform_points(Rt: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """World -> camera. Rt (..., 3, 4), pts (..., N, 3) -> (..., N, 3)."""
    return pts @ pose_R(Rt).transpose(-1, -2) + pose_t(Rt)[..., None, :]


def project_points(Rt: torch.Tensor, K: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Project world points (..., N, 3) to pixels (..., N, 2), zero distortion."""
    pc = transform_points(Rt, pts)
    z = pc[..., 2:3]
    xy = pc[..., :2] / torch.where(z.abs() < _EPS, _EPS, z)
    f = torch.stack([K[..., 0, 0], K[..., 1, 1]], -1)[..., None, :]
    return xy * f + K[..., None, :2, 2]


def project_points_h(P: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Project with a full 3x4 projection matrix P (already includes K):
    P (..., 3, 4), pts (..., N, 3) -> (..., N, 2)."""
    ph = pts @ P[..., :3].transpose(-1, -2) + P[..., None, :, 3]
    z = ph[..., 2:3]
    return ph[..., :2] / torch.where(z.abs() < _EPS, _EPS, z)


def normalize_points(Kinv: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Pixel coords (..., N, 2) -> normalized camera coords via K^-1."""
    xyh = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    n = xyh @ Kinv.transpose(-1, -2)
    return n[..., :2] / n[..., 2:3]


def distort_normalized(dist: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """5-coefficient Brown model (k1 k2 p1 p2 k3) on normalized coords (..., N, 2)."""
    k1, k2, p1, p2, k3 = (dist[..., i, None] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


def undistort_points(K: torch.Tensor, Kinv: torch.Tensor, dist: torch.Tensor,
                     uv: torch.Tensor, iterations: int = 8) -> torch.Tensor:
    """Undistort pixel coords (..., N, 2) -> ideal pixel coords (fixed-point
    iteration of the inverse Brown model, then back through K)."""
    xyn = normalize_points(Kinv, uv)
    x = xyn
    for _ in range(iterations):
        x = x - (distort_normalized(dist, x) - xyn)
    f = torch.stack([K[..., 0, 0], K[..., 1, 1]], -1)[..., None, :]
    return x * f + K[..., None, :2, 2]


def relative_pose(Rt_a: torch.Tensor, Rt_b: torch.Tensor) -> torch.Tensor:
    """Pose of camera b relative to camera a: x_b = R_rel x_a + t_rel."""
    Ra, ta = pose_R(Rt_a), pose_t(Rt_a)
    Rb, tb = pose_R(Rt_b), pose_t(Rt_b)
    Rrel = Rb @ Ra.transpose(-1, -2)
    trel = tb - (Rrel @ ta[..., None])[..., 0]
    return make_pose(Rrel, trel)


# tpusfm's vmapped names; the functions above already take leading batch
# dimensions. project_points_b maps over the poses only: Rt (B, 3, 4), one K
# and one point set (N, 3) -> (B, N, 2).
rodrigues_to_matrix_b = rodrigues_to_matrix
matrix_to_rodrigues_b = matrix_to_rodrigues
project_points_b = project_points
