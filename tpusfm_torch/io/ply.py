"""PLY / PCD export of the reconstruction.

Equivalent of SfM::saveCloudAndCamerasToPLY (SfMToyLib/SfM.cpp:631-711):
one PLY with RGB vertices for the point cloud, one PLY with 4-vertex
camera frusta plus three colored axis edges per camera; plus the legacy
PCD export (legacy/Visualization.cpp:360-365).
"""
from __future__ import annotations

import numpy as np


def save_point_cloud_ply(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None):
    """Write (N,3) points (+(N,3) uint8/float colors) as ASCII PLY."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    if rgb is None:
        rgb = np.full((n, 3), 255, np.uint8)
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb * 255.0 if rgb.max() <= 1.0 + 1e-6 else rgb, 0, 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(xyz, rgb):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")


def save_cameras_ply(path: str, poses_Rt: np.ndarray, valid: np.ndarray, scale: float = 1.0):
    """Camera frusta as PLY edges: apex + 4 image-plane corners per camera,
    with colored axis edges — mirroring the reference's cameras PLY
    (SfM.cpp:668-710)."""
    poses_Rt = np.asarray(poses_Rt, np.float32)
    valid = np.asarray(valid, bool)
    verts, edges, colors = [], [], []
    s = 0.4 * scale
    local = np.array(
        [
            [0.0, 0.0, 0.0],       # apex (camera center)
            [-s, -s, 2 * s],
            [s, -s, 2 * s],
            [s, s, 2 * s],
            [-s, s, 2 * s],
        ],
        np.float32,
    )
    edge_idx = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    edge_col = [(255, 0, 0), (0, 255, 0), (0, 0, 255)] + [(255, 255, 255)] * 5
    for Rt in poses_Rt[valid]:
        R, t = Rt[:, :3], Rt[:, 3]
        c = -R.T @ t
        world = (local @ R) + c  # R^T applied to local dirs + center
        base = len(verts)
        verts.extend(world.tolist())
        for k, (a, b) in enumerate(edge_idx):
            edges.append((base + a, base + b))
            colors.append(edge_col[min(k, len(edge_col) - 1)])
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for (a, b), c in zip(edges, colors):
            f.write(f"{a} {b} {c[0]} {c[1]} {c[2]}\n")


def save_pcd(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None):
    """ASCII PCD export (legacy Visualization.cpp:360-365 capability)."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    has_rgb = rgb is not None
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n")
        if has_rgb:
            f.write("FIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F U\nCOUNT 1 1 1 1\n")
        else:
            f.write("FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n")
        f.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n")
        if has_rgb:
            rgbu = np.asarray(rgb)
            if rgbu.dtype != np.uint8:
                rgbu = np.clip(rgbu * 255.0 if rgbu.max() <= 1.0 + 1e-6 else rgbu, 0, 255).astype(np.uint8)
            packed = (
                rgbu[:, 0].astype(np.uint32) << 16
            ) | (rgbu[:, 1].astype(np.uint32) << 8) | rgbu[:, 2].astype(np.uint32)
            for p, c in zip(xyz, packed):
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c}\n")
        else:
            for p in xyz:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
