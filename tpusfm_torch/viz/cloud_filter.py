"""Point-cloud post-filters (batched kNN on the device).

Counterpart of ``tpusfm/viz/cloud_filter.py``: the legacy PCL viewer's
keyboard-toggled statistical outlier removal
(legacy/Visualization.cpp:121-153: meanK=50, stddev_mult=1.0) and its
voxel-grid downsampling path (legacy/Visualization.cpp:140-152, leaf 0.1).

PCL's StatisticalOutlierRemoval semantics: for every point compute the
mean distance to its K nearest neighbours; a point is kept iff that
mean is <= mu + stddev_mult * sigma, where mu/sigma are the
mean/stddev of the per-point means over the whole cloud.

The kNN is a dense pairwise-distance problem, computed as
``|x|^2 + |y|^2 - 2 x.y^T`` so the O(N^2 * 3) term is one matmul, tiled
over query rows to bound the distance-matrix working set to ``tile x N``.
"""
from __future__ import annotations

import numpy as np
import torch

from tpusfm_torch.features.match import topk_stable

_TILE = 1024


def _mean_knn_dist(points: torch.Tensor, valid: torch.Tensor, mean_k: int) -> torch.Tensor:
    """Mean distance from each point to its mean_k nearest valid neighbours
    (ties between equidistant neighbours go to the lowest index)."""
    n = points.shape[0]
    pts = points.to(torch.float32)
    sq = (pts * pts).sum(1)
    k = min(mean_k + 1, n)  # +1: each point is its own nearest neighbour
    means = []
    for s in range(0, n, _TILE):
        q, qsq = pts[s: s + _TILE], sq[s: s + _TILE]
        # (tile, N) squared distances via one matmul
        d2 = qsq[:, None] + sq[None, :] - 2.0 * (q @ pts.T)
        d2 = torch.where(valid[None, :], d2, 1e30)
        neg_top, _ = topk_stable(-d2, k)
        d = torch.sqrt(torch.clamp(-neg_top, min=0.0))
        means.append(d.sum(1) / max(k - 1, 1))  # drop self (d=0)
    return torch.where(valid, torch.cat(means), 0.0)


def sor_filter_mask(
    points: np.ndarray,
    valid: np.ndarray | None = None,
    mean_k: int = 50,
    stddev_mult: float = 1.0,
    device="cuda",
) -> np.ndarray:
    """Boolean keep-mask per point (PCL StatisticalOutlierRemoval parity)."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    if valid is None:
        valid = np.ones((n,), bool)
    valid = np.asarray(valid, bool)
    nv = int(valid.sum())
    if nv <= mean_k:
        return valid.copy()
    means = _mean_knn_dist(torch.as_tensor(points).to(device), torch.as_tensor(valid).to(device),
                           int(mean_k)).cpu().numpy()
    m = means[valid]
    mu = float(m.mean())
    sigma = float(m.std(ddof=1)) if nv > 1 else 0.0
    thresh = mu + stddev_mult * sigma
    return valid & (means <= thresh)


def sor_filter(
    points: np.ndarray,
    colors: np.ndarray | None = None,
    mean_k: int = 50,
    stddev_mult: float = 1.0,
    device="cuda",
):
    """Filtered (points[, colors]) — the legacy viewer's 's'-key action."""
    mask = sor_filter_mask(points, None, mean_k, stddev_mult, device=device)
    if colors is None:
        return points[mask]
    return points[mask], np.asarray(colors)[mask]


def voxel_grid_filter(
    points: np.ndarray,
    colors: np.ndarray | None = None,
    leaf_size: float = 0.1,
    device="cuda",
):
    """Voxel-grid downsample: centroid per occupied voxel
    (legacy/Visualization.cpp:140-152's pcl::VoxelGrid path, leaf 0.1).
    Voxels come out in lexicographic order of their integer keys."""
    points = np.asarray(points, np.float64)
    if points.shape[0] == 0:
        return (points, colors) if colors is not None else points
    pts = torch.as_tensor(points).to(device)
    keys = torch.floor(pts / leaf_size).to(torch.int64)
    _, inv, counts = torch.unique(keys, dim=0, return_inverse=True, return_counts=True)

    def centroids(values: torch.Tensor) -> np.ndarray:
        # summed in input order within a voxel on the CPU; on CUDA index_add_
        # adds in no fixed order (float64 sums of a voxel's few points)
        acc = torch.zeros(counts.shape[0], values.shape[1], dtype=torch.float64, device=pts.device)
        return (acc.index_add_(0, inv, values) / counts[:, None]).cpu().numpy()

    cent = centroids(pts).astype(np.float32)
    if colors is None:
        return cent
    colors = np.asarray(colors)
    cc = centroids(torch.as_tensor(colors.astype(np.float64)).to(device))
    return cent, cc.astype(colors.dtype if colors.dtype.kind == "f" else np.float32)
