"""Dense-flow matching strategy (grid flow field + interpolation).

Counterpart of ``tpusfm/features/dense.py`` (the legacy dense strategies of
FeatureMatching.cpp:275-331): the flow field is batched pyramidal LK on a
regular grid, seeded by a global 2D similarity fitted to ratio-test
descriptor matches, then sampled bilinearly at the left keypoints; each
endpoint takes its nearest right keypoint within a radius, one claim per
right keypoint. Every function takes a leading batch axis of pairs.
"""
from __future__ import annotations

import torch

from tpusfm_torch.features.detect import _bilinear
from tpusfm_torch.features.match import match_pair
from tpusfm_torch.features.optical_flow import claim_and_select, sq_distances, track_points
from tpusfm_torch.types import Matches


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median along the last axis as ``jnp.median`` takes it: the mean of the
    two middle values for an even count (``torch.median`` returns the lower
    one), NaN when any entry is NaN."""
    n = x.shape[-1]
    srt = x.sort(-1).values
    med = (srt[..., (n - 1) // 2] + srt[..., n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(-1), torch.nan, med)


def _apply(A: torch.Tensor, t: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """xy @ A^T + t for (B, N, 2) points, (B, 2, 2) A and (B, 2) t."""
    return xy @ A.transpose(-1, -2) + t[..., None, :]


def estimate_similarity_2d(xy1: torch.Tensor, xy2: torch.Tensor, w: torch.Tensor,
                           rounds: int = 3):
    """Weighted 2D similarity xy2 ~ s R xy1 + t from matched points (B, N, 2)
    with weights w (B, N): the closed-form fit (the legacy
    estimateRigidTransform seeding, FeatureMatching.cpp:229-259), then
    ``rounds`` of inlier reweighting (residual <= 3 x median + 1).

    Returns (A (B, 2, 2), t (B, 2), ok (B,)) with A = s R. As in the
    reference, one zero weight makes the median NaN, so the rounds keep
    every weighted point."""
    w_f = w.to(xy1.dtype)

    def fit(wgt):
        sw = torch.clamp(wgt.sum(-1), min=1e-9)[..., None]
        mu1 = (xy1 * wgt[..., None]).sum(-2) / sw
        mu2 = (xy2 * wgt[..., None]).sum(-2) / sw
        c1 = xy1 - mu1[..., None, :]
        c2 = xy2 - mu2[..., None, :]
        # complex-number form: (a + ib) = sum w z2 conj(z1) / sum w |z1|^2
        num_re = (wgt * (c2[..., 0] * c1[..., 0] + c2[..., 1] * c1[..., 1])).sum(-1)
        num_im = (wgt * (c2[..., 1] * c1[..., 0] - c2[..., 0] * c1[..., 1])).sum(-1)
        den = torch.clamp((wgt * (c1 * c1).sum(-1)).sum(-1), min=1e-9)
        a = num_re / den
        b = num_im / den
        A = torch.stack([torch.stack([a, -b], -1), torch.stack([b, a], -1)], -2)
        return A, mu2 - (mu1[..., None, :] @ A.transpose(-1, -2))[..., 0, :]

    wgt = w_f
    A, t = fit(wgt)
    for _ in range(rounds):
        r = torch.linalg.vector_norm(_apply(A, t, xy1) - xy2, dim=-1)
        med = torch.nan_to_num(_median(torch.where(w > 0, r, torch.nan)), nan=1e9)
        wgt = w_f * (r <= 3.0 * med[..., None] + 1.0)
        A, t = fit(wgt)
    ok = ((wgt.sum(-1) >= 6) & torch.isfinite(A).flatten(-2).all(-1)
          & torch.isfinite(t).all(-1))
    return A, t, ok


def _grid(h: int, w: int, stride: int, device):
    gy = torch.arange(stride // 2, h - stride // 2, stride, dtype=torch.float32, device=device)
    gx = torch.arange(stride // 2, w - stride // 2, stride, dtype=torch.float32, device=device)
    return gy, gx


def dense_flow_field(img1: torch.Tensor, img2: torch.Tensor, stride: int = 8,
                     levels: int = 4, iters: int = 20, seed_A: torch.Tensor | None = None,
                     seed_t: torch.Tensor | None = None):
    """Flow field on a regular grid for images (B, H, W). Returns (grid_y,
    grid_x, flow (B, Gy, Gx, 2), err (B, Gy, Gx)). seed_A (B, 2, 2) and
    seed_t (B, 2) start every node at the similarity's prediction."""
    b, h, w = img1.shape
    gy, gx = _grid(h, w, stride, img1.device)
    yy, xx = torch.meshgrid(gy, gx, indexing="ij")
    pts = torch.stack([xx.reshape(-1), yy.reshape(-1)], 1).expand(b, -1, -1)   # (B, G, 2)
    init = None if seed_A is None else _apply(seed_A, seed_t, pts) - pts
    endpoints, err = track_points(img1, img2, pts, levels=levels, iters=iters,
                                  init_flow=init)
    grid = (b, len(gy), len(gx))
    return gy, gx, (endpoints - pts).reshape(grid + (2,)), err.reshape(grid)


def _sample_field(gy, gx, field, x, y):
    """Bilinear sample of a grid-sampled field (B, Gy, Gx) at continuous
    image coordinates (B, K)."""
    return _bilinear(field, (y - gy[0]) / (gy[1] - gy[0]), (x - gx[0]) / (gx[1] - gx[0]))


def match_pair_dense(img1, img2, feats1_xy, feats1_valid, feats2_xy, feats2_valid, *,
                     stride: int = 8, max_error: float = 25.0, assoc_radius: float = 3.0,
                     max_matches: int = 1024, seed_with_features: bool = True,
                     feats1_desc=None, feats2_desc=None) -> Matches:
    """Dense-strategy matching of view pairs -> fixed-capacity Matches (B, M).

    With seed_with_features and descriptors, a 2D similarity fitted to the
    ratio-test descriptor matches (plain ``match_pair``, ratio 0.8, 256
    matches) seeds the flow: the legacy estimateRigidTransform pass that
    makes large-baseline pairs usable."""
    seed_A = seed_t = None
    if seed_with_features and feats1_desc is not None and feats2_desc is not None:
        m = match_pair(feats1_desc, feats1_valid, feats2_desc, feats2_valid,
                       ratio=0.8, max_matches=256)
        li = torch.clamp(m.idx[..., 0], min=0).long()[..., None].expand(-1, -1, 2)
        ri = torch.clamp(m.idx[..., 1], min=0).long()[..., None].expand(-1, -1, 2)
        A, t, ok = estimate_similarity_2d(feats1_xy.gather(-2, li), feats2_xy.gather(-2, ri),
                                          m.valid)
        eye = torch.eye(2, dtype=torch.float32, device=A.device)
        seed_A = torch.where(ok[:, None, None], A, eye)
        seed_t = torch.where(ok[:, None], t, 0.0)
    gy, gx, flow, err = dense_flow_field(img1, img2, stride=stride, seed_A=seed_A,
                                         seed_t=seed_t)
    fx1, fy1 = feats1_xy[..., 0], feats1_xy[..., 1]
    u = _sample_field(gy, gx, flow[..., 0], fx1, fy1)
    v = _sample_field(gy, gx, flow[..., 1], fx1, fy1)
    e = _sample_field(gy, gx, err, fx1, fy1)
    endpoints = feats1_xy + torch.stack([u, v], -1)
    tracked = feats1_valid & (e <= max_error)
    best2, right = sq_distances(endpoints, feats2_xy, feats2_valid).min(-1)
    best = torch.sqrt(best2)
    return claim_and_select(tracked & (best <= assoc_radius), best, right,
                            feats2_xy.shape[-2], max_matches)
