"""Scanline-disparity matching strategy (plane-sweep cost volume).

Counterpart of ``tpusfm/features/stereo.py`` (the legacy
``STRATEGY_USE_HORIZ_DISPARITY`` path, FeatureMatching.cpp:340-399): a
zero-mean SAD plane sweep builds a (D, H, W) cost volume per pair, the
winner takes all with a uniqueness test and a parabolic sub-pixel fit, and
left-right consistency re-reads the same volume from the right image's
frame, C_R(x', d) = C_L(x' + d, d). Every left keypoint with a valid
disparity maps to (x - d, y) and takes its nearest right keypoint within a
radius, one claim per right keypoint. Every function takes a leading batch
axis of pairs.

Ties: ``argmin`` returns the first index, as ``jnp.argmin`` does (the
volume has runs of ``_BIG`` at col < d). The gathers clamp their indices,
as XLA's do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tpusfm_torch.features.detect import _bilinear
from tpusfm_torch.features.match import _BIG
from tpusfm_torch.features.optical_flow import claim_and_select, sq_distances
from tpusfm_torch.types import Matches


def _box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 mean of (B, H, W) with zero SAME padding, rows then columns."""
    n = 2 * radius + 1
    k = torch.full((1, 1, n, 1), 1.0 / n, dtype=torch.float32, device=img.device)
    x = F.conv2d(img[:, None], k, padding=(radius, 0))
    return F.conv2d(x, k.view(1, 1, 1, n), padding=(0, radius))[:, 0]


def disparity_map(img_l: torch.Tensor, img_r: torch.Tensor, *, max_disparity: int = 64,
                  block_radius: int = 3, uniqueness: float = 0.95,
                  lr_threshold: float = 1.5):
    """Left-image disparity (B, H, W) and its validity mask (B, H, W).

    The StereoSGBM convention, x_right = x_left - d for d in [0, D); the cost
    is the zero-mean SAD over a (2r+1)^2 block."""
    w = img_l.shape[-1]
    zl = img_l - _box_filter(img_l, block_radius)
    zr = img_r - _box_filter(img_r, block_radius)
    col = torch.arange(w, device=img_l.device)
    # right image shifted right by d; columns x < d have no counterpart
    vol = torch.stack([torch.where(col >= d, _box_filter((zl - torch.roll(zr, d, -1)).abs(),
                                                         block_radius), _BIG)
                       for d in range(max_disparity)], 1)                    # (B, D, H, W)

    cmin, best = vol.min(1)
    # uniqueness: the best must beat the runner-up outside +-1 disparity
    dis = torch.arange(max_disparity, device=vol.device)[:, None, None]
    c2 = torch.where((dis - best[:, None]).abs() <= 1, _BIG, vol).min(1).values
    unique = cmin <= uniqueness * c2

    # parabolic sub-pixel fit around the winner
    b = torch.clamp(best, 1, max_disparity - 2)
    cm, c0, cp = (vol.gather(1, (b + k)[:, None])[:, 0] for k in (-1, 0, 1))
    denom = cm - 2.0 * c0 + cp
    off = torch.clamp(0.5 * (cm - cp) / torch.where(denom.abs() < 1e-9, 1e-9, denom), -0.5, 0.5)
    disp = best.to(torch.float32) + torch.where(best == b, off, 0.0)

    # left-right consistency from the same volume: the right image's
    # disparity at x' is argmin_d vol[d, y, x' + d]
    xr = torch.clamp(col + dis, 0, w - 1)                                   # (D, 1, W)
    best_r = vol.gather(3, xr.expand(vol.shape)).argmin(1)                  # right frame
    xr_of_l = torch.clamp(col - best, 0, w - 1)
    lr_ok = (disp - best_r.gather(2, xr_of_l).to(torch.float32)).abs() <= lr_threshold

    valid = unique & lr_ok & (cmin < _BIG) & (best > 0) & (best < max_disparity - 1)
    return disp, valid


def match_pair_disparity(img1, img2, feats1_xy, feats1_valid, feats2_xy, feats2_valid, *,
                         max_disparity: int = 64, assoc_radius: float = 3.0,
                         max_matches: int = 1024) -> Matches:
    """Disparity-strategy matching of view pairs -> fixed-capacity Matches
    (B, M): each left keypoint with a valid disparity maps to (x - d, y) and
    takes the nearest right keypoint (FeatureMatching.cpp:360-399)."""
    disp, dvalid = disparity_map(img1, img2, max_disparity=max_disparity)
    fx, fy = feats1_xy[..., 0], feats1_xy[..., 1]
    d = _bilinear(disp, fy, fx)
    dv = _bilinear(dvalid.to(torch.float32), fy, fx) > 0.5
    endpoints = torch.stack([fx - d, fy], -1)
    best2, right = sq_distances(endpoints, feats2_xy, feats2_valid).min(-1)
    best = torch.sqrt(best2)
    return claim_and_select(feats1_valid & dv & (best <= assoc_radius), best, right,
                            feats2_xy.shape[-2], max_matches)
