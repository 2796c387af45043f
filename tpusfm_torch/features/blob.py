"""Multi-scale determinant-of-Hessian blob detector + float descriptors.

Counterpart of ``tpusfm/features/blob.py`` (the legacy GPU SURF path,
GPUSURFFeatureMatcher.cpp:56-124): each scale's Hessian is three separable
Gaussian-derivative convolutions over all views at once, keypoints are
thresholded, 3x3 non-max suppressed, ranked per scale and refined to
sub-pixel, oriented by the weighted mean gradient in a 6-sigma disc, and
described by SURF's 4x4-subregion gradient statistics (64 floats,
L2-normalised), matched with ``metric="l2"``.

The views are the batch axis (the reference vmaps one view). The convolution
taps are built in float64 and cast to float32, as the reference does, and
are cross-correlated (``F.conv2d``, zero padding), as
``conv_general_dilated(..., "SAME")`` does. The 4x4 subregion sums are a
reshape of the 20x20 samples to (4, 5, 4, 5) and a sum: a fixed order, where
an ``index_add_`` would add in the order of its atomics.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from tpusfm_torch.features.detect import (
    _DIFF3,
    _SMOOTH3,
    _bilinear,
    _border_mask,
    _conv1d_taps,
    _nms3,
    _subpixel_offsets,
    _topk_stable,
)
from tpusfm_torch.types import Features


@functools.lru_cache(maxsize=None)
def _gauss_derivative_kernels(sigma: float):
    """1-D Gaussian g and its first and second derivatives at scale sigma
    (float32 numpy taps, built in float64)."""
    radius = max(int(round(3.0 * sigma)), 2)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    g1 = -(x / sigma ** 2) * g                      # d/dx g
    g2 = ((x ** 2 - sigma ** 2) / sigma ** 4) * g   # d2/dx2 g
    return g.astype(np.float32), g1.astype(np.float32), g2.astype(np.float32)


def _conv_sep_kernels(img: torch.Tensor, ky: np.ndarray, kx: np.ndarray) -> torch.Tensor:
    """Separable cross-correlation of (V, H, W): ky down the rows, then kx
    along the columns, zero SAME padding."""
    ry, rx = len(ky) // 2, len(kx) // 2
    wy = torch.as_tensor(ky, device=img.device).view(1, 1, -1, 1)
    wx = torch.as_tensor(kx, device=img.device).view(1, 1, 1, -1)
    x = F.conv2d(img[:, None], wy, padding=(ry, 0))
    return F.conv2d(x, wx, padding=(0, rx))[:, 0]


def hessian_response(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Scale-normalised determinant-of-Hessian of (V, H, W) at one scale:
    sigma^4 (Lxx Lyy - (0.9 Lxy)^2), SURF's relative weight 0.9."""
    g, g1, g2 = _gauss_derivative_kernels(sigma)
    lxx = _conv_sep_kernels(img, g, g2)
    lyy = _conv_sep_kernels(img, g2, g)
    lxy = _conv_sep_kernels(img, g1, g1)
    return sigma ** 4 * (lxx * lyy - (0.9 * lxy) ** 2)


# SURF descriptor geometry: 4x4 subregions x 5x5 samples, sample spacing
# = sigma, subregion Gaussian weight sigma_w = 3.3 sigma (SURF paper §4.2).
_DESC_GRID = 4
_DESC_SAMPLES = 5


@functools.lru_cache(maxsize=None)
def _descriptor_offsets():
    """Sample offsets (S,) x and y in units of sigma, subregion id (S,) and
    Gaussian weights (S,), samples in row-major order over the 20x20 grid."""
    n = _DESC_GRID * _DESC_SAMPLES
    coords = np.arange(n) - (n - 1) / 2.0
    oy, ox = np.meshgrid(coords, coords, indexing="ij")
    sub = np.arange(n) // _DESC_SAMPLES
    sy, sx = np.meshgrid(sub, sub, indexing="ij")
    region = (sy * _DESC_GRID + sx).astype(np.int32)
    w = np.exp(-(ox ** 2 + oy ** 2) / (2.0 * 3.3 ** 2))
    return (ox.ravel().astype(np.float32), oy.ravel().astype(np.float32),
            region.ravel(), w.ravel().astype(np.float32))


def _region_sums(v: torch.Tensor) -> torch.Tensor:
    """(V, K, 400) samples of the 20x20 grid -> (V, K, 16) sums over the 4x4
    subregions of 5x5 samples, subregion sy * 4 + sx."""
    g, s = _DESC_GRID, _DESC_SAMPLES
    return v.reshape(v.shape[:-1] + (g, s, g, s)).sum((-3, -1)).flatten(-2)


def _surf_descriptors(ix, iy, xs, ys, angles, sigma):
    """(V, K, 64) SURF-style gradient-statistics descriptors from the dense
    gradient maps ix, iy (V, H, W) of the sigma-smoothed images."""
    dev = ix.device
    ox, oy, _, w = (torch.as_tensor(a, device=dev) for a in _descriptor_offsets())
    ox = ox * sigma
    oy = oy * sigma
    c = torch.cos(angles)[..., None]                 # (V, K, 1)
    s = torch.sin(angles)[..., None]
    # rotate the sample offsets into the keypoint frame
    px = xs[..., None] + (c * ox - s * oy)
    py = ys[..., None] + (s * ox + c * oy)
    gx = _bilinear(ix, py, px)                       # (V, K, S)
    gy = _bilinear(iy, py, px)
    # rotate the gradients into the keypoint frame
    dx = (c * gx + s * gy) * w
    dy = (-s * gx + c * gy) * w
    desc = torch.cat([_region_sums(dx), _region_sums(dx.abs()), _region_sums(dy),
                      _region_sums(dy.abs())], -1)
    return desc / torch.sqrt((desc * desc).sum(-1, keepdim=True) + 1e-12)


@functools.lru_cache(maxsize=None)
def _orientation_disc():
    """Offsets (in units of sigma) and Gaussian weights of the 13x13 samples
    of the orientation disc (radius 6, weight sigma 2.5), float32."""
    r = np.arange(-6, 7, dtype=np.float32)
    oy, ox = np.meshgrid(r, r, indexing="ij")
    r2 = ox ** 2 + oy ** 2
    w = (r2 <= np.float32(36.0)).astype(np.float32) * np.exp(-r2 / np.float32(2.0 * 2.5 ** 2))
    return ox.ravel(), oy.ravel(), w.ravel().astype(np.float32)


def _orientation(ix, iy, xs, ys, sigma):
    """Dominant direction (V, K): the Gaussian-weighted mean gradient in a
    6-sigma disc."""
    ox, oy, w = (torch.as_tensor(a, device=ix.device) for a in _orientation_disc())
    px = xs[..., None] + ox * sigma
    py = ys[..., None] + oy * sigma
    gx = (_bilinear(ix, py, px) * w).sum(-1)
    gy = (_bilinear(iy, py, px) * w).sum(-1)
    return torch.atan2(gy, gx)


def _scale_pipeline(imgs, *, sigma, per_scale, margin, threshold):
    """Detect + orient + describe one scale for all views (V, H, W) ->
    (score, x, y, angle, desc), per_scale entries per view."""
    _, h, w = imgs.shape
    resp = hessian_response(imgs, sigma)
    masked = _nms3(torch.where(resp > threshold, resp, -math.inf))
    masked = torch.where(_border_mask(h, w, margin, imgs.device), masked, -math.inf)
    score, idx = _topk_stable(masked.reshape(masked.shape[0], -1), per_scale)
    yi, xi = idx // w, idx % w
    dy, dx = _subpixel_offsets(resp, yi, xi)
    ysf = yi.to(torch.float32) + dy
    xsf = xi.to(torch.float32) + dx
    g, _, _ = _gauss_derivative_kernels(sigma)
    smooth = _conv_sep_kernels(imgs, g, g)
    ix = _conv1d_taps(_conv1d_taps(smooth, _SMOOTH3, 0), _DIFF3, 1)
    iy = _conv1d_taps(_conv1d_taps(smooth, _SMOOTH3, 1), _DIFF3, 0)
    ang = _orientation(ix, iy, xsf, ysf, sigma)
    return score, xsf, ysf, ang, _surf_descriptors(ix, iy, xsf, ysf, ang, sigma)


def extract_blob_features(images: torch.Tensor, *, max_features: int = 2048,
                          scales: tuple = (1.6, 2.26, 3.2, 4.53), threshold: float = 1e-7,
                          margin: int = 24) -> Features:
    """Batched DoH blob detection over (V, H, W) images in [0, 1] -> Features
    (V, F) with 64-float descriptors: every scale's candidates compete in
    one top-k per view."""
    images = images.to(torch.float32)
    v = images.shape[0]
    per_scale = max(max_features // len(scales), 256)
    parts = [_scale_pipeline(images, sigma=float(s), per_scale=per_scale, margin=margin,
                             threshold=float(threshold)) for s in scales]
    score, x, y, ang, desc = (torch.cat([p[k] for p in parts], 1) for k in range(5))
    top_score, top_idx = _topk_stable(score, max_features)
    valid = torch.isfinite(top_score)
    pick = lambda t: t.gather(1, top_idx)
    xy = torch.stack([pick(x), pick(y)], -1)
    d = desc.gather(1, top_idx[..., None].expand(v, top_idx.shape[1], desc.shape[-1]))
    return Features(
        xy=torch.where(valid[..., None], xy, 0.0),
        desc=torch.where(valid[..., None], d, 0.0),
        score=torch.where(valid, top_score, 0.0),
        angle=pick(ang),
        valid=valid,
    )
