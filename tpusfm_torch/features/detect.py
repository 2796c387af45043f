"""Batched keypoint detection + steered-BRIEF description.

Counterpart of ``tpusfm/features/detect.py``: FAST-9 segment test over
the 16-pixel Bresenham circle, Harris ranking, 3x3 non-max suppression,
per-level top-k over a fixed pyramid, then a global top-k per view;
orientation by intensity centroid and steered BRIEF-256 as ±1 vectors.
All views of a level run as one batch (the JAX version vmaps them).

Parity notes:
  * the 1-D filters are the same unrolled shifted multiply-adds in the
    same order, so float32 sums round identically;
  * ``_shift2d`` wraps around like ``jnp.roll`` (borders are masked);
  * every top-k is a stable descending sort, which breaks ties by the
    lowest index as ``lax.top_k`` does (``torch.topk`` does not);
  * the pyramid resize antialiases, as ``jax.image.resize`` does.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from tpusfm_torch.types import Features

_FAST_CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    np.int32,
)  # (dx, dy)
_FAST_ARC = 9
_PATCH_RADIUS = 13.0
_SMOOTH3 = np.array([1.0, 2.0, 1.0], np.float32) / 4.0
_DIFF3 = np.array([-1.0, 0.0, 1.0], np.float32) / 2.0


@functools.lru_cache(maxsize=None)
def _brief_pattern(bits: int, seed: int = 42) -> np.ndarray:
    """BRIEF point pairs ~ N(0, (patch/2)^2) clipped to the patch — the same
    numpy draw (seed 42) as the reference, so descriptors agree bit for bit."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, _PATCH_RADIUS / 2.0, size=(bits, 2, 2))
    return np.clip(pts, -_PATCH_RADIUS, _PATCH_RADIUS).astype(np.float32)


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / np.float32(sigma)) ** 2, dtype=np.float32)
    return (k / k.sum(dtype=np.float32)).astype(np.float32)


def _conv1d_taps(img: torch.Tensor, k, axis: int) -> torch.Tensor:
    """1-D cross-correlation of (..., H, W) along axis 0 (rows) or 1 (cols),
    zero SAME padding, as unrolled shifted multiply-adds."""
    taps = len(k)
    r = (taps - 1) // 2
    h, w = img.shape[-2:]
    if axis == 0:
        xp = F.pad(img, (0, 0, r, taps - 1 - r))
    else:
        xp = F.pad(img, (r, taps - 1 - r))
    out = None
    for i in range(taps):
        sl = xp[..., i:i + h, :] if axis == 0 else xp[..., :, i:i + w]
        term = float(k[i]) * sl
        out = term if out is None else out + term
    return out


def _sep_conv2d(img, k):
    return _conv1d_taps(_conv1d_taps(img, k, 0), k, 1)


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """result[y, x] = img[y + dy, x + dx], wrapping around."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


def fast_harris_maps(img: torch.Tensor, threshold: float, score: str = "harris"):
    """(masked_response, dense_response) maps of (..., H, W) images in [0, 1]:
    the corner score on FAST-9 corners and -inf elsewhere, plus the dense
    unmasked surface (for the sub-pixel fit)."""
    ring = torch.stack([_shift2d(img, int(dy), int(dx)) for dx, dy in _FAST_CIRCLE], -1)
    brighter = ring > (img + threshold)[..., None]
    darker = ring < (img - threshold)[..., None]

    def has_arc(m):
        m2 = torch.cat([m, m[..., :_FAST_ARC - 1]], -1)
        acc = torch.ones_like(m)
        for k in range(_FAST_ARC):
            acc = acc & m2[..., k:k + 16]
        return acc.any(-1)

    is_corner = has_arc(brighter) | has_arc(darker)
    ix = _conv1d_taps(_conv1d_taps(img, _SMOOTH3, 0), _DIFF3, 1)
    iy = _conv1d_taps(_conv1d_taps(img, _SMOOTH3, 1), _DIFF3, 0)
    g = _gaussian_kernel1d(1.5, 3)
    ixx = _sep_conv2d(ix * ix, g)
    iyy = _sep_conv2d(iy * iy, g)
    ixy = _sep_conv2d(ix * iy, g)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    if score == "min_eig":
        resp = 0.5 * tr - torch.sqrt(torch.clamp(0.25 * tr * tr - det, min=0.0))
    else:
        resp = det - 0.04 * tr * tr
    return torch.where(is_corner, resp, -math.inf), resp


def fast_harris_response(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 corner mask scored by Harris response; -inf elsewhere."""
    return fast_harris_maps(img, threshold)[0]


def _nms3(resp: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression (max-pool with -inf padding), (..., H, W)."""
    mx = F.max_pool2d(resp[..., None, :, :], 3, stride=1, padding=1)[..., 0, :, :]
    return torch.where(resp >= mx, resp, -math.inf)


def _border_mask(h: int, w: int, margin: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)


def _topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties broken by the lowest index."""
    val, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _gather2d(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """img (V, h, w) sampled at integer (y, x) of shape (V, ...)."""
    v, h, w = img.shape
    flat = (y * w + x).reshape(v, -1)
    return img.reshape(v, -1).gather(1, flat).reshape(y.shape)


def _bilinear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (V, h, w) at float coords (V, ...), clamped. The
    clamp keeps floor(y) <= h - 2 and floor(x) <= w - 2, so the four corners
    are one flat index and its +1, +w and +w+1 neighbours."""
    v, h, w = img.shape
    y = torch.clamp(y, 0.0, h - 1.001)
    x = torch.clamp(x, 0.0, w - 1.001)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    fy = y - y0
    fx = x - x0
    gy = 1 - fy
    gx = 1 - fx
    i00 = (y0.long() * w + x0.long()).reshape(v, -1)
    flat = img.reshape(v, -1)
    corner = lambda o: flat.gather(1, i00 + o).reshape(y.shape)
    return (corner(0) * gy * gx + corner(1) * gy * fx
            + corner(w) * fy * gx + corner(w + 1) * fy * fx)


def _orientation_maps(img: torch.Tensor, radius: int = 15):
    """Intensity-centroid moment maps m10, m01 as separable ramp x box sums."""
    ramp = np.arange(-radius, radius + 1, dtype=np.float32)
    box = np.ones(2 * radius + 1, np.float32)
    m10 = _conv1d_taps(_conv1d_taps(img, box, 0), ramp, 1)
    m01 = _conv1d_taps(_conv1d_taps(img, ramp, 0), box, 1)
    return m10, m01


def _subpixel_offsets(resp: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Parabolic sub-pixel offsets on the dense response, clamped to ±0.5."""
    _, h, w = resp.shape
    y0 = torch.clamp(ys, 1, h - 2)
    x0 = torch.clamp(xs, 1, w - 2)

    def axis_offset(rm, r0, rp):
        denom = rm - 2.0 * r0 + rp
        off = 0.5 * (rm - rp) / torch.where(denom.abs() < 1e-12, 1e-12, denom)
        ok = (torch.isfinite(off) & torch.isfinite(rm) & torch.isfinite(rp)
              & (denom.abs() > 1e-12))
        return torch.clamp(torch.where(ok, off, 0.0), -0.5, 0.5)

    r0 = _gather2d(resp, y0, x0)
    dx = axis_offset(_gather2d(resp, y0, x0 - 1), r0, _gather2d(resp, y0, x0 + 1))
    dy = axis_offset(_gather2d(resp, y0 - 1, x0), r0, _gather2d(resp, y0 + 1, x0))
    return dy, dx


def _brief_descriptors(img, ys, xs, angles, bits: int, sampling: str = "nearest"):
    """Steered BRIEF: ±1 descriptors (V, K, bits) from the blurred image."""
    pattern = torch.as_tensor(_brief_pattern(bits), device=img.device)
    c = torch.cos(angles)[..., None, None]
    s = torch.sin(angles)[..., None, None]
    px = pattern[:, :, 0]
    py = pattern[:, :, 1]
    rx = c * px - s * py
    ry = s * px + c * py
    sy = ys[..., None, None] + ry
    sx = xs[..., None, None] + rx
    if sampling == "nearest":
        _, h, w = img.shape
        yi = torch.clamp(torch.round(sy).long(), 0, h - 1)
        xi = torch.clamp(torch.round(sx).long(), 0, w - 1)
        vals = _gather2d(img, yi, xi)
    else:
        vals = _bilinear(img, sy, sx)
    return torch.where(vals[..., 0] > vals[..., 1], 1.0, -1.0)


def _level_pipeline(imgs, *, threshold, per_level, margin, desc_bits, blur_sigma,
                    score_kind="harris", sampling="nearest"):
    """Detect + orient + describe one pyramid level for all views (V, h, w).
    Returns (score, x, y, angle, desc) with per_level entries per view, in
    level-local pixel coordinates."""
    _, h, w = imgs.shape
    smooth = _sep_conv2d(imgs, _gaussian_kernel1d(blur_sigma, 4))
    masked, harris = fast_harris_maps(imgs, threshold, score=score_kind)
    resp = torch.where(_border_mask(h, w, margin, imgs.device), _nms3(masked), -math.inf)
    score, idx = _topk_stable(resp.reshape(resp.shape[0], -1), per_level)
    yi, xi = idx // w, idx % w
    dy, dx = _subpixel_offsets(harris, yi, xi)
    lyf = yi.to(torch.float32) + dy
    lxf = xi.to(torch.float32) + dx
    m10, m01 = _orientation_maps(smooth)
    ang = torch.atan2(_gather2d(m01, yi, xi), _gather2d(m10, yi, xi))
    desc = _brief_descriptors(smooth, lyf, lxf, ang, desc_bits, sampling)
    return score, lxf, lyf, ang, desc


def _resize(images: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Antialiased bilinear resize of (V, H, W), as jax.image.resize 'linear'."""
    return F.interpolate(images[:, None], size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True)[:, 0]


def extract_features(
    images: torch.Tensor,
    *,
    max_features: int = 2048,
    desc_bits: int = 256,
    pyramid_levels: int = 4,
    pyramid_scale: float = 1.2,
    fast_threshold: float = 20.0 / 255.0,
    blur_sigma: float = 2.0,
    margin: int = 24,
    score_kind: str = "harris",
    sampling: str = "nearest",
) -> Features:
    """Batched detection over (V, H, W) grayscale images in [0, 1] ->
    Features (V, F): candidates of all levels compete in a global top-k."""
    images = images.to(torch.float32)
    v, h, w = images.shape
    per_level = max(-(-max_features // max(pyramid_levels, 1)), 256)
    scores, xs, ys, angs, descs = [], [], [], [], []
    for lvl in range(pyramid_levels):
        scale = pyramid_scale ** lvl
        if lvl == 0:
            level_imgs = images
        else:
            lh = max(int(round(h / scale)), 2 * margin + 2)
            lw = max(int(round(w / scale)), 2 * margin + 2)
            level_imgs = _resize(images, lh, lw)
        s, lx, ly, a, d = _level_pipeline(
            level_imgs, threshold=float(fast_threshold), per_level=per_level,
            margin=margin, desc_bits=desc_bits, blur_sigma=float(blur_sigma),
            score_kind=score_kind, sampling=sampling)
        scores.append(s)
        xs.append(lx * scale)
        ys.append(ly * scale)
        angs.append(a)
        descs.append(d)

    score, x, y, ang = (torch.cat(t, 1) for t in (scores, xs, ys, angs))
    desc = torch.cat(descs, 1)
    top_score, top_idx = _topk_stable(score, max_features)
    valid = torch.isfinite(top_score)
    pick = lambda t: t.gather(1, top_idx)
    xy = torch.stack([pick(x), pick(y)], -1)
    d = desc.gather(1, top_idx[..., None].expand(v, max_features, desc.shape[-1]))
    return Features(
        xy=torch.where(valid[..., None], xy, 0.0),
        desc=torch.where(valid[..., None], d, 0.0),
        score=torch.where(valid, top_score, 0.0),
        angle=pick(ang),
        valid=valid,
    )


def extract_features_single(img: torch.Tensor, **kwargs) -> Features:
    """Single-image convenience wrapper: img (H, W) -> Features (1, F, ...)."""
    return extract_features(img[None], **kwargs)
