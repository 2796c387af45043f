"""Plain keypoint detection and steered BRIEF, in any floating dtype.

The benchmark's own statement of what the port's detector computes
(FAST-9 on the 16-pixel circle, Harris score, 3x3 non-max suppression,
a per-level top-k over an antialiased pyramid, a global top-k per view,
parabolic sub-pixel offsets, intensity-centroid orientation and steered
BRIEF-256 with nearest sampling from a Gaussian-blurred image), written
without the port's code so that the port's features are judged against
an independent computation. The reference runs it in float64; the control
runs it in bfloat16 (the pyramid resize, which has no bfloat16 kernel on
every device, in float32 rounded to bfloat16). The segment test compares
the images' float32 values as the port states them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_CIRCLE = [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
           (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)]  # (dx, dy)
_ARC = 9
_PATCH = 13.0


def brief_pattern(bits: int) -> np.ndarray:
    """BRIEF point pairs ~ N(0, (patch/2)^2) clipped to the patch, drawn from
    ``default_rng(42)`` (the reference library's fixed pattern): (bits, 2, 2)."""
    pts = np.random.default_rng(42).normal(0.0, _PATCH / 2.0, size=(bits, 2, 2))
    return np.clip(pts, -_PATCH, _PATCH).astype(np.float32)


def _gauss(sigma: float, radius: int):
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _corr1d(img, k, axis: int):
    """Zero-padded 1-D cross-correlation along rows (axis 0) or columns (1)."""
    r = (len(k) - 1) // 2
    h, w = img.shape[-2:]
    xp = F.pad(img, (0, 0, r, len(k) - 1 - r) if axis == 0 else (r, len(k) - 1 - r))
    out = None
    for i, ki in enumerate(k):
        sl = xp[..., i:i + h, :] if axis == 0 else xp[..., :, i:i + w]
        out = float(ki) * sl if out is None else out + float(ki) * sl
    return out


def _sep(img, k):
    return _corr1d(_corr1d(img, k, 0), k, 1)


def _gather(img, y, x):
    v, h, w = img.shape
    return img.reshape(v, -1).gather(1, (y * w + x).reshape(v, -1)).reshape(y.shape)


def _top(x, k):
    val, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _level(img, threshold, per_level, margin, bits, sigma, fast_dtype):
    v, h, w = img.shape
    dt, dev = img.dtype, img.device
    smooth = _sep(img, _gauss(sigma, 4))
    low = img.to(fast_dtype)
    ring = torch.stack([torch.roll(low, shifts=(-dy, -dx), dims=(-2, -1)) for dx, dy in _CIRCLE],
                       -1)

    def arc(m):
        m2 = torch.cat([m, m[..., :_ARC - 1]], -1)
        acc = torch.ones_like(m)
        for k in range(_ARC):
            acc = acc & m2[..., k:k + 16]
        return acc.any(-1)

    corner = arc(ring > (low + threshold)[..., None]) | arc(ring < (low - threshold)[..., None])
    ix = _corr1d(_corr1d(img, [0.25, 0.5, 0.25], 0), [-0.5, 0.0, 0.5], 1)
    iy = _corr1d(_corr1d(img, [0.25, 0.5, 0.25], 1), [-0.5, 0.0, 0.5], 0)
    g = _gauss(1.5, 3)
    ixx, iyy, ixy = _sep(ix * ix, g), _sep(iy * iy, g), _sep(ix * iy, g)
    harris = ixx * iyy - ixy * ixy - 0.04 * (ixx + iyy) ** 2
    masked = torch.where(corner, harris, -math.inf)
    peak = F.max_pool2d(masked[:, None], 3, stride=1, padding=1)[:, 0]
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inside = (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)
    resp = torch.where(inside & (masked >= peak), masked, -math.inf)
    score, idx = _top(resp.reshape(v, -1), per_level)
    yi, xi = idx // w, idx % w

    def offset(rm, r0, rp):
        den = rm - 2.0 * r0 + rp
        off = 0.5 * (rm - rp) / torch.where(den.abs() < 1e-12, 1e-12, den)
        ok = torch.isfinite(off) & torch.isfinite(rm) & torch.isfinite(rp) & (den.abs() > 1e-12)
        return torch.clamp(torch.where(ok, off, 0.0), -0.5, 0.5)

    y0, x0 = torch.clamp(yi, 1, h - 2), torch.clamp(xi, 1, w - 2)
    r0 = _gather(harris, y0, x0)
    fx = xi.to(dt) + offset(_gather(harris, y0, x0 - 1), r0, _gather(harris, y0, x0 + 1))
    fy = yi.to(dt) + offset(_gather(harris, y0 - 1, x0), r0, _gather(harris, y0 + 1, x0))
    ramp = np.arange(-15, 16, dtype=np.float64)
    box = np.ones(31)
    m10 = _corr1d(_corr1d(smooth, box, 0), ramp, 1)
    m01 = _corr1d(_corr1d(smooth, ramp, 0), box, 1)
    ang = torch.atan2(_gather(m01, yi, xi), _gather(m10, yi, xi))
    pat = torch.as_tensor(brief_pattern(bits), device=dev).to(dt)
    c, s = torch.cos(ang)[..., None, None], torch.sin(ang)[..., None, None]
    px, py = pat[:, :, 0], pat[:, :, 1]
    sy = torch.clamp(torch.round(fy[..., None, None] + s * px + c * py).long(), 0, h - 1)
    sx = torch.clamp(torch.round(fx[..., None, None] + c * px - s * py).long(), 0, w - 1)
    vals = _gather(smooth, sy, sx)
    desc = torch.where(vals[..., 0] > vals[..., 1], 1.0, -1.0).to(dt)
    return score, fx, fy, desc


def detect(images: torch.Tensor, *, max_features: int, bits: int = 256, levels: int = 4,
           scale: float = 1.2, fast_threshold: float = 20.0 / 255.0, sigma: float = 2.0,
           margin: int = 24, dtype=torch.float64):
    """(V, H, W) images in [0, 1] -> (xy (V, F, 2), desc (V, F, bits) ±1, valid (V, F)),
    computed in ``dtype`` (returned as float64). The segment test compares
    in float32 when ``dtype`` is wider (the configuration states float32
    images: a circle pixel exactly at the threshold, common on 8-bit
    levels, is decided by float32 rounding) and in ``dtype`` otherwise."""
    fast_dtype = torch.float32 if torch.finfo(dtype).bits > 32 else dtype
    images = images.to(dtype)
    v, h, w = images.shape
    per_level = max(-(-max_features // max(levels, 1)), 256)
    parts = []
    for lvl in range(levels):
        sc = scale ** lvl
        img = images
        if lvl:
            lh = max(int(round(h / sc)), 2 * margin + 2)
            lw = max(int(round(w / sc)), 2 * margin + 2)
            resize_dt = torch.float64 if dtype == torch.float64 else torch.float32
            img = F.interpolate(images.to(resize_dt)[:, None], size=(lh, lw), mode="bilinear",
                                align_corners=False, antialias=True)[:, 0].to(dtype)
        s, fx, fy, d = _level(img, fast_threshold, per_level, margin, bits, sigma, fast_dtype)
        parts.append((s, fx * sc, fy * sc, d))
    score = torch.cat([p[0] for p in parts], 1)
    x = torch.cat([p[1] for p in parts], 1)
    y = torch.cat([p[2] for p in parts], 1)
    desc = torch.cat([p[3] for p in parts], 1)
    top, idx = _top(score, max_features)
    valid = torch.isfinite(top)
    xy = torch.stack([x.gather(1, idx), y.gather(1, idx)], -1).to(torch.float64)
    d = desc.gather(1, idx[..., None].expand(v, max_features, bits)).to(torch.float64)
    return xy, d, valid
