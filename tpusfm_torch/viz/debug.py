"""Overlay renderers for visual debugging (PIL, host-side).

The port's own copy of ``tpusfm/viz/debug.py``.

Replaces the reference's imshow-based visual debug channel
(SfMCommon.h:181-212 color wheel; SfM.cpp:277-286 match overlays;
legacy DrawKeypoints.cpp keypoint/epipolar dumps) with files on disk —
the right medium for headless hosts.
"""
from __future__ import annotations

import numpy as np

# Debug color wheel, 12 hues (role of SfMCommon.h:181-212)
_WHEEL = [
    (255, 0, 0), (255, 128, 0), (255, 255, 0), (128, 255, 0),
    (0, 255, 0), (0, 255, 128), (0, 255, 255), (0, 128, 255),
    (0, 0, 255), (128, 0, 255), (255, 0, 255), (255, 0, 128),
]


def _to_rgb(img: np.ndarray) -> "object":
    from PIL import Image

    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.0 + 1e-6 else arr, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return Image.fromarray(arr)


def draw_keypoints(path: str, img: np.ndarray, xy: np.ndarray,
                   valid: np.ndarray | None = None, radius: int = 3):
    """Write an image with keypoint circles (DrawKeypoints.cpp role)."""
    from PIL import ImageDraw

    im = _to_rgb(img)
    d = ImageDraw.Draw(im)
    xy = np.asarray(xy)
    if valid is not None:
        xy = xy[np.asarray(valid)]
    for k, (x, y) in enumerate(xy):
        c = _WHEEL[k % len(_WHEEL)]
        d.ellipse([x - radius, y - radius, x + radius, y + radius], outline=c)
    im.save(path)


def draw_matches(path: str, img1: np.ndarray, img2: np.ndarray,
                 uv1: np.ndarray, uv2: np.ndarray,
                 valid: np.ndarray | None = None, max_draw: int = 200):
    """Side-by-side match visualization (SfM.cpp:277-286 equivalent)."""
    from PIL import Image, ImageDraw

    a, b = _to_rgb(img1), _to_rgb(img2)
    w = a.width + b.width
    h = max(a.height, b.height)
    canvas = Image.new("RGB", (w, h))
    canvas.paste(a, (0, 0))
    canvas.paste(b, (a.width, 0))
    d = ImageDraw.Draw(canvas)
    uv1 = np.asarray(uv1)
    uv2 = np.asarray(uv2)
    if valid is not None:
        sel = np.asarray(valid)
        uv1, uv2 = uv1[sel], uv2[sel]
    for k in range(min(len(uv1), max_draw)):
        c = _WHEEL[k % len(_WHEEL)]
        x1, y1 = uv1[k]
        x2, y2 = uv2[k]
        d.line([x1, y1, x2 + a.width, y2], fill=c, width=1)
    canvas.save(path)


def draw_reprojections(path: str, img: np.ndarray, observed: np.ndarray,
                       projected: np.ndarray, valid: np.ndarray | None = None):
    """Observed (green) vs reprojected (red) points with error whiskers
    (role of the legacy triangulation debug panel, Triangulation.cpp:235-249)."""
    from PIL import ImageDraw

    im = _to_rgb(img)
    d = ImageDraw.Draw(im)
    observed = np.asarray(observed)
    projected = np.asarray(projected)
    if valid is not None:
        sel = np.asarray(valid)
        observed, projected = observed[sel], projected[sel]
    for (ox, oy), (px, py) in zip(observed, projected):
        d.line([ox, oy, px, py], fill=(255, 255, 0), width=1)
        d.ellipse([ox - 2, oy - 2, ox + 2, oy + 2], outline=(0, 255, 0))
        d.ellipse([px - 2, py - 2, px + 2, py + 2], outline=(255, 0, 0))
    im.save(path)
