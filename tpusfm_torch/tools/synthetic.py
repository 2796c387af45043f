"""Procedurally textured multi-view scene, rendered with numpy from a seed.

The port's own copy of the ray-cast renderer of
``benchmarks/strecha_fixture.py`` (``_render``/``_noise3``): a corner of
three planes (two converging walls and a ground plane) shaded with
aperiodic multi-octave lattice value noise, seen from a converging arc of
cameras. Lattice noise is locally distinctive everywhere, so FAST/BRIEF
features localise to sub-pixel accuracy and match without repeats. It
stands in for the crazyhorse photographs where those are absent, at the
same image size and view count.
"""
from __future__ import annotations

import math

import numpy as np


def _hash3(ix, iy, iz, seed):
    """Integer-lattice hash -> [0, 1) (vectorised, deterministic)."""
    h = (ix * 374761393 + iy * 668265263 + iz * 2147483647 + seed * 144665) & 0x7FFFFFFF
    h = (h ^ (h >> 13)) * 1274126177 & 0x7FFFFFFF
    return ((h ^ (h >> 16)) & 0xFFFFFF) / float(0x1000000)


def _value_noise3(X, scale, seed):
    """Trilinear-interpolated lattice value noise at one octave."""
    P = X * scale
    i = np.floor(P).astype(np.int64)
    f = P - i
    f = f * f * (3.0 - 2.0 * f)
    out = np.zeros(X.shape[:-1])
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                h = _hash3(i[..., 0] + dx, i[..., 1] + dy, i[..., 2] + dz, seed)
                wgt = ((f[..., 0] if dx else 1 - f[..., 0])
                       * (f[..., 1] if dy else 1 - f[..., 1])
                       * (f[..., 2] if dz else 1 - f[..., 2]))
                out += wgt * h
    return out


def _noise3(seed: int, detail: float = 1.0):
    """Multi-octave 3-D value noise; detail > 1 adds finer octaves so a
    larger render keeps pixel-scale texture."""

    def tex(X):
        v = (0.5 * _value_noise3(X, 0.9, seed)
             + 0.28 * _value_noise3(X, 2.3, seed + 1)
             + 0.16 * _value_noise3(X, 5.1, seed + 2)
             + 0.08 * _value_noise3(X, 11.7, seed + 3))
        amp, scale, k = 0.14, 26.0, 4
        while scale < 11.7 * detail:
            v = v + amp * _value_noise3(X, scale, seed + k)
            amp, scale, k = amp * 0.65, scale * 2.2, k + 1
        v = (v - 0.5) * 2.8
        return 0.5 + 0.42 * np.tanh(v)

    return tex


# corner scene: n . X = c  (two walls meeting at x=0 + a ground plane)
_PLANES = [
    (np.array([0.35, 0.0, 1.0]), 16.0),
    (np.array([-0.35, 0.0, 1.0]), 16.0),
    (np.array([0.0, 1.0, -0.12]), 4.0),
]


def _render(Rt, K, h, w, tex):
    """Ray-cast one (h, w) grayscale view in [0, 1] through pinhole K."""
    f = np.array([K[0, 0], K[1, 1]])
    pp = np.array([K[0, 2], K[1, 2]])
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xn = (np.stack([xs, ys], -1).reshape(-1, 2) - pp) / f
    R = Rt[:, :3]
    o = -R.T @ Rt[:, 3]
    d = np.concatenate([xn, np.ones((len(xn), 1))], 1) @ R
    best_t = np.full(len(xn), np.inf)
    for n0, c0 in _PLANES:
        nn = np.linalg.norm(n0)
        n, c = n0 / nn, c0 / nn
        denom = d @ n
        t = (c - o @ n) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        ok = (t > 0.5) & (t < best_t)
        best_t = np.where(ok, t, best_t)
    X = o[None, :] + best_t[:, None] * d
    img = np.where(np.isfinite(best_t), tex(X), 0.05)
    return np.clip(img.reshape(h, w), 0.0, 1.0).astype(np.float32)


def make_scene(n_views: int = 7, h: int = 768, w: int = 1024, focal: float | None = None,
               seed: int = 0):
    """Render the scene: returns (images (V, H, W) float32 in [0, 1],
    ground-truth world->camera poses (V, 3, 4), K (3, 3)).

    The cameras follow a converging arc (lateral and depth motion with an
    inward rotation) so every pair has a well-conditioned two-view
    geometry; the default focal keeps the field of view of the fixture
    (520 px at 512 px width)."""
    focal = 520.0 * w / 512.0 if focal is None else focal
    rng = np.random.default_rng(seed)
    # texture down to ~2.5 px cells at any width, so FAST finds corners;
    # finer octaves alias and cost sub-pixel accuracy
    tex = _noise3(seed + 7, detail=max(2.0 * w / 512.0, 1.0))
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float64)
    poses = []
    for v in range(n_views):
        u = v / max(n_views - 1, 1)
        tx = -2.5 + 5.0 * u
        tz = 1.5 * math.sin(math.pi * u)
        ry = math.radians(-14.0 + 28.0 * u)
        rx = math.radians(float(rng.uniform(-1.0, 1.0)))
        cy, sy = math.cos(ry), math.sin(ry)
        cx, sx = math.cos(rx), math.sin(rx)
        R = (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
             @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))
        t = np.array([tx, rng.uniform(-0.2, 0.2), tz + rng.uniform(-0.2, 0.2)])
        poses.append(np.concatenate([R, t[:, None]], axis=1))
    poses = np.stack(poses)
    images = np.stack([_render(Rt, K, h, w, tex) for Rt in poses])
    return images, poses.astype(np.float32), K.astype(np.float32)
