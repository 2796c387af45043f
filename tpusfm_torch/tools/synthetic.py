"""Procedurally textured multi-view scene, rendered with numpy from a seed.

The port's own copy of the ray-cast renderer of
``benchmarks/strecha_fixture.py`` (``_render``/``_noise3``): a corner of
three planes (two converging walls and a ground plane) shaded with
aperiodic multi-octave lattice value noise, seen from a converging arc of
cameras. Lattice noise is locally distinctive everywhere, so FAST/BRIEF
features localise to sub-pixel accuracy and match without repeats. It
stands in for the crazyhorse photographs where those are absent, at the
same image size and view count.

``make_collection_scene`` renders the collection-scale fixture: a closed
ring of cameras inside a relief-displaced textured cylinder.
``make_collection`` renders the dot collection of
``benchmarks/collection_fixture.py::make_collection`` (Gaussian dots seen
from an arc), which the multi-rank checks use.
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


def make_collection_scene(n_views: int = 500, h: int = 192, w: int = 256,
                          focal: float = 300.0, orbit_radius: float = 6.0,
                          wall_radius: float = 10.0, relief_amp: float = 1.2,
                          seed: int = 0):
    """Textured orbit collection (the port's own numpy copy of
    ``benchmarks/collection_fixture.py::make_collection_textured``, same
    arguments and defaults): cameras on a ring INSIDE a cylinder of
    band-limited lattice-noise texture, looking outward, plus a textured
    ground plane.

    Every ray hits a surface, every view sees a sector of the wall, and
    consecutive views overlap heavily — the sequential-collection regime,
    with sub-pixel-localisable texture. The ring is always the full circle,
    so fewer views mean a wider step between neighbours.

    relief_amp displaces the wall radially by band-limited noise (a true
    surface, intersected iteratively, not a texture warp): a perfectly
    smooth cylinder is locally planar, which makes every PnP
    quasi-degenerate, and no incremental pipeline can hold scale on it.

    Returns (images (V, H, W) float32, poses (V, 3, 4), K (3, 3))."""
    rng = np.random.default_rng(seed)
    s = seed + 7

    def tex(X):
        # Fine-octave-heavy lattice noise with hard contrast expansion:
        # FAST-9 needs crisp corner-like structure, and these cameras sit
        # 4-10 units from the wall, so the energy must live at fine world
        # scales.
        v = (0.40 * _value_noise3(X, 2.0, s)
             + 0.30 * _value_noise3(X, 4.6, s + 1)
             + 0.20 * _value_noise3(X, 10.4, s + 2)
             + 0.12 * _value_noise3(X, 23.0, s + 3))
        v = (v - 0.51) * 6.0
        return 0.5 + 0.46 * np.tanh(v)

    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)

    poses = []
    for v in range(n_views):
        th = 2.0 * math.pi * v / n_views
        C = np.array([orbit_radius * math.sin(th), rng.uniform(-0.25, 0.25),
                      -orbit_radius * math.cos(th)], np.float64)
        fwd = np.array([math.sin(th), 0.0, -math.cos(th)])   # radially out
        # small per-view pointing jitter (handheld-style)
        fwd = fwd + np.array([rng.uniform(-0.03, 0.03), rng.uniform(-0.02, 0.02),
                              rng.uniform(-0.03, 0.03)])
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])
        t = -R @ C
        poses.append(np.concatenate([R, t[:, None]], axis=1).astype(np.float32))
    poses = np.stack(poses)

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xn = np.stack([(xs - w / 2) / focal, (ys - h / 2) / focal,
                   np.ones_like(xs)], -1).reshape(-1, 3)
    images = np.empty((n_views, h, w), np.float32)
    for v, Rt in enumerate(poses):
        R = Rt[:, :3].astype(np.float64)
        o = -R.T @ Rt[:, 3].astype(np.float64)
        d = xn @ R                                   # rays in world frame
        # cylinder x^2 + z^2 = wall_radius^2 (the camera is inside: the
        # positive root always exists)
        a = d[:, 0] ** 2 + d[:, 2] ** 2
        b = 2.0 * (o[0] * d[:, 0] + o[2] * d[:, 2])

        def cyl_hit(radius):
            c = o[0] ** 2 + o[2] ** 2 - radius ** 2
            disc = np.maximum(b * b - 4 * a * c, 0.0)
            return (-b + np.sqrt(disc)) / np.maximum(2 * a, 1e-12)

        t_wall = cyl_hit(wall_radius)
        if relief_amp > 0.0:
            # displaced surface r(theta, y) = R + amp * noise: fixed-point
            # refinement of the ray/surface intersection (amp << R so 3
            # sweeps land well under a pixel)
            for _ in range(3):
                Xw = o[None, :] + t_wall[:, None] * d
                bump = relief_amp * 2.0 * (_value_noise3(Xw, 0.55, s + 9) - 0.5)
                t_wall = cyl_hit(wall_radius + bump)
        # ground plane y = +3 (y points down in the camera convention)
        t_gnd = np.where(d[:, 1] > 1e-9, (3.0 - o[1]) / d[:, 1], np.inf)
        t_hit = np.minimum(t_wall, t_gnd)
        X = o[None, :] + t_hit[:, None] * d
        images[v] = np.clip(tex(X), 0.0, 1.0).reshape(h, w).astype(np.float32)
    return images, poses, K


_PATCH = 7  # dot splat half-size in pixels (covers 3 sigma of the largest dots)


def _render_dots(Rt, dots, vals, sigmas, h: int, w: int, focal: float) -> np.ndarray:
    """One (h, w) image of Gaussian dots by a scatter-max of their splats."""
    offs = np.arange(-_PATCH, _PATCH + 1, dtype=np.int32)
    dys, dxs = np.meshgrid(offs, offs, indexing="ij")
    pc = dots @ Rt[:, :3].T + Rt[:, 3]
    z = pc[:, 2]
    zs = np.where(np.abs(z) < 1e-6, np.float32(1e-6), z)
    uv = pc[:, :2] / zs[:, None] * np.float32(focal) + np.array([w / 2.0, h / 2.0], np.float32)
    cx = np.round(uv[:, 0]).astype(np.int32)
    cy = np.round(uv[:, 1]).astype(np.int32)
    xs = cx[:, None, None] + dxs[None]
    ys = cy[:, None, None] + dys[None]
    # float32 as in the reference (numpy would promote int32 - float32 to float64)
    d2 = ((xs.astype(np.float32) - uv[:, 0, None, None]) ** 2
          + (ys.astype(np.float32) - uv[:, 1, None, None]) ** 2)
    val = vals[:, None, None] * np.exp(-d2 / (2.0 * sigmas[:, None, None] ** 2))
    ok = (z > 0.1)[:, None, None] & (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img = np.zeros(h * w + 1, np.float32)
    np.maximum.at(img, np.where(ok, ys * w + xs, h * w).ravel(),
                  np.where(ok, val, 0.0).astype(np.float32).ravel())
    return np.clip(img[:h * w].reshape(h, w), 0.0, 1.0)


def make_collection(n_views: int = 500, n_dots: int = 1500, h: int = 192, w: int = 256,
                    focal: float = 220.0, orbit_radius: float = 16.0,
                    arc_degrees: float = 360.0, dot_radius: float = 5.0, seed: int = 0):
    """The dot collection (the port's own numpy copy of
    ``benchmarks/collection_fixture.py::make_collection``, same arguments,
    defaults and random draws): cameras orbit a cloud of Gaussian dots, each
    with a dimmer satellite blob that diversifies the BRIEF descriptors, at
    orbit_radius over arc_degrees (360 = a closed loop).

    Returns (images (V, H, W) float32, poses (V, 3, 4), K (3, 3), dots (N, 3))."""
    rng = np.random.default_rng(seed)
    dots = rng.uniform(-dot_radius, dot_radius, (n_dots, 3)).astype(np.float32)
    dots *= np.array([1.0, 0.7, 1.0], np.float32)    # flatten vertically
    vals = rng.uniform(0.35, 1.0, n_dots).astype(np.float32)
    sigmas = rng.uniform(1.0, 2.4, n_dots).astype(np.float32)
    sat = dots + rng.uniform(-0.28, 0.28, (n_dots, 3)).astype(np.float32)
    sat_vals = (vals * rng.uniform(0.45, 0.9, n_dots)).astype(np.float32)
    sat_sig = (sigmas * rng.uniform(0.4, 0.7, n_dots)).astype(np.float32)
    dots_r = np.concatenate([dots, sat])
    vals_r = np.concatenate([vals, sat_vals])
    sigmas_r = np.concatenate([sigmas, sat_sig])
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)

    closed = abs(arc_degrees - 360.0) < 1e-6
    poses = []
    for v in range(n_views):
        th = math.radians(arc_degrees) * v / (n_views if closed else max(n_views - 1, 1))
        C = np.array([orbit_radius * math.sin(th), rng.uniform(-0.4, 0.4),
                      -orbit_radius * math.cos(th)], np.float32)
        fwd = -C / np.linalg.norm(C)                  # look at the origin
        up = np.array([0.0, -1.0, 0.0], np.float32)   # image +y is down
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd]).astype(np.float32)
        t = -R @ C
        poses.append(np.concatenate([R, t[:, None]], axis=1))
    poses = np.stack(poses)
    images = np.stack([_render_dots(Rt, dots_r, vals_r, sigmas_r, h, w, focal) for Rt in poses])
    return images, poses, K, dots
