"""The benchmark's scenes, rendered with torch on the card from a seed.

A frozen copy of the port's renderers (``tpusfm_torch/tools/synthetic.py``),
kept here so the yardstick cannot move with the program:

* ``corner_scene``: ``make_scene``'s textured corner of three planes seen
  from a converging arc of cameras (the stand-in for the crazyhorse
  photographs at their size and view count);
* ``ring_sector``: ``make_collection_scene``'s ring of cameras inside a
  relief-displaced textured cylinder, ``n_views`` consecutive views of a
  ring of ``ring_views`` starting at ``start``.

The camera draws are the originals' numpy draws, in the same order; the
pixels are the originals' lattice noise and ray casts in torch float64 on
any device, every product written out in numpy's order, so a CPU render
equals the numpy one but where ``tanh`` rounds differently.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _hash3(ix, iy, iz, seed: int):
    """Integer-lattice hash of int64 tensors -> [0, 1)."""
    h = (ix * 374761393 + iy * 668265263 + iz * 2147483647 + seed * 144665) & 0x7FFFFFFF
    h = (h ^ (h >> 13)) * 1274126177 & 0x7FFFFFFF
    return ((h ^ (h >> 16)) & 0xFFFFFF).to(torch.float64) / float(0x1000000)


def _value_noise3(X, scale: float, seed: int):
    """Trilinear lattice value noise at one octave of a float64 (..., 3) tensor."""
    P = X * scale
    i = torch.floor(P).to(torch.int64)
    f = P - i.to(torch.float64)
    f = f * f * (3.0 - 2.0 * f)
    out = torch.zeros(X.shape[:-1], dtype=torch.float64, device=X.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                h = _hash3(i[..., 0] + dx, i[..., 1] + dy, i[..., 2] + dz, seed)
                wgt = ((f[..., 0] if dx else 1 - f[..., 0])
                       * (f[..., 1] if dy else 1 - f[..., 1])
                       * (f[..., 2] if dz else 1 - f[..., 2]))
                out += wgt * h
    return out


def _corner_texture(seed: int, detail: float):
    """``make_scene``'s multi-octave noise; detail > 1 adds finer octaves."""

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
        return 0.5 + 0.42 * torch.tanh(v)

    return tex


# corner scene: n . X = c  (two walls meeting at x=0 + a ground plane)
_PLANES = [
    (np.array([0.35, 0.0, 1.0]), 16.0),
    (np.array([-0.35, 0.0, 1.0]), 16.0),
    (np.array([0.0, 1.0, -0.12]), 4.0),
]


def _pixel_grid(h: int, w: int, device):
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _rays(xn, R):
    """xn (..., N, 3) @ R (..., 3, 3), the three products summed in order."""
    return xn[..., 0:1] * R[..., None, 0, :] + xn[..., 1:2] * R[..., None, 1, :] \
        + xn[..., 2:3] * R[..., None, 2, :]


def corner_poses(n_views: int, seed: int):
    """``make_scene``'s cameras: (V, 3, 4) float64 world->camera."""
    rng = np.random.default_rng(seed)
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
    return np.stack(poses)


def corner_scene(n_views: int, h: int, w: int, focal: float | None, seed: int, device):
    """``make_scene(n_views, h, w, focal, seed)`` rendered on ``device``:
    (images (V, H, W) float32 numpy in [0, 1], poses (V, 3, 4) float32,
    K (3, 3) float32)."""
    dev = torch.device(device)
    focal = 520.0 * w / 512.0 if focal is None else float(focal)
    tex = _corner_texture(seed + 7, detail=max(2.0 * w / 512.0, 1.0))
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float64)
    poses = corner_poses(n_views, seed)
    xs, ys = _pixel_grid(h, w, dev)
    xn = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                      torch.ones_like(xs)], -1)
    images = np.empty((n_views, h, w), np.float32)
    for v, Rt in enumerate(poses):
        R = Rt[:, :3]
        o = -R.T @ Rt[:, 3]
        d = _rays(xn, torch.as_tensor(R, device=dev))
        best_t = torch.full((len(d),), math.inf, dtype=torch.float64, device=dev)
        for n0, c0 in _PLANES:
            nn = np.linalg.norm(n0)
            n, c = n0 / nn, c0 / nn
            denom = d[:, 0] * float(n[0]) + d[:, 1] * float(n[1]) + d[:, 2] * float(n[2])
            t = float(c - o @ n) / torch.where(denom.abs() < 1e-9, 1e-9, denom)
            ok = (t > 0.5) & (t < best_t)
            best_t = torch.where(ok, t, best_t)
        X = torch.as_tensor(o, device=dev) + best_t[:, None] * d
        img = torch.where(torch.isfinite(best_t), tex(X), 0.05)
        images[v] = img.clamp(0.0, 1.0).reshape(h, w).to(torch.float32).cpu().numpy()
    return images, poses.astype(np.float32), K.astype(np.float32)


def ring_poses(ring_views: int, seed: int):
    """``make_collection_scene``'s cameras for a ring of ``ring_views``:
    (V, 3, 4) float32 world->camera."""
    rng = np.random.default_rng(seed)
    orbit_radius = 6.0
    poses = []
    for v in range(ring_views):
        th = 2.0 * math.pi * v / ring_views
        C = np.array([orbit_radius * math.sin(th), rng.uniform(-0.25, 0.25),
                      -orbit_radius * math.cos(th)], np.float64)
        fwd = np.array([math.sin(th), 0.0, -math.cos(th)])
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
    return np.stack(poses)


def ring_sector(ring_views: int, start: int, n_views: int, h: int, w: int, focal: float,
                seed: int, device, wall_radius: float = 10.0, relief_amp: float = 1.2):
    """Views ``start .. start + n_views - 1`` (mod ``ring_views``) of
    ``make_collection_scene(ring_views, h, w, focal, seed=seed)``, rendered on
    ``device``: (images (V, H, W) float32 numpy, poses (V, 3, 4) float32,
    K (3, 3) float32)."""
    dev = torch.device(device)
    s = seed + 7
    sel = (start + np.arange(n_views)) % ring_views
    poses = ring_poses(ring_views, seed)[sel]
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)

    def tex(X):
        v = (0.40 * _value_noise3(X, 2.0, s)
             + 0.30 * _value_noise3(X, 4.6, s + 1)
             + 0.20 * _value_noise3(X, 10.4, s + 2)
             + 0.12 * _value_noise3(X, 23.0, s + 3))
        v = (v - 0.51) * 6.0
        return 0.5 + 0.46 * torch.tanh(v)

    xs, ys = _pixel_grid(h, w, dev)
    xn = torch.stack([(xs - w / 2) / focal, (ys - h / 2) / focal, torch.ones_like(xs)], -1)
    Rt = poses.astype(np.float64)
    R = Rt[:, :, :3]
    o_np = np.stack([-Ri.T @ Rti[:, 3] for Ri, Rti in zip(R, Rt)])
    o = torch.as_tensor(o_np, device=dev)[:, None, :]
    d = _rays(xn, torch.as_tensor(R, device=dev))
    o0, o1, o2 = o[..., 0], o[..., 1], o[..., 2]
    a = d[..., 0] ** 2 + d[..., 2] ** 2
    b = 2.0 * (o0 * d[..., 0] + o2 * d[..., 2])

    def cyl_hit(radius):
        c = o0 ** 2 + o2 ** 2 - radius ** 2
        disc = torch.clamp_min(b * b - 4 * a * c, 0.0)
        return (-b + torch.sqrt(disc)) / torch.clamp_min(2 * a, 1e-12)

    t_wall = cyl_hit(wall_radius)
    if relief_amp > 0.0:
        for _ in range(3):
            Xw = o + t_wall[..., None] * d
            bump = relief_amp * 2.0 * (_value_noise3(Xw, 0.55, s + 9) - 0.5)
            t_wall = cyl_hit(wall_radius + bump)
    t_gnd = torch.where(d[..., 1] > 1e-9, (3.0 - o1) / d[..., 1], math.inf)
    X = o + torch.minimum(t_wall, t_gnd)[..., None] * d
    images = tex(X).clamp(0.0, 1.0).reshape(-1, h, w).to(torch.float32).cpu().numpy()
    return images, poses, K
