"""Procedurally textured multi-view scene, rendered with numpy from a seed.

The port's own copy of the ray-cast renderer of
``benchmarks/strecha_fixture.py`` (``_render``/``_noise3``): a corner of
three planes (two converging walls and a ground plane) shaded with
aperiodic multi-octave lattice value noise, seen from a converging arc of
cameras. Lattice noise is locally distinctive everywhere, so FAST/BRIEF
features localise to sub-pixel accuracy and match without repeats. It
stands in for the crazyhorse photographs where those are absent, at the
same image size and view count.

``make_fixture`` writes the Strecha-format dataset of
``benchmarks/strecha_fixture.py`` (PNGs plus ``.camera`` ground truth, with
radial distortion applied in the renderer), rendered with torch in float64
on a device. ``make_collection_scene`` renders the collection-scale fixture:
a closed ring of cameras inside a relief-displaced textured cylinder, with
numpy or, given a device, with the same torch noise.
``make_collection`` renders the dot collection of
``benchmarks/collection_fixture.py::make_collection`` (Gaussian dots seen
from an arc), which the multi-rank checks use.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch


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
                          seed: int = 0, device=None):
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

    ``device`` (a torch device) renders with the torch noise of
    ``make_fixture`` there, in batches of views; None renders with numpy.
    The two agree to the last float32 bit but where ``tanh`` rounds
    differently.

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
    if device is not None:
        return (_render_ring_torch(poses, h, w, focal, wall_radius, relief_amp, s, device),
                poses, K)

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


# ---------------------------------------------------------------------- #
# The same noise and ray casts in torch, float64, on any device. Every
# operation is the numpy one's, in the same order (products and sums that
# numpy hands to BLAS are written out, which may move the last bit); tanh
# may round differently on the card, so an 8-bit pixel may differ by one.
# ---------------------------------------------------------------------- #
def _hash3_t(ix, iy, iz, seed: int):
    """``_hash3`` on int64 tensors (which wrap as numpy's int64 do)."""
    h = (ix * 374761393 + iy * 668265263 + iz * 2147483647 + seed * 144665) & 0x7FFFFFFF
    h = (h ^ (h >> 13)) * 1274126177 & 0x7FFFFFFF
    return ((h ^ (h >> 16)) & 0xFFFFFF).to(torch.float64) / float(0x1000000)


def _value_noise3_t(X, scale: float, seed: int):
    """``_value_noise3`` on a float64 tensor X (..., 3)."""
    P = X * scale
    i = torch.floor(P).to(torch.int64)
    f = P - i.to(torch.float64)
    f = f * f * (3.0 - 2.0 * f)
    out = torch.zeros(X.shape[:-1], dtype=torch.float64, device=X.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                h = _hash3_t(i[..., 0] + dx, i[..., 1] + dy, i[..., 2] + dz, seed)
                wgt = ((f[..., 0] if dx else 1 - f[..., 0])
                       * (f[..., 1] if dy else 1 - f[..., 1])
                       * (f[..., 2] if dz else 1 - f[..., 2]))
                out += wgt * h
    return out


def _noise3_t(seed: int, detail: float = 1.0):
    """``_noise3`` on tensors."""

    def tex(X):
        v = (0.5 * _value_noise3_t(X, 0.9, seed)
             + 0.28 * _value_noise3_t(X, 2.3, seed + 1)
             + 0.16 * _value_noise3_t(X, 5.1, seed + 2)
             + 0.08 * _value_noise3_t(X, 11.7, seed + 3))
        amp, scale, k = 0.14, 26.0, 4
        while scale < 11.7 * detail:
            v = v + amp * _value_noise3_t(X, scale, seed + k)
            amp, scale, k = amp * 0.65, scale * 2.2, k + 1
        v = (v - 0.5) * 2.8
        return 0.5 + 0.42 * torch.tanh(v)

    return tex


def _pixel_grid(h: int, w: int, device):
    """Pixel centres' (x, y), each (h * w,) float64, row-major."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _rays(xn, R):
    """xn (..., N, 3) @ R (..., 3, 3), the three products summed in order."""
    return xn[..., 0:1] * R[..., None, 0, :] + xn[..., 1:2] * R[..., None, 1, :] \
        + xn[..., 2:3] * R[..., None, 2, :]


def render_fixture_view(Rt, K, dist, h: int, w: int, seed: int = 0, device="cpu"):
    """One view of the Strecha-format fixture as the 8-bit image its PNG
    holds: ``benchmarks/strecha_fixture.py::_render`` (the corner scene, the
    inverse Brown model per pixel before the ray cast) and its quantisation,
    in torch float64 on ``device``. Rt (3, 4) world->camera, K (3, 3),
    dist (k1, k2, k3) as numpy. Returns (h, w) uint8 on ``device``."""
    dev = torch.device(device)
    tex = _noise3_t(seed + 7, detail=max(w / 512.0, 1.0))
    xs, ys = _pixel_grid(h, w, dev)
    xn = torch.stack([(xs - float(K[0, 2])) / float(K[0, 0]),
                      (ys - float(K[1, 2])) / float(K[1, 1])], -1)
    dist = np.asarray(dist, np.float64)
    if np.any(dist != 0):
        k1, k2, k3 = (float(k) for k in dist)
        x = xn.clone()
        for _ in range(8):
            r2 = (x ** 2).sum(-1, keepdim=True)
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            x = x - (x * radial - xn)
        xn = x
    R = np.asarray(Rt[:, :3], np.float64)
    o = -R.T @ np.asarray(Rt[:, 3], np.float64)
    xn1 = torch.cat([xn, torch.ones_like(xn[:, :1])], 1)
    d = _rays(xn1, torch.as_tensor(R, device=dev))
    best_t = torch.full((len(d),), math.inf, dtype=torch.float64, device=dev)
    for n0, c0 in _PLANES:
        nn = np.linalg.norm(n0)
        n, c = n0 / nn, c0 / nn
        denom = d[:, 0] * float(n[0]) + d[:, 1] * float(n[1]) + d[:, 2] * float(n[2])
        t = (float(c - o @ n)) / torch.where(denom.abs() < 1e-9, 1e-9, denom)
        ok = (t > 0.5) & (t < best_t)
        best_t = torch.where(ok, t, best_t)
    X = torch.as_tensor(o, device=dev) + best_t[:, None] * d
    img = torch.where(torch.isfinite(best_t), tex(X), 0.05)
    img = img.clamp(0.0, 1.0).reshape(h, w).to(torch.float32)
    return (img * 255).to(torch.uint8)


def fixture_poses(n_views: int = 9, h: int = 384, w: int = 512, focal: float = 520.0,
                  seed: int = 0):
    """The fixture's cameras (``benchmarks/strecha_fixture.py::make_fixture``'s
    draws from ``default_rng(seed)``): (poses (V, 3, 4) world->camera, K),
    float64."""
    rng = np.random.default_rng(seed)
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float64)
    poses = []
    for v in range(n_views):
        # a curved, converging arc: lateral and depth motion with an inward
        # rotation keeps every pair's two-view geometry well conditioned
        u = v / max(n_views - 1, 1)
        tx = -2.5 + 5.0 * u
        tz = 1.5 * math.sin(math.pi * u)
        ry = math.radians(-14.0 + 28.0 * u)
        rx = math.radians(float(rng.uniform(-1.0, 1.0)))
        cy, sy = math.cos(ry), math.sin(ry)
        cx, sx = math.cos(rx), math.sin(rx)
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        R = Ry @ Rx
        t = np.array([tx, rng.uniform(-0.2, 0.2), tz + rng.uniform(-0.2, 0.2)])
        poses.append(np.concatenate([R, t[:, None]], axis=1))
    return np.stack(poses), K


def make_fixture(out_dir: str, n_views: int = 9, h: int = 384, w: int = 512,
                 focal: float = 520.0, dist=(0.0, 0.0, 0.0), seed: int = 0, device="cpu"):
    """Write the Strecha-format dataset of ``benchmarks/strecha_fixture.py::
    make_fixture`` (the port's own copy, rendered with torch on ``device``):
    ``{v:04d}.png`` and ``{v:04d}.png.camera`` (K rows 1-3, the radial
    distortion k1 k2 k3 on row 4, R camera->world rows 5-7, the camera centre
    on row 8, ``w h`` on row 9). Texture detail grows with the width
    (``detail = max(w / 512, 1)``), so a large render keeps pixel-scale
    structure. Returns (gt_poses (V, 3, 4) world->camera, K (3, 3))."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    poses, K = fixture_poses(n_views, h, w, focal, seed)
    dist = np.asarray(dist, np.float64)
    for v, Rt in enumerate(poses):
        img = render_fixture_view(Rt, K, dist, h, w, seed, device).cpu().numpy()
        Image.fromarray(img).save(os.path.join(out_dir, f"{v:04d}.png"))
        R_cw = Rt[:, :3].T
        c = -Rt[:, :3].T @ Rt[:, 3]
        lines = [" ".join(f"{x:.8f}" for x in row) for row in K]
        lines.append(" ".join(f"{x:.8f}" for x in dist))
        lines += [" ".join(f"{x:.8f}" for x in row) for row in R_cw]
        lines.append(" ".join(f"{x:.8f}" for x in c))
        lines.append(f"{w} {h}")
        with open(os.path.join(out_dir, f"{v:04d}.png.camera"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return poses, K


def _render_ring_torch(poses, h: int, w: int, focal: float, wall_radius: float,
                       relief_amp: float, s: int, device, batch: int = 64):
    """``make_collection_scene``'s ray casts against the relief-displaced
    cylinder and the ground plane, in torch float64 on ``device``, ``batch``
    views at a time. Returns (V, h, w) float32 numpy."""
    dev = torch.device(device)

    def tex(X):
        v = (0.40 * _value_noise3_t(X, 2.0, s)
             + 0.30 * _value_noise3_t(X, 4.6, s + 1)
             + 0.20 * _value_noise3_t(X, 10.4, s + 2)
             + 0.12 * _value_noise3_t(X, 23.0, s + 3))
        v = (v - 0.51) * 6.0
        return 0.5 + 0.46 * torch.tanh(v)

    xs, ys = _pixel_grid(h, w, dev)
    xn = torch.stack([(xs - w / 2) / focal, (ys - h / 2) / focal, torch.ones_like(xs)], -1)
    images = np.empty((len(poses), h, w), np.float32)
    for b0 in range(0, len(poses), batch):
        Rt = poses[b0:b0 + batch].astype(np.float64)
        R = Rt[:, :, :3]
        o_np = np.stack([-Ri.T @ Rti[:, 3] for Ri, Rti in zip(R, Rt)])
        o = torch.as_tensor(o_np, device=dev)[:, None, :]            # (B, 1, 3)
        d = _rays(xn, torch.as_tensor(R, device=dev))               # (B, N, 3)
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
                bump = relief_amp * 2.0 * (_value_noise3_t(Xw, 0.55, s + 9) - 0.5)
                t_wall = cyl_hit(wall_radius + bump)
        t_gnd = torch.where(d[..., 1] > 1e-9, (3.0 - o1) / d[..., 1], math.inf)
        X = o + torch.minimum(t_wall, t_gnd)[..., None] * d
        img = tex(X).clamp(0.0, 1.0).reshape(-1, h, w).to(torch.float32)
        images[b0:b0 + len(Rt)] = img.cpu().numpy()
    return images


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
