"""Pyramidal Lucas-Kanade optical-flow matcher (batched torch ops).

Counterpart of ``tpusfm/features/optical_flow.py`` (legacy OFFeatureMatcher,
OFFeatureMatcher.cpp:53-183): FAST keypoints of the left view are tracked
into the right view by iterative pyramidal LK, survivors are filtered by
their tracking residual on the 0..255 byte scale, and flow endpoints are
associated with detected right-view keypoints by radius and a ratio test,
one claim per right keypoint.

Every keypoint tracks at once (a damped 2x2 normal-equation solve in closed
form per keypoint and iteration), and so does every pair of a batch: the
functions take a leading batch axis of pairs. The iteration loop is a
Python loop over device ops with no read-back. The pyramid is a blur
followed by an antialiased resize (``features/detect.py::_resize``), as
``jax.image.resize(..., "linear")`` does.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tpusfm_torch.features.detect import (
    _DIFF3,
    _SMOOTH3,
    _bilinear,
    _conv1d_taps,
    _gaussian_kernel1d,
    _resize,
    _sep_conv2d,
)
from tpusfm_torch.features.match import _BIG, top2, topk_stable
from tpusfm_torch.types import Matches


@functools.lru_cache(maxsize=None)
def _window_offsets(radius: int):
    dy, dx = np.mgrid[-radius: radius + 1, -radius: radius + 1]
    return np.asarray(dy, np.float32).ravel(), np.asarray(dx, np.float32).ravel()


def _window(pts: torch.Tensor, radius: int):
    """Sample grid (px, py), each (B, K, (2r+1)^2), around pts (B, K, 2)."""
    dy, dx = (torch.as_tensor(o, device=pts.device) for o in _window_offsets(radius))
    return pts[..., 0:1] + dx, pts[..., 1:2] + dy


def _lk_level(I, J, Ix, Iy, pts_prev, guess, radius: int, iters: int):
    """One pyramid level of iterative LK for all points at once.

    I, J, Ix, Iy: (B, h, w) images of this level and I's gradients;
    pts_prev, guess: (B, K, 2) [x, y] positions in I and the current flow.
    Returns the refined flow (B, K, 2)."""
    px, py = _window(pts_prev, radius)
    tmpl = _bilinear(I, py, px)                   # (B, K, W2) template window
    gx = _bilinear(Ix, py, px)
    gy = _bilinear(Iy, py, px)
    # spatial gradient matrix, damped for low-texture windows, inverted in
    # closed form
    gxx = (gx * gx).sum(-1)
    gxy = (gx * gy).sum(-1)
    gyy = (gy * gy).sum(-1)
    eps = 1e-6 + 1e-4 * (gxx + gyy)
    a = gxx + eps
    c = gyy + eps
    d2 = a * c - gxy * gxy
    i00 = c / d2
    i01 = -gxy / d2
    i11 = a / d2
    flow = guess
    for _ in range(iters):
        diff = tmpl - _bilinear(J, py + flow[..., 1:2], px + flow[..., 0:1])
        bx = (diff * gx).sum(-1)
        by = (diff * gy).sum(-1)
        step = torch.stack([i00 * bx + i01 * by, i01 * bx + i11 * by], -1)
        flow = flow + torch.clamp(step, -radius, radius)
    return flow


def track_points(img1: torch.Tensor, img2: torch.Tensor, pts: torch.Tensor, *,
                 levels: int = 4, radius: int = 10, iters: int = 20,
                 init_flow: torch.Tensor | None = None):
    """Track [x, y] points from img1 into img2: images (B, H, W), pts and
    init_flow (B, K, 2). init_flow seeds the coarsest level's estimate
    (the legacy feature-seeded flow initialisation).

    Returns (endpoints, residual): the residual is the mean |I - J| over a
    7x7 window on the 0..255 byte scale the legacy filter uses."""
    blur = _gaussian_kernel1d(1.0, 2)
    pyr1, pyr2 = [img1], [img2]
    for _ in range(1, levels):
        nh, nw = max(pyr1[-1].shape[-2] // 2, 16), max(pyr1[-1].shape[-1] // 2, 16)
        pyr1.append(_resize(_sep_conv2d(pyr1[-1], blur), nh, nw))
        pyr2.append(_resize(_sep_conv2d(pyr2[-1], blur), nh, nw))

    flow = torch.zeros_like(pts) if init_flow is None else init_flow
    for lvl in reversed(range(levels)):
        s = 2.0 ** lvl
        I, J = pyr1[lvl], pyr2[lvl]
        # Sobel/8 = smooth (1,2,1)/4 x diff (-1,0,1)/2, as shift-adds
        Ix = _conv1d_taps(_conv1d_taps(I, _SMOOTH3, 0), _DIFF3, 1)
        Iy = _conv1d_taps(_conv1d_taps(I, _SMOOTH3, 1), _DIFF3, 0)
        flow = _lk_level(I, J, Ix, Iy, pts / s, flow / s, radius, iters) * s

    # final residual at full resolution
    px, py = _window(pts, 3)
    t = _bilinear(img1, py, px)
    c = _bilinear(img2, py + flow[..., 1:2], px + flow[..., 0:1])
    return pts + flow, (t - c).abs().mean(-1) * 255.0


def sq_distances(endpoints, feats2_xy, feats2_valid):
    """(B, K, F2) squared distances from endpoints to the valid right
    keypoints; _BIG for invalid ones."""
    d2 = ((endpoints[..., :, None, :] - feats2_xy[..., None, :, :]) ** 2).sum(-1)
    return torch.where(feats2_valid[..., None, :], d2, _BIG)


def claim_and_select(ok, best, right, n_right: int, max_matches: int) -> Matches:
    """Shared epilogue of the flow matchers: a right keypoint may be claimed
    by one left keypoint only (the nearest wins, ties to all of them, as the
    reference's scatter-max does), then the best ``max_matches`` by ascending
    distance -> Matches (B, max_matches), padded when there are fewer left
    keypoints than that."""
    score = torch.where(ok, -best, -torch.inf)
    winner = torch.full(score.shape[:-1] + (n_right,), -torch.inf, device=score.device)
    winner = winner.scatter_reduce(-1, right, score, "amax", include_self=True)
    is_winner = ok & (score >= winner.gather(-1, right))
    sel_score, sel = topk_stable(torch.where(is_winner, -best, -torch.inf), max_matches)
    pad = max_matches - sel.shape[-1]
    if pad:
        sel_score = torch.nn.functional.pad(sel_score, (0, pad), value=-torch.inf)
        sel = torch.nn.functional.pad(sel, (0, pad))
    sel_ok = torch.isfinite(sel_score)
    left = torch.where(sel_ok, sel, -1).to(torch.int32)
    rsel = torch.where(sel_ok, right.gather(-1, sel), -1).to(torch.int32)
    return Matches(idx=torch.stack([left, rsel], -1),
                   dist=torch.where(sel_ok, -sel_score, _BIG).to(torch.float32),
                   valid=sel_ok)


def match_pair_optical_flow(img1, img2, feats1_xy, feats1_valid, feats2_xy, feats2_valid, *,
                            max_error: float = 25.0, assoc_radius: float = 2.0,
                            ratio: float = 0.7, max_matches: int = 1024, levels: int = 4,
                            iters: int = 20) -> Matches:
    """LK-flow matching of view pairs -> fixed-capacity Matches (B, M):
    images (B, H, W), keypoints (B, F, 2) and their masks (B, F).

    The legacy acceptance chain (OFFeatureMatcher.cpp:111-151): a residual
    filter, the endpoint's nearest right keypoint within ``assoc_radius``
    with a ``ratio`` test among the candidates inside the radius only (a
    single one is accepted outright), one claim per right keypoint."""
    endpoints, err = track_points(img1, img2, feats1_xy, levels=levels, iters=iters)
    tracked = feats1_valid & (err <= max_error)
    best2, second2, right = top2(sq_distances(endpoints, feats2_xy, feats2_valid))
    best = torch.sqrt(best2)
    second = torch.sqrt(torch.clamp(second2, min=0.0))
    ok = tracked & (best <= assoc_radius) & ((second > assoc_radius) | (best < ratio * second))
    return claim_and_select(ok, best, right, feats2_xy.shape[-2], max_matches)
