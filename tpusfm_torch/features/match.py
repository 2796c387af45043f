"""Brute-force descriptor matching as dense products.

Counterpart of ``tpusfm/features/match.py``: ±1 descriptors make the
Hamming matrix (D - A @ B^T) / 2, one float32 product (exact for ±1
sums up to D = 2^24). kNN-2 + Lowe ratio, optional mutual cross-check,
then the best ``max_matches`` by ascending distance. Ties break by the
lowest index, as ``lax.top_k`` does. Used when the streaming kernel
(``pallas_match.py``) does not apply: cross-check, a feature budget that
is not a multiple of 256, or the float descriptors of the SURF strategy
(``metric="l2"``).
"""
from __future__ import annotations

import torch

from tpusfm_torch.types import Features, Matches

_BIG = 1e9


def hamming_distance_matrix(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """(..., F1, D) x (..., F2, D) ±1 descriptors -> (..., F1, F2) distances."""
    dots = desc1.to(torch.float32) @ desc2.to(torch.float32).transpose(-1, -2)
    return 0.5 * (desc1.shape[-1] - dots)


def l2_distance_matrix(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """(..., F1, D) x (..., F2, D) float descriptors -> (..., F1, F2) Euclidean
    distances, as |a|^2 + |b|^2 - 2 a.b: one float32 product plus rank-1
    corrections (the legacy ``BruteForceMatcher_GPU<L2>``)."""
    dots = desc1 @ desc2.transpose(-1, -2)
    n1 = (desc1 * desc1).sum(-1)[..., :, None]
    n2 = (desc2 * desc2).sum(-1)[..., None, :]
    return torch.sqrt(torch.clamp(n1 + n2 - 2.0 * dots, min=0.0))


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties broken by the lowest index."""
    val, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def select_matches(best, second, best_idx, valid1, *, ratio: float, max_matches: int,
                   extra_ok=None) -> Matches:
    """Lowe ratio test on (best, second) then the stable top-``max_matches``
    by ascending distance -> Matches (..., M). Shared epilogue of the dense
    matcher and the streaming kernel."""
    ratio_t = torch.full((), ratio, dtype=torch.float32, device=best.device)
    ok = (best < ratio_t * second) & (best < _BIG * 0.5) & valid1
    if extra_ok is not None:
        ok = ok & extra_ok
    score = torch.where(ok, -best, -torch.inf)
    sel_score, sel = topk_stable(score, max_matches)
    sel_ok = torch.isfinite(sel_score)
    left = torch.where(sel_ok, sel, -1).to(torch.int32)
    right = torch.where(sel_ok, best_idx.gather(-1, sel).to(torch.int64), -1).to(torch.int32)
    return Matches(idx=torch.stack([left, right], -1),
                   dist=torch.where(sel_ok, -sel_score, _BIG).to(torch.float32),
                   valid=sel_ok)


def top2(dist: torch.Tensor):
    """(best, second, first-argmin) along the last axis of a distance matrix;
    second excludes only the argmin column."""
    best_idx = dist.argmin(-1)
    best = dist.gather(-1, best_idx[..., None])[..., 0]
    second = dist.scatter(-1, best_idx[..., None], _BIG).min(-1).values
    return best, second, best_idx


def match_pair(desc1, valid1, desc2, valid2, *, ratio: float = 0.8,
               cross_check: bool = False, max_matches: int = 1024,
               metric: str = "hamming") -> Matches:
    """Match view pairs (any leading batch dims) -> fixed-capacity Matches.
    metric="l2" matches float descriptors (the SURF strategy)."""
    dmat = l2_distance_matrix if metric == "l2" else hamming_distance_matrix
    dist = torch.where(valid1[..., :, None] & valid2[..., None, :], dmat(desc1, desc2), _BIG)
    best, second, best_idx = top2(dist)
    mutual = None
    if cross_check:
        rbest = dist.argmin(-2)                                  # best left per right
        f1 = torch.arange(desc1.shape[-2], device=dist.device)
        mutual = rbest.gather(-1, best_idx) == f1
    return select_matches(best, second, best_idx, valid1, ratio=ratio,
                          max_matches=max_matches, extra_ok=mutual)


def match_all_pairs(features: Features, pair_indices: torch.Tensor, *, ratio: float = 0.8,
                    cross_check: bool = False, max_matches: int = 1024,
                    metric: str = "hamming") -> Matches:
    """Match every (i, j) row of pair_indices (P, 2) at once -> Matches (P, M)."""
    i, j = pair_indices[:, 0].long(), pair_indices[:, 1].long()
    return match_pair(features.desc[i], features.valid[i], features.desc[j],
                      features.valid[j], ratio=ratio, cross_check=cross_check,
                      max_matches=max_matches, metric=metric)


def matched_coordinates(features: Features, pair, matches: Matches):
    """Aligned (uv1, uv2, mask) pixel coords for one matched pair; invalid
    slots gather index 0 but stay masked."""
    i, j = int(pair[0]), int(pair[1])
    li = torch.clamp(matches.idx[:, 0], min=0).long()
    ri = torch.clamp(matches.idx[:, 1], min=0).long()
    return features.xy[i][li], features.xy[j][ri], matches.valid
