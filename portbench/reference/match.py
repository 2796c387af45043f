"""Plain brute-force matching: Hamming top-2, Lowe's ratio test and the
selection of the best ``max_matches`` per pair.

What the port's matcher (kernel K1 and its epilogue) is stated to compute,
written out as a dense float64 product of ±1 descriptors (exact for any
descriptor length below 2^52). The first minimum breaks ties by the lowest
key index, the second excludes only that column, the ratio test compares
in float32 as the configuration states it (``best < float32(ratio) *
second``), and the selection is a stable sort by ascending distance.
"""
from __future__ import annotations

import torch

_BIG = 1e9


def match_pair(d1: torch.Tensor, v1: torch.Tensor, d2: torch.Tensor, v2: torch.Tensor, *,
               ratio: float, max_matches: int):
    """d1 (F1, D), d2 (F2, D) ±1; v1 (F1,), v2 (F2,) bool ->
    (left (n,), right (n,), dist (n,)) of the selected matches, best first."""
    D = d1.shape[-1]
    dots = d1.to(torch.float64) @ d2.to(torch.float64).T
    dist = torch.where(v2[None, :], 0.5 * (D - dots), _BIG)
    best_idx = dist.argmin(-1)
    best = dist.gather(-1, best_idx[:, None])[:, 0]
    second = dist.scatter(-1, best_idx[:, None], _BIG).min(-1).values
    b32, s32 = best.to(torch.float32), second.to(torch.float32)
    r32 = torch.full((), ratio, dtype=torch.float32, device=s32.device)
    ok = (b32 < r32 * s32) & (best < _BIG * 0.5) & v1
    left = torch.nonzero(ok)[:, 0]
    order = torch.sort(best[left], stable=True).indices[:max_matches]
    left = left[order]
    return left, best_idx[left], best[left]
