"""Generic batched-hypothesis RANSAC (counterpart of ``tpusfm/ransac.py``).

Sample B minimal sets at once, solve all B models in one batched call,
score every datum against every model as one (..., B, N) residual
tensor, keep the best MSAC score, then locally optimise (LO-RANSAC).

Batching: ``data`` tensors are (..., N, d) with any leading batch
dimensions (pairs, views); the solver sees (..., B, k, d), the scorer
(..., B, N, d) and the refit (..., N, d) or (..., t, N, d).

Randomness comes from an explicit ``torch.Generator``. JAX's threefry
streams cannot be reproduced, so ``sample_idx`` (..., B, k) lets a caller
(the parity tests) feed the reference's own minimal samples instead.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch


def take_many(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (*batch, B, *rest), idx (*batch, t) -> (*batch, t, *rest)."""
    nb = idx.dim() - 1
    rest = x.shape[nb + 1:]
    flat = x.reshape(*x.shape[:nb + 1], -1)
    g = torch.gather(flat, nb, idx[..., None].expand(*idx.shape, flat.shape[-1]))
    return g.reshape(*idx.shape, *rest)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (*batch, B, *rest), idx (*batch) -> x[..., idx, ...] (*batch, *rest)."""
    return take_many(x, idx[..., None]).squeeze(idx.dim())


def sample_indices(generator: torch.Generator, mask: torch.Tensor,
                   hypotheses: int, k: int) -> torch.Tensor:
    """(..., B, k) indices sampled without replacement from valid entries:
    Gumbel-top-k over masked logits, ties broken by a stable sort (lowest
    index first, as lax.top_k)."""
    u = torch.rand(*mask.shape[:-1], hypotheses, mask.shape[-1],
                   generator=generator, device=mask.device)
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
    logits = torch.where(mask[..., None, :], g, -math.inf)
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :k]


def ransac(
    generator: torch.Generator | None,
    data: Tuple[torch.Tensor, ...],
    mask: torch.Tensor,
    *,
    solver: Callable,       # (*minimal (..., B, k, d)) -> (models (..., B, ...), ok (..., B))
    scorer: Callable,       # (models (..., B, ...), *data (..., B, N, d)) -> (..., B, N)
    sample_size: int,
    hypotheses: int,
    threshold: float,
    refit: Callable | None = None,  # (model, w (..., N), *data) -> model
    lo_multipliers: Tuple[float, ...] = (4.0, 2.0, 1.0),
    lo_candidates: int = 1,
    sample_idx: torch.Tensor | None = None,
):
    """Batched-hypothesis RANSAC. Returns (model, inlier_mask (..., N), count)."""
    if sample_idx is None:
        sample_idx = sample_indices(generator, mask, hypotheses, sample_size)
    B = sample_idx.shape[-2]
    n = mask.shape[-1]
    minimal = tuple(torch.take_along_dim(d[..., None, :, :], sample_idx[..., None], dim=-2)
                    for d in data)                                  # (..., B, k, d)
    models, ok = solver(*minimal)

    thr2 = threshold * threshold

    def msac(resid, m):
        r = torch.where(torch.isfinite(resid), resid, math.inf)
        return torch.where(m, torch.clamp(thr2 - r * r, min=0.0), 0.0).sum(-1)

    def expand(d, t):
        return d[..., None, :, :].expand(*d.shape[:-2], t, n, d.shape[-1])

    resid = scorer(models, *(expand(d, B) for d in data))           # (..., B, N)
    resid = torch.where(torch.isfinite(resid), resid, math.inf)
    inl = (resid < threshold) & mask[..., None, :]
    scores = torch.where(ok, msac(resid, mask[..., None, :]), -1.0)
    best = scores.argmax(-1)                                        # first max

    if refit is None:
        inlier_mask = take(inl, best)
        return take(models, best), inlier_mask, inlier_mask.sum(-1)

    def lo_chain(model, inlier_mask, score, d, m):
        # d: data with the candidate axis already broadcast; m: its mask
        for mult in lo_multipliers:
            w = ((scorer(model, *d) < threshold * mult) & m).to(d[0].dtype)
            cand = refit(model, w, *d)
            r2 = scorer(cand, *d)
            r2 = torch.where(torch.isfinite(r2), r2, math.inf)
            s2 = msac(r2, m)
            inl2 = (r2 < threshold) & m
            better = s2 >= score
            bm = better.reshape(*better.shape, *([1] * (model.dim() - better.dim())))
            model = torch.where(bm, cand, model)
            inlier_mask = torch.where(better[..., None], inl2, inlier_mask)
            score = torch.where(better, s2, score)
        return model, inlier_mask, score

    if lo_candidates <= 1:
        model, inlier_mask, _ = lo_chain(take(models, best), take(inl, best),
                                         take(scores, best), data, mask)
        return model, inlier_mask, inlier_mask.sum(-1)

    t = min(lo_candidates, B)
    top = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :t]
    ms, is_, ss = lo_chain(take_many(models, top), take_many(inl, top),
                           take_many(scores, top),
                           tuple(expand(d, t) for d in data),
                           mask[..., None, :].expand(*mask.shape[:-1], t, n))
    b = ss.argmax(-1)
    inlier_mask = take(is_, b)
    return take(ms, b), inlier_mask, inlier_mask.sum(-1)


def adaptive_num_hypotheses(inlier_ratio: float, sample_size: int, confidence: float = 0.999) -> int:
    """Classic RANSAC iteration bound N = log(1-p)/log(1-w^k) (host helper)."""
    w = max(min(inlier_ratio, 0.999), 1e-3)
    denom = math.log(max(1e-12, 1.0 - w ** sample_size))
    if denom >= 0:
        return 1
    return max(1, int(math.ceil(math.log(1.0 - confidence) / denom)))
