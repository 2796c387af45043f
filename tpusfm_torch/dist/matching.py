"""Pair-parallel feature matching over the mesh.

Counterpart of ``tpusfm/dist/matching.py``, the replacement for the
reference's std::thread fan-out over image pairs (SfM.cpp:165-211). Each
rank matches a block of pairs and ``all_gather`` assembles the whole
result on every rank.

The local matcher is tpusfm's rule (``pipeline/collection.py``): on a CUDA
device, without cross-check and with a feature capacity that is a multiple
of 256, the streaming top-2 kernel (``features/pallas_match.py``, one
launch per block and per ring round); otherwise the dense matcher of
``features/match.py``. The two give identical matches.
"""
from __future__ import annotations

import numpy as np
import torch

from tpusfm_torch.dist.mesh import Mesh
from tpusfm_torch.features import pallas_match
from tpusfm_torch.features.match import match_all_pairs, match_pair, select_matches
from tpusfm_torch.types import Features, Matches


def _streaming(features: Features, cross_check: bool = False) -> bool:
    return features.desc.is_cuda and not cross_check and features.capacity % 256 == 0


def _gather_matches(mesh: Mesh, m: Matches, name: str) -> Matches:
    """All ranks' Matches concatenated in rank order, in one collective: the
    int32 indices, the float32 distances' bits and the mask in one buffer."""
    n, M = m.valid.shape
    packed = torch.cat([m.idx.reshape(n, 2 * M), m.dist.view(torch.int32),
                        m.valid.to(torch.int32)], 1)
    full = mesh.all_gather(packed, name)
    return Matches(idx=full[:, :2 * M].reshape(-1, M, 2),
                   dist=full[:, 2 * M:3 * M].contiguous().view(torch.float32),
                   valid=full[:, 3 * M:].bool())


def match_all_pairs_sharded(mesh: Mesh, features: Features, pair_indices, *, ratio: float = 0.8,
                            cross_check: bool = False, max_matches: int = 1024) -> Matches:
    """Match (P, 2) pairs sharded across the mesh -> Matches (P, M) in pair
    order, on every rank (features replicated).

    P must be a multiple of the mesh size (pad with (0, 1) duplicates and
    drop the tail — the caller controls padding so results stay aligned
    with its pair list). ``features.desc`` may be the int8 signs of
    ``pallas_match.descriptor_signs`` where the streaming kernel applies."""
    pairs = torch.as_tensor(pair_indices, device=features.desc.device).long()
    P = pairs.shape[0]
    if P % mesh.size:
        raise ValueError(f"pad pairs ({P}) to a multiple of the mesh ({mesh.size})")
    B = P // mesh.size
    blk = pairs[mesh.rank * B:(mesh.rank + 1) * B]
    if _streaming(features, cross_check):
        m = pallas_match.match_pairs(features.desc, features.valid, blk, ratio=ratio,
                                     max_matches=max_matches)
    else:
        m = match_all_pairs(features, blk, ratio=ratio, cross_check=cross_check,
                            max_matches=max_matches)
    return _gather_matches(mesh, m, "match_all_pairs_sharded")


def match_all_pairs_ring(mesh: Mesh, features: Features, *, ratio: float = 0.8,
                         max_matches: int = 1024):
    """All-pairs matching with VIEW-sharded descriptors and a ring pass.

    Views are block-sharded over the mesh (B = V / size per rank). In each
    of ``size`` rounds a rank matches its resident block against the
    visiting block (one matcher call for the B x B pairs), then passes the
    visiting block on to rank + 1. A (resident, visiting) pair is emitted
    only when global_left < global_right, which covers every unordered
    pair exactly once across the ring; the operands are swapped so the
    left view is always the lower one.

    Returns (matches (size*size*B*B, M), pair_gid (size*size*B*B,)): every
    rank's slots in rank order, on every rank; pair_gid is left_view * V +
    right_view, or -1 for masked slots. ``ring_matches_to_matrix``
    assembles the match matrix."""
    V = features.num_views
    if V % mesh.size:
        raise ValueError(f"pad views ({V}) to a multiple of the mesh ({mesh.size})")
    B = V // mesh.size
    dev = features.desc.device
    streaming = _streaming(features)
    own = slice(mesh.rank * B, (mesh.rank + 1) * B)
    desc = (pallas_match.descriptor_signs(features.desc[own]) if streaming
            else features.desc[own])
    valid, gid = features.valid[own], torch.arange(V, device=dev)[own]
    ii = torch.arange(B, device=dev).repeat_interleave(B)
    jj = torch.arange(B, device=dev).repeat(B)
    visit = [desc, valid, gid]
    out = []
    for _ in range(mesh.size):
        d2, v2, g2 = visit
        gi, gj = gid[ii], g2[jj]
        swap = gi > gj
        da = torch.where(swap[:, None, None], d2[jj], desc[ii])
        va = torch.where(swap[:, None], v2[jj], valid[ii])
        db = torch.where(swap[:, None, None], desc[ii], d2[jj])
        vb = torch.where(swap[:, None], valid[ii], v2[jj])
        if streaming:
            best, second, bidx = pallas_match.match_topk2(da, db, vb)
            m = select_matches(best, second, bidx, va, ratio=ratio, max_matches=max_matches)
        else:
            m = match_pair(da, va, db, vb, ratio=ratio, max_matches=max_matches)
        keep = gi < gj
        out.append((m, keep, torch.where(keep, gi * V + gj, -1)))
        visit = mesh.shift(visit, "match_all_pairs_ring visiting block")
    local = Matches(idx=torch.cat([m.idx for m, _, _ in out]),
                    dist=torch.cat([m.dist for m, _, _ in out]),
                    valid=torch.cat([m.valid & keep[:, None] for m, keep, _ in out]))
    gids = torch.cat([g for _, _, g in out]).to(torch.int32)
    return (_gather_matches(mesh, local, "match_all_pairs_ring matches"),
            mesh.all_gather(gids, "match_all_pairs_ring pair ids"))


def ring_matches_to_matrix(matches: Matches, pair_gid, V: int):
    """Reassemble ring output into the canonical (P, M) match matrix
    ordered like [(i, j) for i in range(V) for j in range(i+1, V)].
    Returns numpy (idx (P, M, 2), dist (P, M), valid (P, M))."""
    pairs = [(i, j) for i in range(V) for j in range(i + 1, V)]
    row_of = {i * V + j: n for n, (i, j) in enumerate(pairs)}
    host = lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    gid, idx, dist, ok = (host(pair_gid), host(matches.idx), host(matches.dist),
                          host(matches.valid))
    M = idx.shape[1]
    out_idx = np.full((len(pairs), M, 2), -1, np.int32)
    out_dist = np.full((len(pairs), M), 1e9, np.float32)
    out_valid = np.zeros((len(pairs), M), bool)
    for slot, g in enumerate(gid):
        if g < 0 or int(g) not in row_of:
            continue
        r = row_of[int(g)]
        out_idx[r] = idx[slot]
        out_dist[r] = dist[slot]
        out_valid[r] = ok[slot]
    return out_idx, out_dist, out_valid
