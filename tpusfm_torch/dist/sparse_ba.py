"""Distributed sparse (COO) bundle adjustment over the mesh.

Counterpart of ``tpusfm/dist/sparse_ba.py``: the collection-scale
companion of ``dist/ba.py``, which shards the COO observation list of
``ba/sparse.py``. Points are block-sharded over the ranks, every
observation lives on its point's rank, and the cameras are replicated;
the per-matvec reductions into the camera blocks are summed over the ranks
(one ``all_reduce`` per CG matvec, plus one per gradient and cost
evaluation: ``ba/sparse.py``'s ``group``).

Host-side preparation (numpy, ``_group_for_mesh``) permutes the points
round-robin into contiguous shard blocks and pads each shard's observation
list to a common length with zero-weight rows (camera 0, the shard's point
0); then every rank runs the whole matrix-free LM solve on its block.
"""
from __future__ import annotations

import numpy as np
import torch

from tpusfm_torch import camera
from tpusfm_torch.ba.sparse import SparseBAProblem, lm_solve_sparse
from tpusfm_torch.dist.mesh import Mesh


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _group_for_mesh(n_dev: int, n_points: int, cam_idx, pt_idx, uv, w):
    """Permute points round-robin into shard blocks; group + pad obs.

    Returns (order (N,) slot -> old point, inv (N,) old point -> slot, and
    the observations' camera, shard-local point, uv and weight, padded per
    shard to one length and flattened back to one leading axis divisible by
    n_dev)."""
    if n_points % n_dev:
        raise ValueError(f"n_points ({n_points}) must divide the mesh ({n_dev})")
    n_local = n_points // n_dev
    order = np.argsort(np.arange(n_points) % n_dev, kind="stable")  # slot -> old
    inv = np.empty_like(order)
    inv[order] = np.arange(n_points)                                # old -> slot

    new_pt = inv[np.asarray(pt_idx)]
    shard = new_pt // n_local
    o_order = np.argsort(shard, kind="stable")
    counts = np.bincount(shard, minlength=n_dev)
    o_max = int(counts.max()) if len(cam_idx) else 1
    O_pad = o_max * n_dev
    ci = np.zeros(O_pad, np.int32)
    pi = np.zeros(O_pad, np.int32)
    uvp = np.zeros((O_pad, 2), np.float32)
    wp = np.zeros(O_pad, np.float32)
    start = 0
    for d in range(n_dev):
        sel = o_order[start:start + counts[d]]
        start += counts[d]
        base = d * o_max
        ci[base:base + len(sel)] = np.asarray(cam_idx)[sel]
        pi[base:base + len(sel)] = new_pt[sel] - d * n_local  # shard-local
        uvp[base:base + len(sel)] = np.asarray(uv)[sel]
        wp[base:base + len(sel)] = np.asarray(w)[sel]
    return order, inv, ci, pi, uvp, wp


def adjust_bundle_sparse_sharded(mesh: Mesh, poses_Rt, cam_valid, points, cam_idx, pt_idx, uv,
                                 obs_w, K, *, max_iterations: int = 50,
                                 function_tolerance: float = 1e-6, initial_lambda: float = 1e-3,
                                 share_focal: bool = True, cg_iterations: int = 32,
                                 huber_delta: float = 0.0):
    """Distributed equivalent of ``ba.sparse.adjust_bundle_sparse``: every rank
    passes the whole problem (poses (V,3,4), cam_valid (V,), points (N,3) with
    N a multiple of the mesh size, cam_idx/pt_idx (O,), raw pixel uv (O,2),
    weights (O,), K (3,3); arrays or tensors) and gets the same returns,
    replicated: (poses, points (N,3), K, summary). Frozen cameras keep their
    input poses."""
    dev = mesh.device
    n = int(points.shape[0])
    Kn = _np(K)
    order, inv, ci, pi, uvp, wp = _group_for_mesh(
        mesh.size, n, _np(cam_idx), _np(pt_idx), _np(uv) - Kn[:2, 2][None, :], _np(obs_w))
    n_local, o_local = n // mesh.size, len(ci) // mesh.size
    pts, obs = slice(mesh.rank * n_local, (mesh.rank + 1) * n_local), \
        slice(mesh.rank * o_local, (mesh.rank + 1) * o_local)
    on = lambda a, dtype=torch.float32: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                                         device=dev)
    poses_Rt, cam_valid, K = (torch.as_tensor(poses_Rt, device=dev),
                              torch.as_tensor(cam_valid, device=dev), on(Kn))
    rvecs = camera.matrix_to_rodrigues(poses_Rt[..., :3])
    prob = SparseBAProblem(
        cams=torch.cat([rvecs, poses_Rt[..., 3]], 1), points=on(_np(points)[order][pts]),
        focal=K[0, 0], cam_idx=on(ci[obs], torch.int64), pt_idx=on(pi[obs], torch.int64),
        uv=on(uvp[obs]), w=on(wp[obs]), cam_free=cam_valid.to(torch.float32))
    sol, summary = lm_solve_sparse(
        prob, max_iterations=max_iterations, function_tolerance=function_tolerance,
        initial_lambda=initial_lambda, share_focal=share_focal, cg_iterations=cg_iterations,
        huber_delta=huber_delta, group=mesh.group)
    R = camera.rodrigues_to_matrix(sol.cams[:, :3])
    out_Rt = torch.cat([R, sol.cams[:, 3:, None]], 2)
    out_Rt = torch.where(cam_valid[:, None, None], out_Rt, poses_Rt)
    newK = K.clone()
    newK[0, 0] = sol.focal
    newK[1, 1] = sol.focal
    out_pts = mesh.all_gather(sol.points, "adjust_bundle_sparse_sharded points")
    return out_Rt, out_pts[torch.as_tensor(inv, device=dev)], newK, summary
