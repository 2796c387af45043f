"""Distributed bundle adjustment: point-sharded Schur reduction.

Counterpart of ``tpusfm/dist/ba.py``. The point axis is block-sharded
over the mesh's ranks: each rank owns N / size points and all their
observations, reduces them into its partial (6V+3)-dim camera and
intrinsics system, and ``all_reduce`` forms the global one
(``ba/lm.py``'s ``group``). The solve of that small system is replicated,
the point back-substitution stays local, and the whole LM loop, damping,
accept/reject and convergence, runs on every rank alike.
"""
from __future__ import annotations

import torch

from tpusfm_torch import camera
from tpusfm_torch.ba.lm import BAProblem, lm_solve
from tpusfm_torch.dist.mesh import Mesh


def _point_block(mesh: Mesh, n: int) -> slice:
    """This rank's block of ``n`` points (``n`` a multiple of the mesh size)."""
    if n % mesh.size:
        raise ValueError(f"pad points ({n}) to a multiple of the mesh ({mesh.size})")
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def adjust_bundle_sharded(mesh: Mesh, poses_Rt, cam_valid, points, pt_valid, uv, obs_mask, K, *,
                          max_iterations: int = 50, function_tolerance: float = 1e-6,
                          share_focal: bool = True):
    """Distributed equivalent of ``ba.adjust_bundle``, with the same arguments
    (every rank passes the whole problem: poses (V,3,4), cam_valid (V,),
    points (N,3) with N a multiple of the mesh size, pt_valid (N,),
    uv (N,V,2) raw pixels, obs_mask (N,V), K (3,3)) and the same returns,
    replicated on every rank: (poses, points (N,3), K, summary)."""
    dev = mesh.device
    blk = _point_block(mesh, points.shape[0])
    poses_Rt, K = poses_Rt.to(dev), K.to(dev)
    rvecs = camera.matrix_to_rodrigues(poses_Rt[..., :3])
    prob = BAProblem(cams=torch.cat([rvecs, poses_Rt[..., 3]], 1), points=points[blk].to(dev),
                     focal=K[0, 0], uv=(uv[blk].to(dev) - K[:2, 2]), mask=obs_mask[blk].to(dev),
                     cam_valid=cam_valid.to(dev), pt_valid=pt_valid[blk].to(dev))
    sol, summary = lm_solve(prob, max_iterations=max_iterations,
                            function_tolerance=function_tolerance, share_focal=share_focal,
                            group=mesh.group)
    R = camera.rodrigues_to_matrix(sol.cams[:, :3])
    out_Rt = torch.cat([R, sol.cams[:, 3:, None]], 2)
    newK = K.clone()
    newK[0, 0] = sol.focal
    newK[1, 1] = sol.focal
    return out_Rt, mesh.all_gather(sol.points, "adjust_bundle_sharded points"), newK, summary
