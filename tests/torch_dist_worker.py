"""One rank of the port's multi-rank checks on the CPU (gloo).

    python tests/torch_dist_worker.py INPUTS.npz OUT_DIR

Started by ``tpusfm_torch.dist.mesh.spawn`` (RANK, WORLD_SIZE, MASTER_ADDR
and MASTER_PORT in the environment) from ``tests/test_torch_dist.py``,
which writes the inputs and reads every rank's outputs back from
``OUT_DIR/w<world>_r<rank>.npz``. Imports numpy, torch and tpusfm_torch
only: what it computes is the port's alone.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tpusfm_torch.dist import (adjust_bundle_sharded, adjust_bundle_sparse_sharded,  # noqa: E402
                               initialize_distributed, make_mesh, match_all_pairs_ring,
                               match_all_pairs_sharded)
from tpusfm_torch.dist.mesh import spawned_coordinates  # noqa: E402
from tpusfm_torch.types import Features  # noqa: E402

torch.set_num_threads(1)

ITERS, FTOL = 120, 1e-8          # converged solves, as dryrun_multichip runs them
PIPELINE_WORLD = 2               # the 12-view collection runs on a mesh of this size


def features(d, prefix):
    V, F = d[prefix + "valid"].shape
    return Features(xy=torch.as_tensor(d[prefix + "xy"]), desc=torch.as_tensor(d[prefix + "desc"]),
                    score=torch.zeros(V, F), angle=torch.zeros(V, F),
                    valid=torch.as_tensor(d[prefix + "valid"]))


def dense_ba(mesh, d, iters, ftol):
    Rt, N, V = d["dense_Rt"], *d["dense_uv"].shape[:2]
    out = adjust_bundle_sharded(
        mesh, torch.as_tensor(Rt), torch.ones(V, dtype=torch.bool),
        torch.as_tensor(d["dense_pts"]), torch.ones(N, dtype=torch.bool),
        torch.as_tensor(d["dense_uv"]), torch.ones(N, V, dtype=torch.bool),
        torch.as_tensor(d["K"]), max_iterations=iters, function_tolerance=ftol)
    return out


def summary_numbers(prefix, s):
    return {prefix + "cost0": s.initial_cost.numpy(), prefix + "cost": s.final_cost.numpy(),
            prefix + "iters": s.iterations.numpy()}


def main(inputs: str, out_dir: str):
    coordinator, world, rank = spawned_coordinates()
    initialize_distributed(coordinator, world, rank, backend="gloo", device="cpu")
    try:
        mesh = make_mesh(device="cpu")
        assert (mesh.size, mesh.rank) == (world, rank)
        d = dict(np.load(inputs))
        out = {}

        Rt, pts, K, s = dense_ba(mesh, d, ITERS, FTOL)
        out.update(dense_Rt=Rt.numpy(), dense_pts=pts.numpy(), dense_K=K.numpy(),
                   **summary_numbers("dense_", s))
        for k in (1, 2):
            Rt, pts, _, _ = dense_ba(mesh, d, 10, 1e-6)
            out.update({f"det{k}_Rt": Rt.numpy(), f"det{k}_pts": pts.numpy()})

        V = d["coo_Rt"].shape[0]
        Rt, pts, K, s = adjust_bundle_sparse_sharded(
            mesh, torch.as_tensor(d["coo_Rt"]), torch.ones(V, dtype=torch.bool), d["coo_pts"],
            d["coo_cidx"], d["coo_pidx"], d["coo_uv"], d["coo_w"], torch.as_tensor(d["K"]),
            max_iterations=ITERS, function_tolerance=FTOL)
        out.update(coo_Rt=Rt.numpy(), coo_pts=pts.numpy(), coo_K=K.numpy(),
                   **summary_numbers("coo_", s))

        m = match_all_pairs_sharded(mesh, features(d, "match_"), d["match_pairs"],
                                    max_matches=128)
        out.update(match_idx=m.idx.numpy(), match_dist=m.dist.numpy(),
                   match_valid=m.valid.numpy())
        ring, gid = match_all_pairs_ring(mesh, features(d, "ring_"), ratio=0.95, max_matches=32)
        out.update(ring_idx=ring.idx.numpy(), ring_dist=ring.dist.numpy(),
                   ring_valid=ring.valid.numpy(), ring_gid=gid.numpy())

        if world == PIPELINE_WORLD:
            from tpusfm_torch import SfMConfig
            from tpusfm_torch.pipeline import CollectionPipeline
            from tpusfm_torch.tools.synthetic import make_collection
            from tpusfm_torch.types import Intrinsics

            imgs, _, Kc, _ = make_collection(n_views=12, n_dots=350, arc_degrees=45.0, seed=3)
            cfg = SfMConfig(max_features=768, max_matches=384, console_debug_level=5,
                            collection_window=4, ba_share_focal=False,
                            ba_incremental_iterations=10, ba_max_iterations=50,
                            min_point_count_for_homography=60)
            rec = CollectionPipeline(imgs, cfg, intrinsics=Intrinsics.create(
                float(Kc[0, 0]), float(Kc[0, 2]), float(Kc[1, 2])), mesh=mesh).run()
            out.update(pipe_poses=rec.poses, pipe_pose_valid=rec.pose_valid,
                       pipe_points=rec.num_points, pipe_reproj=rec.mean_reprojection_error,
                       pipe_ba_iters=rec.stats["ba_iters"])
        np.savez(os.path.join(out_dir, f"w{world}_r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
