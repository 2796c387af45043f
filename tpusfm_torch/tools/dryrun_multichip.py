"""Dry run of the distributed stack on a mesh of ranks, with proofs.

    python -m tpusfm_torch.tools.dryrun_multichip [--world N] [--device cuda|cpu]

The port's counterpart of ``__graft_entry__.py::dryrun_multichip``, with
its fixtures, sizes and tolerances. On a mesh of N ranks (N processes
started here and joined on a free local port; N = 1 is this process) it

  1. matches the 6 pairs of 4 noise images (128 features, 64 matches,
     padded to a multiple of N) sharded over the mesh, and holds them to
     the unsharded matcher bit for bit;
  2. runs the dense-grid distributed BA on noisy observations (0.4 px, so
     the optimum's cost is not zero) to convergence (at most 120 LM
     iterations, function tolerance 1e-8) and holds it to one process:
     final cost within 5%, camera centres within 2e-3 after similarity
     alignment;
  3. the same for the COO distributed BA;
  4. reconstructs the 10-view dot collection (``tools/synthetic.py::
     make_collection``, 300 dots over a 40 degree arc) through
     ``CollectionPipeline`` with the mesh and without it: >= 8 cameras each,
     < 2 px, and the two runs' aligned camera centres within 0.1 (1% of
     the arc).

Every rank runs every check (SPMD); rank 0 prints the summary lines and a
JSON line of the numbers (the two collection runs' ``total_s`` and
``matching_s``, and the collectives staged through the host). A failed
check or rank exits non-zero. Ranks use NCCL on ``cuda`` when each has a
card of its own, gloo otherwise (the CPU, or more ranks than cards).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from tpusfm_torch import SfMConfig
from tpusfm_torch.ba import adjust_bundle
from tpusfm_torch.ba.sparse import adjust_bundle_sparse
from tpusfm_torch.dist import (adjust_bundle_sharded, adjust_bundle_sparse_sharded,
                               initialize_distributed, make_mesh, match_all_pairs_sharded)
from tpusfm_torch.dist.mesh import Mesh, spawn, spawned_coordinates
from tpusfm_torch.eval import ate_rmse
from tpusfm_torch.features import extract_features
from tpusfm_torch.features.match import match_all_pairs
from tpusfm_torch.pipeline import CollectionPipeline
from tpusfm_torch.tools.synthetic import make_collection
from tpusfm_torch.types import Intrinsics

ITERS = 120         # converged solves: a fixed mid-descent step count is not comparable
FTOL = 1e-8
POSE_TOL = 2e-3
COST_RTOL = 0.05
E2E_ATE = 0.1
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def run(mesh: Mesh) -> dict:
    """The four checks on ``mesh``; returns the numbers they read."""
    n, dev = mesh.size, mesh.device
    T = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    rng = np.random.default_rng(0)

    # --- pair-sharded matching on tiny images ---
    V = 4
    imgs = rng.uniform(0, 1, (V, 64, 96)).astype(np.float32)
    feats = extract_features(T(imgs), max_features=128, pyramid_levels=1)
    pairs = [(i, j) for i in range(V) for j in range(i + 1, V)]
    pairs += [(0, 1)] * (-len(pairs) % n)
    m = match_all_pairs_sharded(mesh, feats, pairs, max_matches=64)
    want = match_all_pairs(feats, T(pairs).long(), max_matches=64)
    _check(all(torch.equal(a, b) for a, b in ((m.idx, want.idx), (m.valid, want.valid),
                                                (m.dist, want.dist))),
           f"{n}-rank matching differs from the unsharded matcher")

    # --- BA fixture: noisy observations (converged cost must be > 0) ---
    n_pts = max(8 * n, 32)
    n_pts += -n_pts % n
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(8, 20, n_pts)], 1).astype(np.float32)
    f, cx, cy = 500.0, 48.0, 32.0
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32)
    poses = []
    for v in range(V):
        c, s = np.cos(0.05 * v), np.sin(0.05 * v)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        poses.append(np.concatenate([R, np.array([[-0.5 * v], [0.0], [0.1 * v]], np.float32)],
                                    1))
    poses = np.stack(poses)
    uv = np.zeros((n_pts, V, 2), np.float32)
    for v in range(V):
        pc = pts @ poses[v][:, :3].T + poses[v][:, 3]
        uv[:, v] = (pc[:, :2] / pc[:, 2:3]) * f + np.array([cx, cy], np.float32)
    uv += rng.normal(0.0, 0.4, uv.shape).astype(np.float32)
    noisy = poses + 0.01 * rng.standard_normal(poses.shape).astype(np.float32)
    pts0 = (pts + 0.05 * rng.standard_normal(pts.shape)).astype(np.float32)
    cam_ok, pt_ok = T(np.ones(V, bool)), T(np.ones(n_pts, bool))
    kw = dict(max_iterations=ITERS, function_tolerance=FTOL)
    out = {}

    def same_optimum(what, got, ref):
        cost, cost_ref = float(got[3].final_cost), float(ref[3].final_cost)
        delta = ate_rmse(got[0].cpu().numpy(), ref[0].cpu().numpy())
        _check(cost > 0.0, f"{what}: zero cost on a noisy fixture (a sign error could hide)")
        _check(abs(cost - cost_ref) / cost_ref < COST_RTOL,
               f"{what} {n}-rank cost {cost} != 1-process {cost_ref}")
        _check(delta < POSE_TOL, f"{what} aligned pose rmse {delta}")
        out[what] = dict(initial_cost=float(got[3].initial_cost), cost=cost, cost_1=cost_ref,
                         iterations=int(got[3].iterations),
                         iterations_1=int(ref[3].iterations), pose_rmse=delta)

    # --- dense-grid distributed BA vs one process ---
    dense = (T(noisy), cam_ok, T(pts0), pt_ok, T(uv), T(np.ones((n_pts, V), bool)), T(K))
    same_optimum("dense", adjust_bundle_sharded(mesh, *dense, **kw), adjust_bundle(*dense, **kw))

    # --- COO distributed BA vs one process ---
    cidx = np.tile(np.arange(V, dtype=np.int32), n_pts)
    pidx = np.repeat(np.arange(n_pts, dtype=np.int32), V)
    uv_coo, w_coo = uv[pidx, cidx], np.ones(len(cidx), np.float32)
    same_optimum("coo", adjust_bundle_sparse_sharded(mesh, T(noisy), cam_ok, pts0, cidx, pidx,
                                                     uv_coo, w_coo, T(K), **kw),
                 adjust_bundle_sparse(T(noisy), cam_ok, T(pts0), T(cidx).long(), T(pidx).long(),
                                      T(uv_coo), T(w_coo), T(K), **kw))

    # --- end to end: the same collection with and without the mesh ---
    imgs2, _, K2, _ = make_collection(n_views=10, n_dots=300, arc_degrees=40.0, seed=3)
    cfg = SfMConfig(max_features=512, max_matches=256, console_debug_level=5,
                    collection_window=4, ba_share_focal=False, ba_incremental_iterations=8,
                    ba_max_iterations=200, ba_function_tolerance=1e-8,
                    min_point_count_for_homography=50)
    intr = Intrinsics.create(float(K2[0, 0]), float(K2[0, 2]), float(K2[1, 2]), device=dev)
    recs = {}
    for name, m in (("mesh", mesh), ("1dev", None)):
        rec = CollectionPipeline(imgs2, cfg, mesh=m, intrinsics=intr, device=dev).run()
        _check(int(rec.pose_valid.sum()) >= 8, f"e2e ({name}) registered too few cameras")
        _check(rec.mean_reprojection_error < 2.0, f"e2e ({name}) reprojection "
                                                  f"{rec.mean_reprojection_error}")
        recs[name] = rec
    both = recs["mesh"].pose_valid & recs["1dev"].pose_valid
    _check(int(both.sum()) >= 8, "mesh and 1-process runs registered different views")
    ate = ate_rmse(recs["mesh"].poses[both], recs["1dev"].poses[both])
    _check(ate < E2E_ATE, f"e2e 1-vs-{n} ATE {ate}")
    rec = recs["mesh"]
    out["e2e"] = dict(cameras=int(rec.pose_valid.sum()), points=rec.num_points,
                      reprojection_px=rec.mean_reprojection_error, ate_1_vs_n=ate,
                      **{f"{k}_{name}": r.stats[k] for name, r in recs.items()
                         for k in ("total_s", "matching_s", "global_ba_s")})
    out["staged_collectives"] = dict(mesh.staged)
    return out


def summary_lines(n: int, out: dict) -> str:
    """The summary lines of __graft_entry__.py::dryrun_multichip."""
    d, c, e = out["dense"], out["coo"], out["e2e"]
    return (f"dryrun_multichip({n}): matching + distributed BA + e2e OK\n"
            f"  dense-grid BA cost {d['initial_cost']:.3f} -> {d['cost']:.3f} ({n}-dev) vs "
            f"{d['cost_1']:.3f} (1-dev), aligned pose rmse {d['pose_rmse']:.2e}\n"
            f"  sparse-COO BA cost {c['initial_cost']:.3f} -> {c['cost']:.3f} ({n}-dev) vs "
            f"{c['cost_1']:.3f} (1-dev), aligned pose rmse {c['pose_rmse']:.2e}\n"
            f"  e2e collection: {e['cameras']}/10 cameras, {e['points']} points, "
            f"{e['reprojection_px']:.3f}px reprojection, 1-vs-{n} ATE {e['ate_1_vs_n']:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=1, help="ranks in the mesh")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=1200.0,
                    help="seconds the ranks may take together")
    args = ap.parse_args(argv)
    if args.world > 1 and "RANK" not in os.environ:
        outs = spawn([sys.executable, "-m", "tpusfm_torch.tools.dryrun_multichip",
                      "--world", str(args.world), "--device", args.device],
                     args.world, timeout=args.timeout, cwd=_REPO)
        print(outs[0], end="", flush=True)
        return 0
    backend = ("nccl" if args.device == "cuda" and torch.cuda.device_count() >= args.world
               else "gloo")
    spawned = "RANK" in os.environ
    if spawned:
        initialize_distributed(*spawned_coordinates(), backend=backend, device=args.device)
    owned = spawned or not dist.is_initialized()   # else the caller's world of one
    try:
        mesh = make_mesh(args.world, device=args.device)
        out = run(mesh)
        if mesh.rank == 0:
            print(summary_lines(mesh.size, out), flush=True)
            print(json.dumps(dict(out, world=mesh.size, backend=dist.get_backend(mesh.group),
                                  device=str(mesh.device))), flush=True)
    finally:
        if owned:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
