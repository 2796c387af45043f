"""BASELINE config 5 probe on the port: a 5000-view sequence, partial run.
Counterpart of ``benchmarks/config5_partial.py``.

    python -m tpusfm_torch.tools.config5_partial [--views 5000] [--features 1024]
        [--matches 512] [--window 8] [--ba-iters 20] [--mesh N] [--device cpu] [--out PATH]

A whole incremental reconstruction at 5000 views is hours of wall clock;
what config 5 has to show is that the collection-scale layout holds there:
~40k window pairs through the streaming matcher (K1, one launch per chunk of
256 pairs), a track graph over ~5 million feature nodes, and one global COO
Schur-CG bundle adjustment with a Huber loss over the whole observation
list. The probe runs exactly those stages of ``CollectionPipeline``:

  1. render the textured ring (``tools/synthetic.py::make_collection_scene``,
     256x192) on the device;
  2. ``extract``, ``match`` (the epipolar prune included) with window 8 and
     wraparound, then ``build_tracks``;
  3. ``_retriangulate`` every track from the ground-truth poses, perturb the
     poses by 0.002 (``default_rng(0)``) and run one
     ``_ba(arange(V), global_ba=True, final=True)``. The CG depth caps for
     collections over 1000 views (``pipeline/collection.py``) apply as in the
     reference.

Stage 3 starts from the ground truth, so this is a probe of scale and
throughput, not of quality (``tools/collection_run.py`` covers that).

Prints one JSON object: pairs, tracks, tracks triangulated, observations
alive, BA iterations, initial and final cost, iterations/s, mean
reprojection error, peak host RSS (and device memory on the card), the
stage seconds, K1 launches and the card (``nvidia-smi`` name and power
limit). Written to ``--out`` only when one is given. ``--mesh N`` shards the
matching chunks and the global solve over N ranks (``dist.make_mesh``; N > 1
starts N processes of this tool, one per card, NCCL when each rank has a card,
else gloo), as the reference's ``--mesh`` does over its devices. Runs on the
card; ``--device cpu`` rehearses at a small ``--views``.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def probe_config(features: int = 1024, matches: int = 512, window: int = 8, ba_iters: int = 20):
    from tpusfm_torch import SfMConfig

    return SfMConfig(max_features=features, max_matches=matches, collection_window=window,
                     collection_wraparound=True, ba_share_focal=False, console_debug_level=1,
                     ba_max_iterations=ba_iters)


def run(views: int = 5000, features: int = 1024, matches: int = 512, window: int = 8,
        ba_iters: int = 20, device="cuda", mesh=None, card: str = "") -> dict:
    import torch

    from tpusfm_torch.features import pallas_match
    from tpusfm_torch.pipeline import CollectionPipeline
    from tpusfm_torch.tools.synthetic import make_collection_scene
    from tpusfm_torch.types import Intrinsics

    device = mesh.device if mesh is not None else torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    launches = pallas_match.match_topk2.launches
    stage = {}
    t0 = time.perf_counter()
    imgs, poses_gt, K = make_collection_scene(n_views=views, device=device)
    stage["render_s"] = time.perf_counter() - t0
    print(f"# rendered {views} views in {stage['render_s']:.3f}s", flush=True)

    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
    pipe = CollectionPipeline(imgs, probe_config(features, matches, window, ba_iters),
                              intrinsics=intr, mesh=mesh, device=device)
    pipe.extract()
    pipe.match()          # the epipolar prune included
    pipe.build_tracks()
    stage.update(pipe._timings)

    # ---- triangulate every track from the ground truth, then one global BA
    t1 = time.perf_counter()
    pipe.poses = poses_gt.copy()
    pipe.pose_valid[:] = True
    n_tri = pipe._retriangulate()
    stage["triangulate_s"] = time.perf_counter() - t1
    print(f"# triangulated {n_tri} tracks ({stage['triangulate_s']:.3f}s)", flush=True)

    rng = np.random.default_rng(0)
    pipe.poses = (poses_gt + 0.002 * rng.standard_normal(poses_gt.shape)).astype(np.float32)
    t2 = time.perf_counter()
    pipe._ba(np.arange(pipe.V), global_ba=True, final=True)
    stage["global_ba_s"] = time.perf_counter() - t2
    ba_iters_run, cost0, cost1 = pipe._last_ba
    out = {
        "config": f"BASELINE config 5 partial probe ({views} views)",
        "card": card,
        "ranks": mesh.size if mesh is not None else 1,
        "views": views,
        "pairs": int(len(pipe.pairs)),
        "tracks": int(pipe.T),
        "tracks_triangulated": int(pipe.track_ok.sum()),
        "observations": int(pipe.obs_alive.sum()),
        "ba_iterations": int(ba_iters_run),
        "ba_initial_cost": cost0,
        "ba_final_cost": cost1,
        "ba_iterations_per_s": ba_iters_run / max(stage["global_ba_s"], 1e-9),
        "cg_iterations_final": pipe._final_cg,
        "mean_reprojection_px": float(pipe.mean_reprojection_error()),
        "peak_host_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
        "match_top2_launches": pallas_match.match_topk2.launches - launches,
        "stage_s": stage,
        "total_s": time.perf_counter() - t0,
    }
    if on_card:
        out["peak_device_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=5000)
    ap.add_argument("--features", type=int, default=1024)
    ap.add_argument("--matches", type=int, default=512)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--ba-iters", type=int, default=20)
    ap.add_argument("--mesh", type=int, default=0, help="ranks to shard over (0: no mesh)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=7200.0,
                    help="seconds the ranks of --mesh N > 1 may take together")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from tpusfm_torch.dist import initialize_distributed, make_mesh
    from tpusfm_torch.dist.mesh import spawn, spawned_coordinates
    from tpusfm_torch.tools.common import device_and_card

    if args.mesh > 1 and "RANK" not in os.environ:
        outs = spawn([sys.executable, "-m", "tpusfm_torch.tools.config5_partial"]
                     + (argv if argv is not None else sys.argv[1:]), args.mesh,
                     timeout=args.timeout, cwd=_REPO)
        print(outs[0], end="", flush=True)
        return 0
    device, card = device_and_card(args.device)
    mesh = None
    if args.mesh:
        if "RANK" in os.environ:
            backend = ("nccl" if device.type == "cuda"
                       and torch.cuda.device_count() >= args.mesh else "gloo")
            initialize_distributed(*spawned_coordinates(), backend=backend, device=args.device)
        mesh = make_mesh(args.mesh, device=args.device)
    try:
        out = run(args.views, args.features, args.matches, args.window, args.ba_iters, device,
                  mesh, card)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if mesh is None or mesh.rank == 0:
        text = json.dumps(out, indent=1)
        print(text, flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
