"""Scale benchmarks on the port: matching pairs/s and bundle-adjustment LM
iterations/s. Counterpart of ``benchmarks/scale_bench.py``.

    python -m tpusfm_torch.tools.scale_bench [--device cpu] [--out PATH]

Three metrics, one JSON line each, at the reference's sizes:

  - ``match_pairs_per_s``: K1 (``features/pallas_match.py::match_topk2``,
    the CUDA kernel on the card, its plain version on the CPU) over 128 pairs
    of 5120 random ±1 int8 descriptors (D=256). Each repeat is timed with
    CUDA events around the launch and a dependent reduction, and ends in a
    read-back of that reduction;
  - ``ba_iterations_per_s``: ``dist.adjust_bundle_sharded`` on ``make_mesh()``
    (a world of one rank: NCCL on the card, gloo on the CPU) at 16,384 points
    x 32 cameras, each point seen by ~30% of the cameras, 20 LM iterations with
    no tolerance exit;
  - ``sparse_ba_iterations_per_s``: ``ba/sparse.py::lm_solve_sparse`` at 500
    cameras x 200,000 points x 800,000 observations (each point seen by four
    neighbouring cameras), 10 LM iterations of 24 CG steps.

Each rate divides the LM iterations the solve ran (the reference divides
the dense solve's budget) by the mean host-clock time of a repeat, which
ends in a synchronisation, after one untimed solve. The problems come from
``default_rng(0)`` in the reference's order of draws, built by
``matching_problem``, ``dense_problem`` and ``sparse_problem``; like the
reference, every dense solve draws fresh point noise from the problem's
generator (``benchmarks/scale_bench.py:97``), so each repeat solves from a
different start. The observations are noise-free, so both solves drive the
cost towards 0.

Every line carries the card (``nvidia-smi`` name and power limit). Written to
``--out`` only when one is given. Runs on the card; ``--device cpu``
rehearses at the small sizes of ``CPU_SIZES`` and measures nothing of the
device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# tests/fixtures.py's intrinsics, which the reference's problems use
FOCAL, PP = 700.0, (640.0, 480.0)


def _K(device) -> torch.Tensor:
    return torch.tensor([[FOCAL, 0.0, PP[0]], [0.0, FOCAL, PP[1]], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


# ---------------------------------------------------------------------- #
# matching
# ---------------------------------------------------------------------- #
def matching_problem(n_pairs: int = 128, F: int = 5120, D: int = 256, seed: int = 0,
                     device="cpu"):
    """The reference's ``sign(standard_normal)`` descriptors as int8 ±1,
    drawn one pair at a time (the same stream as one draw of the whole
    array), and an all-valid mask: (d1, d2, valid2) on ``device``."""
    rng = np.random.default_rng(seed)

    def draw():
        out = torch.empty(n_pairs, F, D, dtype=torch.int8, device=device)
        for p in range(n_pairs):
            out[p] = torch.from_numpy(np.sign(rng.standard_normal((F, D))).astype(np.int8))
        return out

    d1 = draw()
    d2 = draw()
    return d1, d2, torch.ones(n_pairs, F, dtype=torch.bool, device=device)


def bench_matching(n_pairs: int = 128, F: int = 5120, D: int = 256, repeats: int = 3,
                   device="cuda", problem=None):
    """``problem``: the (d1, d2, valid2) of ``matching_problem`` where the
    caller has made them already."""
    from tpusfm_torch.features.pallas_match import match_topk2

    d1, d2, v2 = problem if problem is not None else matching_problem(n_pairs, F, D,
                                                                      device=device)
    n_pairs, F = v2.shape
    on_card = torch.device(device).type == "cuda"

    def once():
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        best, second, _ = match_topk2(d1, d2, v2)
        red = best.sum() + second.sum()
        if on_card:
            end.record()
        float(red)                                  # the read-back ends the work
        return start.elapsed_time(end) / 1e3 if on_card else time.perf_counter() - t0

    once()
    dt = sum(once() for _ in range(repeats)) / repeats
    return {"metric": "match_pairs_per_s", "value": n_pairs / dt,
            "unit": f"pairs/s @ {F} feats", "detail": {"seconds_per_batch": dt,
                                                       "pairs": n_pairs}}


# ---------------------------------------------------------------------- #
# dense bundle adjustment, point-sharded over a mesh
# ---------------------------------------------------------------------- #
def dense_problem(n_points: int = 16384, n_cams: int = 32, n_dev: int = 1, seed: int = 0):
    """The reference's dense problem, numpy: (noisy poses (V,3,4), points
    (N,3), uv (N,V,2), mask (N,V), rng). The generator is left where a solve
    draws its point noise from it. N is padded to a multiple of ``n_dev``."""
    if n_points % n_dev:
        n_points += n_dev - n_points % n_dev
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-8, 8, n_points), rng.uniform(-6, 6, n_points),
                    rng.uniform(10, 40, n_points)], 1).astype(np.float32)
    poses = []
    for v in range(n_cams):
        th = 0.01 * v
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        poses.append(np.concatenate([R, np.array([[-0.1 * v], [0.0], [1.0]], np.float32)], 1))
    poses = np.stack(poses)
    uv = np.zeros((n_points, n_cams, 2), np.float32)
    for v in range(n_cams):
        pc = pts @ poses[v][:, :3].T + poses[v][:, 3]
        uv[:, v] = (pc[:, :2] / np.maximum(pc[:, 2:3], 1e-6)) * FOCAL + np.array(PP, np.float32)
    mask = rng.uniform(0, 1, (n_points, n_cams)) < 0.3   # each point seen by ~10 cameras
    noisy = poses + 0.002 * rng.standard_normal(poses.shape).astype(np.float32)
    return noisy, pts, uv, mask, rng


def bench_distributed_ba(n_points: int = 16384, n_cams: int = 32, iterations: int = 20,
                         repeats: int = 3, device="cuda", mesh=None):
    from tpusfm_torch.dist import adjust_bundle_sharded, make_mesh
    from tpusfm_torch.tools.common import synchronize

    mesh = mesh if mesh is not None else make_mesh(device=device)
    dev = mesh.device
    noisy, pts, uv, mask, rng = dense_problem(n_points, n_cams, mesh.size)
    T = lambda a: torch.as_tensor(a, device=dev)
    fixed = (T(noisy), torch.ones(n_cams, dtype=torch.bool, device=dev))
    obs = (torch.ones(len(pts), dtype=torch.bool, device=dev), T(uv), T(mask), _K(dev))

    def run():
        start = pts + 0.02 * rng.standard_normal(pts.shape).astype(np.float32)
        out = adjust_bundle_sharded(mesh, *fixed, T(start), *obs, max_iterations=iterations,
                                    function_tolerance=0.0)
        synchronize(dev)
        return out

    run()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = run()
    dt = (time.perf_counter() - t0) / repeats
    its = int(out[3].iterations)
    return {"metric": "ba_iterations_per_s", "value": its / dt,
            "unit": f"LM iters/s @ {len(pts)} pts x {n_cams} cams ({int(mask.sum())} obs, "
                    f"{mesh.size} rank)",
            "detail": {"seconds_per_solve": dt, "iterations": its,
                       "initial_cost": float(out[3].initial_cost),
                       "final_cost": float(out[3].final_cost)}}


# ---------------------------------------------------------------------- #
# COO bundle adjustment on one device
# ---------------------------------------------------------------------- #
def sparse_problem(n_cams: int = 500, n_points: int = 200_000, obs_per_pt: int = 4,
                   seed: int = 0, device="cpu"):
    """The reference's collection-scale COO problem as a
    ``ba.sparse.SparseBAProblem`` on ``device``."""
    from tpusfm_torch import camera
    from tpusfm_torch.ba.sparse import SparseBAProblem

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-40, 40, n_points), rng.uniform(-10, 10, n_points),
                    rng.uniform(20, 80, n_points)], 1).astype(np.float32)
    Rt = []
    for v in range(n_cams):
        th = 2 * np.pi * v / n_cams * 0.05
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        Rt.append(np.concatenate([R, np.array([[-0.08 * v], [0.0], [2.0]], np.float32)], 1))
    Rt = np.stack(Rt)
    # each point observed by obs_per_pt nearby cameras
    base = rng.integers(0, n_cams, n_points)
    cidx = ((base[:, None] + np.arange(obs_per_pt)[None, :]) % n_cams).ravel().astype(np.int32)
    pidx = np.repeat(np.arange(n_points, dtype=np.int32), obs_per_pt)
    pc = np.einsum("oij,oj->oi", Rt[cidx, :, :3], pts[pidx]) + Rt[cidx, :, 3]
    uv = (pc[:, :2] / np.maximum(pc[:, 2:], 1e-6)) * FOCAL + np.array(PP, np.float32)
    w = (pc[:, 2] > 0).astype(np.float32)

    T = lambda a, dtype=None: torch.as_tensor(a, dtype=dtype, device=device)
    rvecs = camera.matrix_to_rodrigues(T(Rt[:, :, :3]))
    cams6 = torch.cat([rvecs, T(Rt[:, :, 3])], 1)
    cams6 = cams6 + 0.001 * T(rng.standard_normal(tuple(cams6.shape)), torch.float32)
    K = _K(device)
    return SparseBAProblem(
        cams=cams6, points=T(pts + 0.01 * rng.standard_normal(pts.shape).astype(np.float32)),
        focal=K[0, 0], cam_idx=T(cidx).long(), pt_idx=T(pidx).long(),
        uv=T(uv, torch.float32) - K[:2, 2], w=T(w), cam_free=torch.ones(n_cams, device=device))


def bench_sparse_ba(n_cams: int = 500, n_points: int = 200_000, obs_per_pt: int = 4,
                    iterations: int = 10, cg_iterations: int = 24, repeats: int = 3,
                    device="cuda"):
    from tpusfm_torch.ba.sparse import lm_solve_sparse
    from tpusfm_torch.tools.common import synchronize

    prob = sparse_problem(n_cams, n_points, obs_per_pt, device=device)

    def solve():
        out = lm_solve_sparse(prob, max_iterations=iterations, function_tolerance=0.0,
                              cg_iterations=cg_iterations)
        synchronize(device)
        return out

    solve()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = solve()
    dt = (time.perf_counter() - t0) / repeats
    its = int(out[1].iterations)
    return {"metric": "sparse_ba_iterations_per_s", "value": its / dt,
            "unit": f"LM iters/s @ {n_cams} cams x {n_points} pts x {len(prob.cam_idx)} obs "
                    "(1 dev)",
            "detail": {"seconds_per_solve": dt, "iterations": its,
                       "initial_cost": float(out[1].initial_cost),
                       "final_cost": float(out[1].final_cost)}}


# the sizes of a CPU rehearsal
CPU_SIZES = dict(matching=dict(n_pairs=4, F=512), dense=dict(n_points=1024, n_cams=8),
                 sparse=dict(n_cams=40, n_points=4000))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from tpusfm_torch.tools.common import device_and_card

    device, card = device_and_card(args.device)
    sizes = CPU_SIZES if device.type == "cpu" else dict(matching={}, dense={}, sparse={})
    lines = []
    try:
        for fn, kw in ((bench_matching, sizes["matching"]), (bench_distributed_ba, sizes["dense"]),
                       (bench_sparse_ba, sizes["sparse"])):
            lines.append(json.dumps(dict(fn(device=device, **kw), card=card)))
            print(lines[-1], flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
