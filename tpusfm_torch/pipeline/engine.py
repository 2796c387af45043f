"""Fused device-resident incremental SfM engine.

Counterpart of ``tpusfm/pipeline/engine.py``. The whole incremental state
machine — baseline-pair selection, the add-view loop, 2D-3D lookup, cloud
merging and per-view bundle adjustment — runs on the device over
fixed-shape masked state; every acceptance gate is a ``torch.where`` and a
failed gate routes its writes to a trash row/column instead of branching.

Track graph on the device:
  xyz        (CAP+1, 3)  map points; row CAP is a write-trash row
  obs        (CAP+1, V)  feature index of point n in view v, -1 sentinel
  feat2point (V, F+1)    inverse map; column F is a write-trash column
  n_points   ()          live prefix length (points only ever append)

``vmap`` becomes an explicit batch axis (pairs for prune/ranking, views
for triangulation) and ``lax.scan``/``fori_loop``/``while_loop`` become
Python loops. Host syncs: one per baseline candidate and one per LM
iteration of the baseline and final bundle adjustments; the V-2 add-view
steps read nothing back (their LM loops run a fixed budget with the
solution frozen once converged).

On CUDA the add-view steps replay one CUDA graph of ``_step`` (the
``fori_loop`` body: fixed shapes, no host sync), captured by the port's
one graph runner (``utils/cuda_graph.py``) once per process for each key
of what a capture bakes in (``_step_graph_key``: the device, the inputs'
shapes and dtypes, the whole ``SfMConfig``, the principal point and the
float32 matmul settings) on the engine's card, and kept in a
process-level cache, since every job builds a new engine. The graph reads
the job's inputs and the state from static buffers and writes the new
state back into them, so the V-2 steps are V-2 replays with only the
generator's reseed in between. On the CPU the steps run ``_step``
eagerly; it is the one statement of the step's mathematics either way.

Randomness: one ``torch.Generator`` per stage, seeded from the run seed
and a stage path (the JAX engine's ``fold_in`` chain). Where two writes
land on one cell, the winner is chosen deterministically: the lowest left
index for the right->left lookup, the last writer (highest match slot)
in the merge, as XLA's sequential CPU scatter does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpusfm_torch import camera
from tpusfm_torch.ba.lm import BAProblem, lm_solve
from tpusfm_torch.config import EssentialDecomposition, SfMConfig
from tpusfm_torch.geometry.essential import (
    epipolar_inliers,
    essential_from_poses,
    find_camera_from_match,
    sampson_error,
)
from tpusfm_torch.geometry.homography import find_homography_inliers
from tpusfm_torch.geometry.pnp import find_camera_pose_2d3d
from tpusfm_torch.geometry.triangulation import triangulate_views
from tpusfm_torch.ransac import adaptive_num_hypotheses
from tpusfm_torch.utils.cuda_graph import Graph, GraphCache, graph_key
from tpusfm_torch.utils.profiling import stage

_INF = float("inf")
# uint8 level -> [0, 1] as the correctly rounded quotient k / 255. CUDA
# divides a tensor by a scalar as a product with its reciprocal, which moves
# half the levels by an ulp and flips FAST's exact ties at its threshold.
_U8_TO_UNIT = np.arange(256, dtype=np.float32) / np.float32(255.0)

# stats row layout (one row per registration attempt; row 0 = baseline)
S_VIEW, S_N2D3D, S_RATIO, S_OK, S_NEW, S_MERGED, S_DROPPED, S_BA0, S_BA1, S_BAIT = range(10)
_STATS_COLS = 10


class EngineState(NamedTuple):
    xyz: torch.Tensor          # (CAP+1, 3)
    obs: torch.Tensor          # (CAP+1, V) int64
    feat2point: torch.Tensor   # (V, F+1) int64
    n_points: torch.Tensor     # () int64
    poses: torch.Tensor        # (V, 3, 4)
    pose_valid: torch.Tensor   # (V,) bool
    done: torch.Tensor         # (V,) bool
    good: torch.Tensor         # (V,) bool
    focal: torch.Tensor        # () f32
    stats: torch.Tensor        # (V+1, _STATS_COLS) f32


def _state_where(pred, a: EngineState, b: EngineState) -> EngineState:
    return EngineState(*(torch.where(pred, x, y) for x, y in zip(a, b)))


def _set_last_writer(x: torch.Tensor, index: tuple, values: torch.Tensor,
                     trash: tuple) -> torch.Tensor:
    """x.index_put(index, values) where, among writes to one cell, the last
    (highest position) wins; the losers are routed to the ``trash`` cell.
    Deterministic on every device (index_put with duplicates is not)."""
    flat = sum(i * s for i, s in zip(torch.broadcast_tensors(*index), x.stride())).reshape(-1)
    order = torch.arange(flat.numel(), device=x.device)
    winner = torch.full((x.numel(),), -1, dtype=torch.int64, device=x.device)
    winner = winner.scatter_reduce(0, flat, order, "amax")
    trash_flat = sum(int(t) * int(s) for t, s in zip(trash, x.stride()))
    flat = torch.where(winner[flat] == order, flat, trash_flat)
    vals = values.broadcast_to(torch.broadcast_shapes(*(i.shape for i in index))).reshape(-1)
    return x.reshape(-1).index_put((flat,), vals.to(x.dtype)).reshape(x.shape)


class FusedEngine:
    """Runs the device-resident reconstruction for one (V, H, W, config)."""

    def __init__(self, cfg: SfMConfig, V: int, H: int, W: int,
                 f: float, cx: float, cy: float, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.V, self.H, self.W = V, H, W
        self.F = cfg.max_features
        self.CAP = cfg.engine_point_capacity
        self.PNP_CAP = min(cfg.engine_pnp_capacity, self.F)
        self.f0, self.cx, self.cy = float(f), float(cx), float(cy)
        self.E_HYP = max(cfg.ransac_hypotheses,
                         adaptive_num_hypotheses(0.75, 8, cfg.essential_prob))
        self.PNP_HYP = max(cfg.pnp_hypotheses,
                           adaptive_num_hypotheses(0.6, 6, cfg.pnp_confidence))
        pairs = [(i, j) for i in range(V) for j in range(i + 1, V)]
        self.pairs_list = pairs
        self.P = len(pairs)
        self._pairs = torch.tensor(pairs, dtype=torch.int64, device=self.device)
        pr = np.full((V, V), self.P, np.int64)                  # trash row P
        for n, (a, b) in enumerate(pairs):
            pr[a, b] = n
        self._pair_row = torch.as_tensor(pr, device=self.device)
        self._pp = torch.tensor([self.cx, self.cy], dtype=torch.float32, device=self.device)
        self.timings = {}

    # ------------------------------------------------------------------ #
    @staticmethod
    def _seed(seed: int, *path: int) -> int:
        return int(np.random.SeedSequence([seed, *path]).generate_state(1)[0])

    def _generator(self, seed: int, *path: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self._seed(seed, *path))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _K(self, focal):
        z = torch.zeros_like(focal)
        o = torch.ones_like(focal)
        return torch.stack([torch.stack([focal, z, z + self.cx]),
                            torch.stack([z, focal, z + self.cy]),
                            torch.stack([z, z, o])])

    def _Kinv(self, focal):
        z = torch.zeros_like(focal)
        o = torch.ones_like(focal)
        inv_f = 1.0 / focal
        return torch.stack([torch.stack([inv_f, z, -self.cx * inv_f]),
                            torch.stack([z, inv_f, -self.cy * inv_f]),
                            torch.stack([z, z, o])])

    def _pair_uv(self, feat_xy, match_idx, p):
        """Aligned (uv_a, uv_b) (..., M, 2) for pair rows p (...) in a < b order."""
        idx = match_idx[p]
        a = self._pairs[p, 0]
        b = self._pairs[p, 1]
        uv_a = feat_xy[a[..., None], torch.clamp(idx[..., 0], min=0)]
        uv_b = feat_xy[b[..., None], torch.clamp(idx[..., 1], min=0)]
        return uv_a, uv_b

    # ------------------------------------------------------------------ #
    # match lookups, homography ranking, epipolar prune
    # ------------------------------------------------------------------ #
    def build_lookup(self, match_idx, match_valid, match_dist):
        """right_of/rdist[p, lf] and left_of[p, rf] lookups; row P and column
        F are trash. Two left features matched to one right feature: the
        lowest left index wins left_of."""
        P, F, dev = self.P, self.F, self.device
        rows = torch.arange(P, device=dev)[:, None]
        lf = torch.where(match_valid, match_idx[..., 0], F)
        rf = torch.where(match_valid, match_idx[..., 1], F)
        right_of = torch.full((P + 1, F + 1), -1, dtype=torch.int64, device=dev)
        right_of = right_of.index_put((rows, lf), torch.where(match_valid, match_idx[..., 1], -1))
        rdist = torch.full((P + 1, F + 1), 1e9, dtype=torch.float32, device=dev)
        rdist = rdist.index_put((rows, lf), torch.where(match_valid, match_dist, 1e9))
        flat = (rows * (F + 1) + rf).reshape(-1)
        left = torch.full(((P + 1) * (F + 1),), F + 1, dtype=torch.int64, device=dev)
        left = left.scatter_reduce(0, flat, torch.where(match_valid, match_idx[..., 0],
                                                        F + 1).reshape(-1), "amin")
        left_of = torch.where(left > F, -1, left).reshape(P + 1, F + 1)
        left_of[:, F] = -1
        return right_of, rdist, left_of

    def homography_counts(self, gen, feat_xy, match_idx, match_valid):
        uv1, uv2 = self._pair_uv(feat_xy, match_idx, torch.arange(self.P, device=self.device))
        cnt, _, _ = find_homography_inliers(gen, uv1, uv2, match_valid,
                                            threshold_px=self.cfg.ransac_threshold_px,
                                            hypotheses=self.cfg.ransac_hypotheses // 4)
        return cnt

    def prune_all(self, gen, feat_xy, match_idx, match_valid, focal):
        uv1, uv2 = self._pair_uv(feat_xy, match_idx, torch.arange(self.P, device=self.device))
        inl = epipolar_inliers(gen, uv1, uv2, match_valid, self._K(focal), self._Kinv(focal),
                               threshold_px=self.cfg.epipolar_prune_threshold_px,
                               hypotheses=self.cfg.epipolar_prune_hypotheses)
        # only prune pairs with enough matches for the 8-point solver
        return torch.where((match_valid.sum(-1) >= 16)[:, None], inl & match_valid, match_valid)

    # ------------------------------------------------------------------ #
    # on-device cloud merge (SfM::mergeNewPointCloud, SfM.cpp:530-629)
    # ------------------------------------------------------------------ #
    def _merge_points(self, st: EngineState, xyz_new, keep, vi, vj, fi, fj,
                      right_of, rdist, left_of, feat_xy):
        """Merge freshly triangulated points (M, 3) of views (vi, vj) with
        features (fi, fj) into the map: extend a claimed track, attach to a
        close point confirmed by a 2-D match, drop a close unconfirmed one,
        else append. With cross-view strengthening, a point whose feature
        matches (through a hop view) a feature already in the map, and
        reprojects within the gate in both views, attaches to that point.
        Returns (state, n_new, n_attached, n_dropped)."""
        cfg = self.cfg
        V, CAP, F, dev = self.V, self.CAP, self.F, self.device
        # view indices as 1-element tensors: indexing with a 0-d CUDA tensor
        # reads it back to the host, a 1-element index does not
        vi, vj = vi.reshape(1), vj.reshape(1)
        live = torch.arange(CAP + 1, device=dev) < st.n_points

        d2 = ((xyz_new[:, None, :] - st.xyz[None, :, :]) ** 2).sum(-1)      # (M, CAP+1)
        d2 = torch.where(live[None, :], d2, _INF)
        ne = d2.argmin(1)
        close = d2.gather(1, ne[:, None])[:, 0] < cfg.merge_point_min_match_distance ** 2
        obs_ne = st.obs[ne]                                                  # (M, V)
        w = torch.arange(V, device=dev)

        def confirm(v_new, f_new):
            p = self._pair_row[torch.minimum(v_new, w), torch.maximum(v_new, w)]   # (V,)
            new_is_left = (v_new < w)[None, :]
            lf = torch.where(new_is_left, f_new[:, None], obs_ne)
            rf = torch.where(new_is_left, obs_ne, f_new[:, None])
            lf_s = torch.clamp(lf, 0, F)
            hit = ((obs_ne >= 0) & (w != v_new)[None, :]
                   & (right_of[p[None, :], lf_s] == rf)
                   & (rdist[p[None, :], lf_s] < cfg.merge_feature_min_match_distance))
            return hit.any(1)

        confirmed = confirm(vi, fi) | confirm(vj, fj)
        pi = st.feat2point[vi, torch.clamp(fi, 0, F)]
        pj = st.feat2point[vj, torch.clamp(fj, 0, F)]

        trans = torch.full_like(fi, -1)
        if cfg.cross_view_strengthen:
            def partner_all(v_new, f_new):
                p = self._pair_row[torch.minimum(v_new, w), torch.maximum(v_new, w)][None, :]
                fsafe = torch.clamp(f_new, 0, F)[:, None]
                new_is_left = (v_new < w)[None, :]
                fw = torch.where(new_is_left, right_of[p, fsafe], left_of[p, fsafe])
                d = torch.where(new_is_left, rdist[p, fsafe], rdist[p, torch.clamp(fw, 0, F)])
                fw = torch.where((v_new == w)[None, :], -1, fw)
                p3d = st.feat2point[w[None, :], torch.clamp(fw, 0, F)]
                hit = ((fw >= 0) & (p3d >= 0) & ((w != vi) & (w != vj))[None, :]
                       & (d < cfg.strengthen_max_match_distance))
                return p3d, hit

            p3d_i, hit_i = partner_all(vi, fi)
            p3d_j, hit_j = partner_all(vj, fj)
            uv_i = feat_xy[vi, torch.clamp(fi, 0, F - 1)]
            uv_j = feat_xy[vj, torch.clamp(fj, 0, F - 1)]
            g2 = cfg.min_reprojection_error ** 2

            def reproj_ok(p3d):
                X = st.xyz[torch.clamp(p3d, 0, CAP)]                          # (M, V, 3)

                def err(Rt, uv):
                    pc = X @ Rt[:, :3].T + Rt[:, 3]
                    z = pc[..., 2:3]
                    pr = pc[..., :2] / torch.where(z.abs() < 1e-9, 1e-9, z) * st.focal + self._pp
                    return ((pr - uv[:, None, :]) ** 2).sum(-1), pc[..., 2]

                e_i, z_i = err(st.poses[vi][0], uv_i)
                e_j, z_j = err(st.poses[vj][0], uv_j)
                return (e_i < g2) & (e_j < g2) & (z_i > 0) & (z_j > 0)

            hit = torch.stack([hit_i & reproj_ok(p3d_i), hit_j & reproj_ok(p3d_j)],
                              2).reshape(-1, 2 * V)
            p3d = torch.stack([p3d_i, p3d_j], 2).reshape(-1, 2 * V)
            first = hit.to(torch.int32).argmax(1)                              # first hit
            trans = torch.where(hit.any(1), p3d.gather(1, first[:, None])[:, 0], -1)

        has_known = (pi >= 0) | (pj >= 0) | (trans >= 0)
        known = torch.where(pi >= 0, pi, torch.where(pj >= 0, pj, trans))
        attach = keep & (has_known | (close & confirmed))
        target = torch.where(has_known, known, ne)
        drop = keep & ~attach & close
        new = keep & ~attach & ~drop

        pos = st.n_points + torch.cumsum(new.to(torch.int64), 0) - 1
        pos_ok = new & (pos < CAP)
        rows_write = attach | pos_ok
        dest = torch.where(attach, target, torch.where(pos_ok, pos, CAP))

        xyz2 = st.xyz.index_put((torch.where(pos_ok, dest, CAP),), xyz_new)
        vi_b, vj_b = vi.expand_as(dest), vj.expand_as(dest)
        obs2 = _set_last_writer(st.obs, (dest, vi_b), torch.where(rows_write, fi, -1), (CAP, 0))
        obs2 = _set_last_writer(obs2, (dest, vj_b), torch.where(rows_write, fj, -1), (CAP, 0))
        f2p = _set_last_writer(st.feat2point, (vi_b, torch.where(rows_write, fi, F)), dest, (0, F))
        f2p = _set_last_writer(f2p, (vj_b, torch.where(rows_write, fj, F)), dest, (0, F))
        n_new = pos_ok.sum()
        st2 = st._replace(xyz=xyz2, obs=obs2, feat2point=f2p, n_points=st.n_points + n_new)
        return st2, n_new, attach.sum(), drop.sum()

    # ------------------------------------------------------------------ #
    # on-device bundle adjustment (SfM::adjustCurrentBundle)
    # ------------------------------------------------------------------ #
    def _run_ba(self, st: EngineState, feat_xy, *, max_iterations=None,
                function_tolerance=None, host_exit=True):
        cfg = self.cfg
        V, CAP, dev = self.V, self.CAP, self.device
        obs = st.obs[:CAP]
        uv = feat_xy[torch.arange(V, device=dev)[None, :], torch.clamp(obs, min=0)]
        pt_valid = torch.arange(CAP, device=dev) < st.n_points
        # unregistered rows carry garbage rotations; cam_valid freezes them
        cams = torch.cat([camera.matrix_to_rodrigues(st.poses[:, :, :3]), st.poses[:, :, 3]], 1)
        prob = BAProblem(cams=cams, points=st.xyz[:CAP], focal=st.focal, uv=uv - self._pp,
                         mask=obs >= 0, cam_valid=st.pose_valid, pt_valid=pt_valid)
        sol, summary = lm_solve(
            prob,
            max_iterations=cfg.ba_max_iterations if max_iterations is None else max_iterations,
            function_tolerance=(cfg.ba_function_tolerance if function_tolerance is None
                                else function_tolerance),
            initial_lambda=cfg.ba_initial_lambda, share_focal=cfg.ba_share_focal,
            refine_pp=False, host_exit=host_exit)
        improved = summary.final_cost < summary.initial_cost
        Rt = torch.cat([camera.rodrigues_to_matrix(sol.cams[:, :3]), sol.cams[:, 3:, None]], 2)
        poses2 = torch.where((improved & st.pose_valid)[:, None, None], Rt, st.poses)
        xyz_head = torch.where((improved & pt_valid)[:, None], sol.points, st.xyz[:CAP])
        st2 = st._replace(poses=poses2, xyz=torch.cat([xyz_head, st.xyz[CAP:]]),
                          focal=torch.where(improved, sol.focal, st.focal))
        return st2, (summary.initial_cost, summary.final_cost,
                     summary.iterations.to(torch.float32))

    # ------------------------------------------------------------------ #
    # adaptive reprojection gate (MultiCameraPnP.cpp:347-358, Snavely §4.2)
    # ------------------------------------------------------------------ #
    def _adaptive_gate(self, e1, e2, keep):
        """keep (..., M) filtered at clip(mult * p80(err), keep_px, reject_px)."""
        cfg = self.cfg
        if not cfg.adaptive_reprojection_filter:
            return keep
        err = torch.maximum(e1, e2)
        n = keep.sum(-1)
        srt = torch.sort(torch.where(keep, err, _INF), dim=-1).values
        qi = torch.clamp((cfg.adaptive_percentile / 100.0)
                         * torch.clamp(n - 1, min=0).to(torch.float32),
                         0, err.shape[-1] - 1).to(torch.int64)
        p = srt.gather(-1, qi[..., None])[..., 0]
        thr = torch.clamp(cfg.adaptive_multiplier * p, cfg.adaptive_keep_px,
                          cfg.adaptive_reject_px)
        return keep & torch.where((n > 0)[..., None], err <= thr[..., None], True)

    # ------------------------------------------------------------------ #
    def _initial_state(self) -> EngineState:
        V, F, CAP, dev = self.V, self.F, self.CAP, self.device
        return EngineState(
            xyz=torch.zeros(CAP + 1, 3, device=dev),
            obs=torch.full((CAP + 1, V), -1, dtype=torch.int64, device=dev),
            feat2point=torch.full((V, F + 1), -1, dtype=torch.int64, device=dev),
            n_points=torch.zeros((), dtype=torch.int64, device=dev),
            poses=torch.zeros(V, 3, 4, device=dev),
            pose_valid=torch.zeros(V, dtype=torch.bool, device=dev),
            done=torch.zeros(V, dtype=torch.bool, device=dev),
            good=torch.zeros(V, dtype=torch.bool, device=dev),
            focal=torch.full((), self.f0, dtype=torch.float32, device=dev),
            stats=torch.zeros(V + 1, _STATS_COLS, device=dev),
        )

    def _baseline(self, feat_xy, match_idx, match_valid, right_of, rdist, left_of,
                  h_counts, seed):
        """Baseline ranking + pair search + map seeding + first BA
        (SfM.cpp:215-364). One host sync per candidate pair.
        Returns (EngineState, seeded (bool tensor))."""
        cfg = self.cfg
        P, dev = self.P, self.device
        st0 = self._initial_state()
        counts = match_valid.sum(1)
        ratio = h_counts / torch.clamp(counts, min=1)
        eligible = counts >= cfg.min_point_count_for_homography
        fallback = counts >= 16
        sortkey = torch.where(eligible, ratio, torch.where(fallback, ratio + 10.0, 1e9))
        order = torch.argsort(sortkey, stable=True).tolist()
        K, Kinv = self._K(st0.focal), self._Kinv(st0.focal)
        Rt1 = torch.eye(3, 4, device=dev)
        for c, p in enumerate(order):
            valid = match_valid[p]
            uv1, uv2 = self._pair_uv(feat_xy, match_idx, p)
            res = find_camera_from_match(
                self._generator(seed, 0, c), uv1, uv2, valid, K, Kinv,
                threshold_px=cfg.essential_threshold_px, hypotheses=self.E_HYP,
                use_horn=cfg.decomposition == EssentialDecomposition.HORN90,
                min_front_frac=cfg.cheirality_min_frac,
                max_front_reproj_px=cfg.cheirality_max_reproj_px)
            pose_ok = (res.ok & (res.inlier_ratio >= cfg.pose_inliers_minimal_ratio)
                       & (sortkey[p] < 1e8))
            xyz, keep, e1, e2 = triangulate_views(
                Rt1, res.Rt, K, Kinv, uv1, uv2, res.inliers & valid,
                max_reprojection_error=cfg.min_reprojection_error,
                iterations=cfg.triangulation_iters, eps=cfg.triangulation_eps)
            keep = self._adaptive_gate(e1, e2, keep)
            if bool(pose_ok & (keep.sum() >= 16)):
                break
        else:
            return st0, torch.zeros((), dtype=torch.bool, device=dev)

        i, j = self.pairs_list[p]
        poses = st0.poses.clone()
        poses[i] = Rt1
        poses[j] = res.Rt
        flags = torch.zeros(self.V, dtype=torch.bool, device=dev)
        flags[[i, j]] = True
        st = st0._replace(poses=poses, pose_valid=flags, done=flags, good=flags)
        vi = torch.full((1,), i, device=dev)
        vj = torch.full((1,), j, device=dev)
        st, n_new, n_merged, n_drop = self._merge_points(
            st, xyz, keep, vi, vj, match_idx[p, :, 0], match_idx[p, :, 1],
            right_of, rdist, left_of, feat_xy)
        st, (ba0, ba1, bait) = self._run_ba(
            st, feat_xy, max_iterations=cfg.ba_incremental_iterations,
            function_tolerance=cfg.ba_incremental_tolerance)
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        row = torch.stack([f32(i * 100 + j), f32(valid.sum()), f32(res.inlier_ratio), f32(1.0),
                           f32(n_new), f32(n_merged), f32(n_drop), ba0, ba1, bait])
        stats = st.stats.clone()
        stats[0] = row
        return st._replace(stats=stats), torch.ones((), dtype=torch.bool, device=dev)

    # ------------------------------------------------------------------ #
    def _step(self, st: EngineState, it: torch.Tensor, gen: torch.Generator, feat_xy,
              match_idx, match_valid, right_of, rdist, left_of) -> EngineState:
        """One add-view registration (SfM::addMoreViewsToReconstruction,
        SfM.cpp:366-469). ``it`` (1,) int64 is the step's index on the
        device, ``gen`` the PnP sampler's generator. Reads nothing back to
        the host, so a CUDA graph can capture it."""
        cfg = self.cfg
        V, F, CAP, PNP_CAP, dev = self.V, self.F, self.CAP, self.PNP_CAP, self.device
        a_all = self._pairs[:, 0]
        b_all = self._pairs[:, 1]

        # point_of_feat (V, F+1) + 2D-3D counts for every pending view
        fa, fb = match_idx[..., 0], match_idx[..., 1]
        pa = st.feat2point[a_all[:, None], torch.clamp(fa, 0, F)]
        pb = st.feat2point[b_all[:, None], torch.clamp(fb, 0, F)]
        va = match_valid & (fa >= 0) & (fb >= 0)
        ok1 = va & st.good[b_all][:, None] & ~st.done[a_all][:, None] & (pb >= 0)
        ok2 = va & st.good[a_all][:, None] & ~st.done[b_all][:, None] & (pa >= 0)
        cells = torch.cat([(a_all[:, None] * (F + 1) + torch.where(ok1, fa, F)).reshape(-1),
                           (b_all[:, None] * (F + 1) + torch.where(ok2, fb, F)).reshape(-1)])
        vals = torch.cat([torch.where(ok1, pb, -1).reshape(-1),
                          torch.where(ok2, pa, -1).reshape(-1)])
        pof = torch.full((V * (F + 1),), -1, dtype=torch.int64, device=dev)
        pof = pof.scatter_reduce(0, cells, vals, "amax").reshape(V, F + 1)
        cnt = torch.where(st.done, -1, (pof[:, :F] >= 0).sum(1))
        # the view to register, as a 1-element tensor (a 0-d CUDA index syncs)
        best = cnt.argmax().reshape(1)
        n2d3d = cnt[best][0]
        st = st._replace(done=st.done.index_put((best,), torch.ones((), dtype=torch.bool, device=dev)))

        # padded 2D-3D correspondences
        pof_best = pof[best][0]
        hit = (pof_best[:F] >= 0).to(torch.float32)
        sel = torch.sort(hit, descending=True, stable=True).indices[:PNP_CAP]
        mask = hit[sel] > 0
        X = st.xyz[torch.clamp(pof_best[sel], 0, CAP)]
        uv = feat_xy[best][0][sel]
        K, Kinv = self._K(st.focal), self._Kinv(st.focal)
        res = find_camera_pose_2d3d(
            gen, X, uv, mask, K, Kinv,
            threshold_px=cfg.pnp_threshold_px, hypotheses=self.PNP_HYP,
            min_inlier_ratio=cfg.pose_inliers_minimal_ratio)
        n_corr = mask.sum()
        inl = res.inliers.sum()
        pose_ok = (res.ok & (n2d3d >= 6)
                   & (inl.to(torch.float32) >= cfg.min_pnp_inlier_fraction * n_corr.to(torch.float32))
                   & (torch.linalg.vector_norm(res.Rt[:, 3]) <= cfg.max_translation_norm)
                   & ((torch.linalg.det(res.Rt[:, :3]) - 1.0).abs() <= 1e-2))

        # triangulate against every good view at once (views on a batch axis)
        g = torch.arange(V, device=dev)
        # g == best hits trash row P; clamp it as XLA clamps gathers (masked below)
        p = torch.clamp(self._pair_row[torch.minimum(best, g), torch.maximum(best, g)],
                        max=self.P - 1)                                              # (V,)
        uv_a, uv_b = self._pair_uv(feat_xy, match_idx, p)
        best_is_a = (best < g)[:, None]
        uv_n = torch.where(best_is_a[..., None], uv_a, uv_b)
        uv_g = torch.where(best_is_a[..., None], uv_b, uv_a)
        f_n = torch.where(best_is_a, match_idx[p, :, 0], match_idx[p, :, 1])
        f_g = torch.where(best_is_a, match_idx[p, :, 1], match_idx[p, :, 0])
        m = match_valid[p] & (g != best)[:, None] & st.good[:, None]
        E = essential_from_poses(res.Rt, st.poses)
        epi = sampson_error(E, camera.normalize_points(Kinv, uv_n),
                            camera.normalize_points(Kinv, uv_g)) < (
            cfg.epipolar_prune_threshold_px / st.focal)
        xyz, keep, e1, e2 = triangulate_views(
            res.Rt, st.poses, K, Kinv, uv_n, uv_g, m & epi,
            max_reprojection_error=cfg.min_reprojection_error,
            iterations=cfg.triangulation_iters, eps=cfg.triangulation_eps)
        keep = self._adaptive_gate(e1, e2, keep)

        st = st._replace(
            poses=torch.where(pose_ok, st.poses.index_put((best,), res.Rt), st.poses),
            pose_valid=st.pose_valid.index_put((best,), pose_ok | st.pose_valid[best]),
            good=st.good.index_put((best,), pose_ok | st.good[best]),
        )
        tots = torch.zeros(3, dtype=torch.int64, device=dev)
        for s in range(V):
            st, n_new, n_mrg, n_drp = self._merge_points(
                st, xyz[s], keep[s] & pose_ok, best, g[s:s + 1], f_n[s], f_g[s],
                right_of, rdist, left_of, feat_xy)
            tots = tots + torch.stack([n_new, n_mrg, n_drp])
        st_ba, ba = self._run_ba(st, feat_xy, max_iterations=cfg.ba_incremental_iterations,
                                 function_tolerance=cfg.ba_incremental_tolerance,
                                 host_exit=False)
        st = _state_where(pose_ok, st_ba, st)
        ba0, ba1, bait = (torch.where(pose_ok, x, 0.0) for x in ba)
        row = torch.stack([best[0].to(torch.float32), n2d3d.to(torch.float32),
                           res.inlier_ratio.to(torch.float32), pose_ok.to(torch.float32),
                           *tots.to(torch.float32), ba0, ba1, bait])
        return st._replace(stats=st.stats.index_put((1 + it,), row))

    def _step_graph_key(self, inputs) -> tuple:
        """Everything a capture of ``_step`` bakes in (``graph_key``): the
        inputs' shapes and dtypes (V, F, M, P), the whole configuration (a
        superset of the fields the step reads, CAP and the PnP sizes among
        them) and the principal point it passes into kernels as floats."""
        return graph_key(self.device, tuple((tuple(x.shape), x.dtype) for x in inputs),
                         dataclasses.astuple(self.cfg), self.cx, self.cy)

    def _step_graph(self, inputs, st: EngineState) -> "Graph | None":
        """The add-view step's graph for this engine (``_capture_step``),
        loaded with the job's ``inputs``, the baseline's state ``st`` and
        step 0: captured on the first call for its key, reused after. None
        off CUDA (the step runs eagerly)."""
        if self.device.type != "cuda":
            return None
        graph = _STEP_GRAPHS.get(self._step_graph_key(inputs),
                                 lambda: self._capture_step(inputs, st))
        graph.load(*inputs, *st, torch.zeros(1, dtype=torch.int64, device=self.device))
        return graph

    def _capture_step(self, inputs, st: EngineState) -> Graph:
        """``_step`` as one CUDA graph over buffers of the inputs, the state
        and the step index, a device counter: it copies the new state back
        into the state's buffers and advances the index, so step k+1
        replays on step k's output. The PnP sampler's generator is the
        graph's, reseeded before each replay with the seed the eager step's
        generator takes; graph-safe philox draws the same numbers. The graph
        calls this engine's ``_step``, whose constant tensors (pair table,
        principal point) the key fixes; it keeps the body, and so this
        engine. ``replay`` returns the state's buffers."""
        n, gen = len(inputs), torch.Generator(device=self.device)

        def body(*bufs):
            state, it = EngineState(*bufs[n:-1]), bufs[-1]
            for buf, x in zip(state, self._step(state, it, gen, *bufs[:n])):
                buf.copy_(x)
            it.add_(1)
            return state

        it0 = torch.zeros(1, dtype=torch.int64, device=self.device)
        return Graph(body, [x.clone() for x in (*inputs, *st)] + [it0], "sfm.engine.capture",
                     generator=gen)

    # ------------------------------------------------------------------ #
    def _finish(self, st: EngineState, seeded, feat_xy):
        V, CAP, dev = self.V, self.CAP, self.device
        zero = torch.zeros((), device=dev)
        if bool(seeded):
            st, (fb0, fb1, fbit) = self._run_ba(st, feat_xy)
        else:
            fb0 = fb1 = fbit = zero
        frow = torch.zeros(_STATS_COLS, device=dev)
        frow[S_OK] = seeded.to(torch.float32)
        frow[S_BA0], frow[S_BA1], frow[S_BAIT] = fb0, fb1, fbit
        stats = st.stats.clone()
        stats[V] = frow
        st = st._replace(stats=stats)

        # mean reprojection error over the live observation grid
        obs = st.obs[:CAP]
        uv = feat_xy[torch.arange(V, device=dev)[None, :], torch.clamp(obs, min=0)]
        w = ((obs >= 0) & st.pose_valid[None, :]
             & (torch.arange(CAP, device=dev) < st.n_points)[:, None])
        proj = camera.project_points(st.poses, self._K(st.focal), st.xyz[:CAP])    # (V, CAP, 2)
        err = torch.linalg.vector_norm(proj.transpose(0, 1) - uv, dim=-1)
        mean_err = torch.where(w, err, 0.0).sum() / torch.clamp(w.sum(), min=1)
        return dict(poses=st.poses, pose_valid=st.pose_valid, xyz=st.xyz,
                    obs=st.obs.to(torch.int32), n_points=st.n_points, focal=st.focal,
                    stats=st.stats, mean_err=mean_err, seeded=seeded)

    # ------------------------------------------------------------------ #
    def run(self, gray_u8: np.ndarray, extract_fn, match_fn, seed: int = 0):
        """Execute the full reconstruction.

        gray_u8: (V, H, W) uint8 host images (the only host->device copy).
        extract_fn: images f32 [0, 1] on the device -> Features.
        match_fn: (Features, pairs (P, 2)) -> Matches batch.
        Returns the fetched reconstruction as a dict of numpy arrays.
        """
        timings = {}
        with stage("sfm.total", timings, "total_s"):
            with stage("sfm.features", timings, "features_s"):
                imgs = torch.as_tensor(np.ascontiguousarray(gray_u8)).to(self.device)
                feats = extract_fn(torch.as_tensor(_U8_TO_UNIT, device=self.device)[imgs.long()])
                self._sync()

            with stage("sfm.matching", timings, "matching_s"):
                m = match_fn(feats, self._pairs)
                match_idx = m.idx.to(torch.int64)
                match_valid, match_dist = m.valid, m.dist
                self._sync()

            with stage("sfm.prune", timings, "prune_s"):
                if self.cfg.epipolar_prune:
                    match_valid = self.prune_all(self._generator(seed, 7), feats.xy, match_idx,
                                                 match_valid,
                                                 torch.tensor(self.f0, device=self.device))
                    self._sync()

            with stage("sfm.rank", timings, "rank_s"):
                right_of, rdist, left_of = self.build_lookup(match_idx, match_valid, match_dist)
                h_counts = self.homography_counts(self._generator(seed, 11), feats.xy,
                                                  match_idx, match_valid)
                self._sync()

            with stage("sfm.solve", timings, "solve_s"):
                solve_seed = int(np.random.SeedSequence([seed, 13]).generate_state(1)[0])
                with stage("sfm.engine.baseline"):
                    st, seeded = self._baseline(feats.xy, match_idx, match_valid, right_of,
                                                rdist, left_of, h_counts, solve_seed)
                inputs = (feats.xy, match_idx, match_valid, right_of, rdist, left_of)
                graph = self._step_graph(inputs, st)
                for it in range(self.V - 2):
                    with stage("sfm.engine.step"):
                        if graph is None:
                            st = self._step(st, torch.full((1,), it, device=self.device),
                                            self._generator(solve_seed, 1, it), *inputs)
                        else:
                            st = graph.replay(self._seed(solve_seed, 1, it))
                if graph is not None:
                    st = EngineState(*(x.clone() for x in st))
                with stage("sfm.engine.finish"):
                    out = self._finish(st, seeded, feats.xy)
                self._sync()

            with stage("sfm.fetch", timings, "fetch_s"):
                fetched = {k: v.cpu().numpy() for k, v in dict(out, feat_xy=feats.xy,
                                                               feat_valid=feats.valid).items()}
        self.timings = timings
        return fetched


# The add-view step's graphs by ``FusedEngine._step_graph_key``.
_STEP_GRAPHS = GraphCache(4)
