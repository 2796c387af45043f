"""The incremental SfM state machine.

Counterpart of ``tpusfm/pipeline/incremental.py``, with the same names and
the same host-side numpy track graph (points x views observation table +
per-view feature->point inverse maps):

  runSfM (SfM.cpp:63-95):
    extractFeatures        -> one batched detector call over all views
    createFeatureMatchMatrix -> all pairs on the streaming CUDA matcher
    findBaselineTriangulation -> batched H-inlier ranking + two-view RANSAC
    addMoreViewsToReconstruction -> PnP RANSAC + batched triangulation
    adjustCurrentBundle    -> LM/Schur BA after every registration

``run()`` takes the fused device path (``pipeline/engine.py``) when it
applies, and the host-driven loop otherwise (``fused=False``, a registered
listener, principal-point BA). The host loop reads results back at every
stage; device work is batched over pairs and good views, never looped.

PyTorch compiles nothing here, so the reference's paddings to static
shapes are gone: matching runs the real pairs of a chunk, PnP the real
correspondences (capped at ``_PNP_CAP``), triangulation one slot per good
view with enough matches, BA the live points. Random draws come from one
``torch.Generator`` on the pipeline's device, reseeded by ``reset(seed)``.
The flow strategies (optical flow, dense, stereo) match pairs in chunks of
``_FLOW_PAIR_CHUNK`` and read them back once. The host track graph runs on
the native C++ runtime (``tpusfm_torch/native.py``) when it builds, and on
numpy otherwise; ``_timings["native"]`` says which.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpusfm_torch import camera, native
from tpusfm_torch.ba.lm import adjust_bundle
from tpusfm_torch.config import EssentialDecomposition, MatcherKind, SfMConfig
from tpusfm_torch.features.blob import extract_blob_features
from tpusfm_torch.features.dense import match_pair_dense
from tpusfm_torch.features.detect import extract_features
from tpusfm_torch.features.match import match_all_pairs
from tpusfm_torch.features.optical_flow import match_pair_optical_flow
from tpusfm_torch.features.pallas_match import match_pairs
from tpusfm_torch.features.stereo import match_pair_disparity
from tpusfm_torch.geometry.essential import epipolar_inliers, find_camera_from_match
from tpusfm_torch.geometry.homography import find_homography_inliers
from tpusfm_torch.geometry.pnp import find_camera_pose_2d3d
from tpusfm_torch.geometry.triangulation import triangulate_views
from tpusfm_torch.ransac import adaptive_num_hypotheses
from tpusfm_torch.types import Features, Intrinsics, Matches, np_of
from tpusfm_torch.utils.profiling import stage

_PNP_CAP = 4096
_PAIR_CHUNK = 64
_FLOW_PAIR_CHUNK = 8   # a stereo pair's cost volume is ~0.2 GB at 1024x768, D = 64
_FLOW_KINDS = (MatcherKind.OPTICAL_FLOW, MatcherKind.DENSE, MatcherKind.STEREO)
_MERGE_ROWS = 512      # new points per block of the merge's distance search


@dataclasses.dataclass
class Reconstruction:
    """Final reconstruction state (host numpy)."""

    poses: np.ndarray          # (V, 3, 4)
    pose_valid: np.ndarray     # (V,)
    xyz: np.ndarray            # (N, 3)
    rgb: np.ndarray            # (N, 3) uint8
    obs: np.ndarray            # (N, V) int32 feature index, -1 sentinel
    K: np.ndarray              # (3, 3)
    mean_reprojection_error: float
    stats: Dict

    @property
    def num_points(self) -> int:
        return self.xyz.shape[0]

    def save_ply(self, prefix: str):
        from tpusfm_torch.io.ply import save_cameras_ply, save_point_cloud_ply

        save_point_cloud_ply(prefix + "_points.ply", self.xyz, self.rgb)
        scale = (float(np.median(np.linalg.norm(self.xyz - np.median(self.xyz, 0), axis=1)))
                 if len(self.xyz) else 1.0)
        save_cameras_ply(prefix + "_cameras.ply", self.poses, self.pose_valid,
                         scale=max(scale * 0.2, 1e-3))

    def save_html(self, path: str):
        """Interactive standalone HTML viewer (viz/html_viewer.py)."""
        from tpusfm_torch.viz import export_html_viewer

        export_html_viewer(path, self.xyz, self.rgb, self.poses, self.pose_valid)

    def select_points(self, keep: np.ndarray) -> "Reconstruction":
        """New Reconstruction restricted to points where keep is True
        (used by the SOR post-filter, legacy/Visualization.cpp:121-153)."""
        keep = np.asarray(keep, bool)
        return dataclasses.replace(self, xyz=self.xyz[keep], rgb=self.rgb[keep],
                                   obs=self.obs[keep])


class SfMPipeline:
    """Host-side incremental SfM loop over batched device stages.

    Mirrors the public surface of the reference ``SfM`` class (SfM.h:46-145):
    construct, feed images, ``run()``, then export via the returned
    Reconstruction. images_gray (V, H, W) float32 in [0, 1]. Runs on
    ``device`` ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, images_gray: np.ndarray, config: Optional[SfMConfig] = None,
                 images_rgb: Optional[np.ndarray] = None,
                 intrinsics: Optional[Intrinsics] = None, seed: int = 0,
                 device="cuda"):
        self.cfg = config or SfMConfig()
        self.device = torch.device(device)
        self.gray = np.asarray(images_gray, np.float32)
        self.rgb = images_rgb
        self.V, self.H, self.W = self.gray.shape
        if intrinsics is not None:
            self.intr = Intrinsics(*(torch.as_tensor(x, device=self.device)
                                     for x in (intrinsics.K, intrinsics.Kinv, intrinsics.dist)))
        else:
            # Reference hardcodes f=2500 at full res, pp = image center
            # (SfM.cpp:70-74); scale focal with the downscale factor.
            f = self.cfg.default_focal / max(self.cfg.downscale, 1e-6)
            self.intr = Intrinsics.create(f, self.W / 2.0, self.H / 2.0, device=self.device)
        self._init_intr = self.intr
        self._listeners: List = []
        self._build_kernels()
        self.reset(seed)

    def add_listener(self, fn):
        """Register an update observer (SfMUpdateListener equivalent,
        legacy SfMUpdateListener.h:33-41): fn(xyz, rgb, poses, pose_valid)
        is called after the baseline seed and after every registered view —
        e.g. to stream a growing cloud into a viewer."""
        self._listeners.append(fn)

    def _notify(self):
        if not self._listeners:
            return
        xyz = self.xyz[: self.n_points].copy()
        rgb = self._point_colors()
        for fn in self._listeners:
            fn(xyz, rgb, self.poses.copy(), self.pose_valid.copy())

    def reset(self, seed: int = 0):
        """Clear reconstruction state; a reset pipeline replays the exact
        same random streams, so repeat runs are bit-deterministic."""
        cfg = self.cfg
        self.intr = self._init_intr
        self._seed = seed
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._timings = {}
        # --- host track-graph state ---
        cap = cfg.point_capacity
        self.xyz = np.zeros((cap, 3), np.float32)
        self.obs = np.full((cap, self.V), -1, np.int32)
        self.n_points = 0
        self.feat2point = np.full((self.V, cfg.max_features), -1, np.int32)
        self.poses = np.zeros((self.V, 3, 4), np.float32)
        self.pose_valid = np.zeros((self.V,), bool)
        self.done_views: set = set()
        self.good_views: set = set()
        self.features: Optional[Features] = None
        self.feat_xy: Optional[np.ndarray] = None
        self.feat_valid: Optional[np.ndarray] = None
        self.match_idx: Optional[np.ndarray] = None   # (P, M, 2)
        self.match_valid: Optional[np.ndarray] = None  # (P, M)
        self.match_dist: Optional[np.ndarray] = None   # (P, M)
        self.pairs: List[Tuple[int, int]] = []
        self.pair_of: Dict[Tuple[int, int], int] = {}
        self._lookup = None                            # match lookup cache
        self._fused_runs = -1

    # ------------------------------------------------------------------ #
    # device stages, bound to the configuration
    # ------------------------------------------------------------------ #
    def _build_kernels(self):
        cfg = self.cfg
        # confidence-derived hypothesis floors (reference: prob 0.999 @
        # SfMStereoUtilities.cpp:97, conf 0.99 @ :226); see engine.py
        e_hyp = max(cfg.ransac_hypotheses,
                    adaptive_num_hypotheses(0.75, 8, cfg.essential_prob))
        pnp_hyp = max(cfg.pnp_hypotheses,
                      adaptive_num_hypotheses(0.6, 6, cfg.pnp_confidence))

        if cfg.matcher == MatcherKind.SURF:
            # float-descriptor blob pipeline (legacy GPU-SURF path)
            self._extract = functools.partial(extract_blob_features,
                                              max_features=cfg.max_features)
        else:
            # the flow strategies detect at one scale, like the legacy
            # FAST-only path (OFFeatureMatcher.cpp:60-62): stacked multi-scale
            # duplicates of a corner defeat endpoint association
            self._extract = functools.partial(
                extract_features, max_features=cfg.max_features, desc_bits=cfg.desc_bits,
                pyramid_levels=1 if cfg.matcher in _FLOW_KINDS else cfg.pyramid_levels,
                pyramid_scale=cfg.pyramid_scale, fast_threshold=cfg.fast_threshold / 255.0,
                score_kind=cfg.detector_score, sampling=cfg.descriptor_sampling)
        # the streaming matcher needs the full distance matrix only for
        # cross-check; it takes feature budgets that are multiples of 256
        if (cfg.matcher == MatcherKind.RICH and cfg.use_pallas_matcher
                and not cfg.cross_check and cfg.max_features % 256 == 0):
            self._match = lambda feats, pairs: match_pairs(
                feats.desc, feats.valid, pairs, ratio=cfg.match_ratio,
                max_matches=cfg.max_matches)
        else:
            surf = cfg.matcher == MatcherKind.SURF
            self._match = functools.partial(
                match_all_pairs, ratio=cfg.match_ratio_flow if surf else cfg.match_ratio,
                cross_check=cfg.cross_check, max_matches=cfg.max_matches,
                metric="l2" if surf else "hamming")
        # the flow strategies match by images and keypoints, a batch of pairs
        # at a time
        self._flow_match = {
            MatcherKind.OPTICAL_FLOW: functools.partial(
                match_pair_optical_flow, ratio=cfg.match_ratio_flow, max_matches=cfg.max_matches),
            MatcherKind.DENSE: functools.partial(match_pair_dense, max_matches=cfg.max_matches),
            MatcherKind.STEREO: functools.partial(
                match_pair_disparity, max_disparity=cfg.max_disparity,
                max_matches=cfg.max_matches),
        }.get(cfg.matcher)

        # the three below take a leading batch axis (pairs, or good views)
        self._homography_counts = lambda gen, uv1, uv2, mask: find_homography_inliers(
            gen, uv1, uv2, mask, threshold_px=cfg.ransac_threshold_px,
            hypotheses=cfg.ransac_hypotheses // 2)[0]
        self._prune = functools.partial(
            epipolar_inliers, threshold_px=cfg.epipolar_prune_threshold_px,
            hypotheses=cfg.epipolar_prune_hypotheses)
        self._two_view = functools.partial(
            find_camera_from_match, threshold_px=cfg.essential_threshold_px,
            hypotheses=e_hyp,
            use_horn=cfg.decomposition == EssentialDecomposition.HORN90,
            # legacy cheirality acceptance gates: >=75 % of inliers in front +
            # reprojection < 100 px (FindCameraMatrices.cpp:277-326, :465-470)
            min_front_frac=cfg.cheirality_min_frac,
            max_front_reproj_px=cfg.cheirality_max_reproj_px)
        self._triangulate = functools.partial(
            triangulate_views, max_reprojection_error=cfg.min_reprojection_error,
            iterations=cfg.triangulation_iters, eps=cfg.triangulation_eps)
        self._pnp = functools.partial(
            find_camera_pose_2d3d, threshold_px=cfg.pnp_threshold_px,
            hypotheses=pnp_hyp, min_inlier_ratio=cfg.pose_inliers_minimal_ratio)

        def prune_triangulate_batch(gen, Rt_new, Rt_g, uv1, uv2, mask, K, Kinv):
            """Epipolar-prune + triangulate the new view against ALL good
            views at once (replaces the reference's serial per-good-view
            loop, SfM.cpp:413-461): the good views are the batch axis."""
            two = find_camera_from_match(gen, uv1, uv2, mask, K, Kinv,
                                         threshold_px=cfg.essential_threshold_px,
                                         hypotheses=e_hyp)
            return self._triangulate(Rt_new, Rt_g, K, Kinv, uv1, uv2, two.inliers & mask)

        self._prune_triangulate = prune_triangulate_batch
        self._ba = functools.partial(
            adjust_bundle, max_iterations=cfg.ba_max_iterations,
            function_tolerance=cfg.ba_function_tolerance,
            initial_lambda=cfg.ba_initial_lambda, share_focal=cfg.ba_share_focal,
            refine_pp=cfg.ba_refine_pp, dtype=cfg.ba_dtype)

    def _log(self, level: int, msg):
        """msg: a string, or a callable that builds one (so a message that
        reads a tensor back costs nothing when the level suppresses it)."""
        if level >= self.cfg.console_debug_level:
            print(f"[tpusfm_torch] {msg() if callable(msg) else msg}", flush=True)

    def _dev(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype).to(self.device)

    # ------------------------------------------------------------------ #
    # pipeline stages
    # ------------------------------------------------------------------ #
    def _undistort_features(self, feats: Features) -> Features:
        """Undistort keypoints once after extraction when the calibration
        carries distortion; every later stage is then pinhole."""
        if not bool((self.intr.dist != 0).any()):
            return feats
        xy = camera.undistort_points(self.intr.K, self.intr.Kinv, self.intr.dist, feats.xy)
        return dataclasses.replace(feats, xy=xy)

    def extract(self):
        with stage("sfm.features", self._timings, "features_s"):
            self.features = self._undistort_features(self._extract(self._dev(self.gray)))
            self.feat_xy = np_of(self.features.xy)
            self.feat_valid = np_of(self.features.valid)
        self._log(2, lambda: f"features: {int(self.feat_valid.sum())} keypoints over "
                             f"{self.V} views in {self._timings['features_s']:.2f}s")

    def _all_pairs(self):
        self.pairs = [(i, j) for i in range(self.V) for j in range(i + 1, self.V)]
        self.pair_of = {p: n for n, p in enumerate(self.pairs)}

    def match(self):
        """All-pairs match matrix, in chunks of at most ``_PAIR_CHUNK`` pairs
        (a chunk bounds the gathered descriptors; its last one is not padded).

        Replaces the reference's thread fan-out (SfM.cpp:165-211)."""
        with stage("sfm.matching", self._timings, "matching_s"):
            self._all_pairs()
            self._lookup = None
            pairs = np.array(self.pairs, np.int64).reshape(-1, 2)
            flow = self.cfg.matcher in _FLOW_KINDS
            if flow:
                chunks = self._match_optical_flow(pairs)
            else:
                chunks = [self._match(self.features, self._dev(pairs[s: s + _PAIR_CHUNK]))
                          for s in range(0, len(pairs), _PAIR_CHUNK)]
            self.match_idx = np.concatenate([np_of(m.idx) for m in chunks], 0)
            self.match_valid = np.concatenate([np_of(m.valid) for m in chunks], 0)
            self.match_dist = np.concatenate([np_of(m.dist) for m in chunks], 0)
        self._log(2, lambda: f"{'LK-flow ' if flow else ''}matching: {len(pairs)} pairs, "
                             f"median {int(np.median(self.match_valid.sum(1)))} matches "
                             f"in {self._timings['matching_s']:.2f}s")
        if self.cfg.epipolar_prune:
            self.prune_matches_epipolar()
        if not flow:
            self._dump_match_overlays()

    def _match_optical_flow(self, pairs: np.ndarray) -> List:
        """Pairwise matching by flow (legacy OFFeatureMatcher and the dense
        and disparity strategies of FeatureMatching.cpp): chunks of
        ``_FLOW_PAIR_CHUNK`` pairs, each one batched call on the device; the
        chunks are joined there, so the matches are read back once. DENSE
        also takes the descriptors, to seed its flow."""
        gray = self._dev(self.gray)
        f = self.features
        out = []
        for s in range(0, len(pairs), _FLOW_PAIR_CHUNK):
            i, j = (self._dev(pairs[s: s + _FLOW_PAIR_CHUNK, k]) for k in (0, 1))
            extra = (dict(feats1_desc=f.desc[i], feats2_desc=f.desc[j])
                     if self.cfg.matcher == MatcherKind.DENSE else {})
            out.append(self._flow_match(gray[i], gray[j], f.xy[i], f.valid[i], f.xy[j],
                                        f.valid[j], **extra))
        return [Matches(*(torch.cat([getattr(m, k) for m in out]) for k in
                          ("idx", "dist", "valid")))]

    def _dump_match_overlays(self):
        """Visual-debug channel: write match overlays for the best pairs
        (imshow-panel equivalent, SfM.cpp:277-286, gated by
        mVisualDebugLevel like SfM.h:77-83)."""
        if self.cfg.visual_debug_level > 2:
            return
        from tpusfm_torch.viz import draw_keypoints, draw_matches

        os.makedirs(self.cfg.debug_dir, exist_ok=True)
        counts = self.match_valid.sum(1)
        for n in np.argsort(-counts)[:6]:
            i, j = self.pairs[n]
            uv1, uv2, valid, _ = self._pair_match_uv(i, j)
            draw_matches(os.path.join(self.cfg.debug_dir, f"matches_{i}_{j}.png"),
                         self.gray[i], self.gray[j], uv1, uv2, valid)
        if self.cfg.visual_debug_level <= 1:
            for v in range(self.V):
                draw_keypoints(os.path.join(self.cfg.debug_dir, f"keypoints_{v}.png"),
                               self.gray[v], self.feat_xy[v], self.feat_valid[v])

    def _pairs_uv(self, rows: np.ndarray):
        """Aligned (uv_a, uv_b) (n, M, 2) of pair rows, in a < b order."""
        ab = np.array(self.pairs, np.int64).reshape(-1, 2)[rows]
        idx = np.maximum(self.match_idx[rows], 0)
        return (self.feat_xy[ab[:, 0, None], idx[..., 0]],
                self.feat_xy[ab[:, 1, None], idx[..., 1]])

    def prune_matches_epipolar(self):
        """Global epipolar match-pruning (legacy PruneMatchesBasedOnF,
        MultiCameraPnP.cpp:463-485): re-filter every pair's matches by an
        E-matrix RANSAC consensus, batched over pair chunks on device."""
        with stage("sfm.prune", self._timings, "prune_s"):
            before = int(self.match_valid.sum())
            for s in range(0, len(self.pairs), _PAIR_CHUNK):
                rows = np.arange(s, min(s + _PAIR_CHUNK, len(self.pairs)))
                uv1, uv2 = self._pairs_uv(rows)
                msk = self.match_valid[rows]
                inl = np_of(self._prune(self._gen, self._dev(uv1), self._dev(uv2),
                                        self._dev(msk), self.intr.K, self.intr.Kinv))
                # only prune pairs with enough matches for the 8-pt solver
                enough = msk.sum(1) >= 16
                self.match_valid[rows] = np.where(enough[:, None], msk & inl, msk)
            self._lookup = None
        self._log(2, lambda: f"epipolar prune: {before} -> {int(self.match_valid.sum())} "
                             f"matches in {self._timings['prune_s']:.2f}s")

    def _pair_match_uv(self, i: int, j: int):
        """Aligned (uv_i, uv_j, mask, idx) for registered pair (i < j ordering)."""
        a, b = (i, j) if i < j else (j, i)
        p = self.pair_of[(a, b)]
        idx = self.match_idx[p]
        valid = self.match_valid[p]
        li = np.maximum(idx[:, 0], 0)
        ri = np.maximum(idx[:, 1], 0)
        uv_a = self.feat_xy[a][li]
        uv_b = self.feat_xy[b][ri]
        if (a, b) == (i, j):
            return uv_a, uv_b, valid, idx
        return uv_b, uv_a, valid, idx[:, ::-1]

    def sort_views_for_baseline(self) -> List[Tuple[float, Tuple[int, int]]]:
        """Rank pairs by ascending homography-inlier ratio
        (SfM::sortViewsForBaseline, SfM.cpp:333-364): low H-inlier ratio =
        large baseline = good stereo pair; pairs with too few matches are
        excluded (MIN_POINT_COUNT_FOR_HOMOGRAPHY=100, SfM.cpp:52)."""
        counts = self.match_valid.sum(1)
        eligible = [n for n, _ in enumerate(self.pairs)
                    if counts[n] >= self.cfg.min_point_count_for_homography]
        if not eligible:
            # fall back to every non-empty pair, best-matched first
            eligible = [n for n in np.argsort(-counts) if counts[n] >= 16]
        if not eligible:
            return []
        rows = np.array(eligible, np.int64)
        uv1, uv2 = self._pairs_uv(rows)
        h_inl = np_of(self._homography_counts(
            self._gen, self._dev(uv1), self._dev(uv2), self._dev(self.match_valid[rows])))
        ratios = h_inl / np.maximum(counts[rows], 1)
        order = np.argsort(ratios, kind="stable")
        ranked = [(float(ratios[k]), self.pairs[eligible[k]]) for k in order]
        for r, p in ranked[:8]:
            self._log(1, f"  baseline candidate {p}: H-inlier ratio {r:.3f}")
        return ranked

    def find_baseline_triangulation(self) -> bool:
        """Seed the map from the best stereo pair (SfM.cpp:215-321)."""
        with stage("sfm.baseline", self._timings, "baseline_s"):
            K, Kinv = self.intr.K, self.intr.Kinv
            Rt1 = np.eye(3, 4, dtype=np.float32)
            for ratio, (i, j) in self.sort_views_for_baseline():
                uv1, uv2, valid, idx = self._pair_match_uv(i, j)
                uv1_t, uv2_t = self._dev(uv1), self._dev(uv2)
                res = self._two_view(self._gen, uv1_t, uv2_t, self._dev(valid), K, Kinv)
                ok, pose_ratio = torch.stack([res.ok.to(torch.float32),
                                              res.inlier_ratio.to(torch.float32)]).tolist()
                if not ok or pose_ratio < self.cfg.pose_inliers_minimal_ratio:
                    self._log(2, f"baseline {i},{j}: pose inlier ratio {pose_ratio:.2f} < "
                                 f"{self.cfg.pose_inliers_minimal_ratio} — rejected "
                                 f"(SfM.cpp:264-275)")
                    continue
                xyz, keep, _, _ = self._triangulate(
                    self._dev(Rt1), res.Rt, K, Kinv, uv1_t, uv2_t, res.inliers & self._dev(valid))
                keep = np_of(keep)
                n_new = int(keep.sum())
                if n_new < 16:
                    self._log(2, f"baseline {i},{j}: triangulation produced {n_new} points "
                                 f"— rejected")
                    continue
                self.poses[i] = Rt1
                self.poses[j] = np_of(res.Rt)
                self.pose_valid[[i, j]] = True
                self.done_views |= {i, j}
                self.good_views |= {i, j}
                self._merge_points(np_of(xyz)[keep], i, idx[keep, 0], j, idx[keep, 1])
                self._log(2, f"baseline {i},{j}: {n_new} seed points "
                             f"(pose inliers {pose_ratio:.2f}, H-ratio {ratio:.3f})")
                self.adjust_bundle()
                self._notify()
                return True
            return False

    # ------------------------------------------------------------------ #
    # track graph bookkeeping (host)
    # ------------------------------------------------------------------ #
    def _match_lookup(self):
        """(pair_row (V,V), right_of, rdist, left_of) host lookup tables.

        right_of[p, lf] = right-view feature matched to left feature lf of
        pair p (-1 if none); rdist the match distance; left_of the inverse.
        Row P and column F are trash slots. Duplicate writes resolve as
        numpy resolves them (the last one wins)."""
        if self._lookup is None:
            P, M = self.match_idx.shape[:2]
            F = self.cfg.max_features
            pair_row = np.full((self.V, self.V), P, np.int32)
            for (a, b), p in self.pair_of.items():
                pair_row[a, b] = p
            rows = np.arange(P)[:, None]
            mv = self.match_valid
            lf = np.where(mv, self.match_idx[:, :, 0], F)
            rf = np.where(mv, self.match_idx[:, :, 1], F)
            right_of = np.full((P + 1, F + 1), -1, np.int32)
            right_of[rows, lf] = np.where(mv, self.match_idx[:, :, 1], -1)
            rdist = np.full((P + 1, F + 1), 1e9, np.float32)
            if self.match_dist is not None:
                rdist[rows, lf] = np.where(mv, self.match_dist, 1e9)
            else:
                # Checkpoints saved before match distances were recorded:
                # treat every surviving ratio-test match as confirming
                # (distance 0) rather than never-confirming (1e9), which
                # would silently drop close-but-unconfirmed merges.
                rdist[rows, lf] = np.where(mv, 0.0, 1e9)
            left_of = np.full((P + 1, F + 1), -1, np.int32)
            left_of[rows, rf] = np.where(mv, self.match_idx[:, :, 0], -1)
            self._lookup = (pair_row, right_of, rdist, left_of)
        return self._lookup

    def _grow_map(self, n_more: int):
        if self.n_points + n_more > self.xyz.shape[0]:
            grow = max(self.xyz.shape[0], n_more)
            self.xyz = np.concatenate([self.xyz, np.zeros((grow, 3), np.float32)])
            self.obs = np.concatenate([self.obs, np.full((grow, self.V), -1, np.int32)])

    def _nearest_point(self, xyz: np.ndarray):
        """(index, squared distance) of the nearest live map point per row of
        xyz (first index on ties). The squared differences are added one
        coordinate at a time, ((dx^2 + dy^2) + dz^2) in float32 — the order
        in which numpy sums a last axis of 3 — so the result equals
        ``((xyz[:, None] - live[None]) ** 2).sum(-1)`` bit for bit without
        its (rows x points x 3) block; rows go in blocks of ``_MERGE_ROWS``."""
        live = np.ascontiguousarray(self.xyz[: self.n_points].T)          # (3, n)
        ne = np.empty(len(xyz), np.int64)
        d2min = np.empty(len(xyz), np.float32)
        for s in range(0, len(xyz), _MERGE_ROWS):
            q = xyz[s: s + _MERGE_ROWS]
            d2 = (q[:, 0:1] - live[0]) ** 2
            d2 += (q[:, 1:2] - live[1]) ** 2
            d2 += (q[:, 2:3] - live[2]) ** 2
            ne[s: s + _MERGE_ROWS] = d2.argmin(1)
            d2min[s: s + _MERGE_ROWS] = d2.min(1)
        return ne, d2min

    def _merge_points(self, xyz: np.ndarray, vi: int, fi: np.ndarray, vj: int, fj: np.ndarray):
        """Merge newly triangulated points into the map, on the native C++
        runtime (csrc/trackgraph.cc, tpusfm_insert_points_v2) when it is
        built, as the reference does, and by ``_insert_points`` (numpy)
        otherwise; ``_timings["native"]`` and the level-1 log say which.
        They are different functions, in the reference too (ROADMAP.md §3):
        the native merge takes a call's points in order, each seeing the
        points appended before it, and attaches to the first confirmed map
        point within the merge distance; the numpy merge holds every point
        against the map as it was before the call and confirms only the
        nearest one."""
        self._timings["native"] = native.available()
        if not self._timings["native"]:
            self._insert_points(xyz, vi, fi, vj, fj)
            return
        cfg = self.cfg
        self._grow_map(len(fi))
        K = np_of(self.intr.K)
        self.n_points, appended, merged, dropped = native.insert_points_v2(
            self.xyz, self.obs, self.feat2point, self.n_points, vi, vj, xyz, fi, fj,
            *self._match_lookup(), cfg.merge_point_min_match_distance,
            cfg.merge_feature_min_match_distance, cfg.strengthen_max_match_distance,
            cfg.cross_view_strengthen, poses=self.poses, feat_xy=self.feat_xy,
            focal=float(K[0, 0]), cx=float(K[0, 2]), cy=float(K[1, 2]),
            reproj_gate=cfg.min_reprojection_error)
        self._log(1, f"  merge (native): {appended} new points, {merged} merged, "
                     f"{dropped} dropped")

    def _insert_points(self, xyz: np.ndarray, vi: int, fi: np.ndarray, vj: int, fj: np.ndarray):
        """Merge newly triangulated points into the map, in numpy.

        Full SfM::mergeNewPointCloud semantics (SfM.cpp:530-629, constants
        :50-51): exact-feature claims extend tracks; transitive claims via
        the match matrix (legacy strengthening, MultiCameraPnP.cpp:393-441)
        attach to points found one hop away; points within
        merge_point_min_match_distance of an existing point merge when a
        2D feature match of distance < merge_feature_min_match_distance
        confirms them, and are dropped when close but unconfirmed
        (SfM.cpp:596-600); the rest append. Vectorized numpy, equal to the
        reference's numpy path array for array."""
        cfg = self.cfg
        F = cfg.max_features
        self._grow_map(len(fi))
        pair_row, right_of, rdist, left_of = self._match_lookup()

        xyz = np.asarray(xyz, np.float32)
        fi = np.asarray(fi, np.int64)
        fj = np.asarray(fj, np.int64)
        n = self.n_points
        # exact-feature claims
        pi = self.feat2point[vi, np.clip(fi, 0, F - 1)]
        pj = self.feat2point[vj, np.clip(fj, 0, F - 1)]
        target = np.where(pi >= 0, pi, pj).astype(np.int64)

        # transitive claims (legacy strengthening), each confirmed by
        # reprojection of the claimed map point into BOTH originating
        # views within the triangulation gate — a descriptor-only hop
        # chains wrong tracks on repetitive texture
        if cfg.cross_view_strengthen:
            # without per-feature pixel coordinates (feat_xy is None) the hop
            # is accepted on descriptor distance alone
            if self.feat_xy is not None:
                uv_i = self.feat_xy[vi, np.clip(fi, 0, F - 1)]
                uv_j = self.feat_xy[vj, np.clip(fj, 0, F - 1)]
                g2 = cfg.min_reprojection_error ** 2
                Kh = np_of(self.intr.K)

                def reproj_ok(p3d):
                    X = self.xyz[np.clip(p3d, 0, max(self.n_points - 1, 0))]
                    ok = np.ones(len(p3d), bool)
                    for v, uv in ((vi, uv_i), (vj, uv_j)):
                        Rt = self.poses[v]
                        pc = X @ Rt[:, :3].T + Rt[:, 3]
                        z = np.where(np.abs(pc[:, 2:3]) < 1e-9, 1e-9, pc[:, 2:3])
                        pr = (pc[:, :2] / z) * Kh[0, 0] + Kh[:2, 2]
                        ok &= (pc[:, 2] > 0) & (((pr - uv) ** 2).sum(1) < g2)
                    return ok
            else:
                def reproj_ok(p3d):
                    return np.ones(len(p3d), bool)

            for w in range(self.V):
                if w == vi or w == vj:
                    continue
                for v_new, f_new in ((vi, fi), (vj, fj)):
                    a, b = min(v_new, w), max(v_new, w)
                    p = pair_row[a, b]
                    table = right_of if v_new < w else left_of
                    cand = table[p, np.clip(f_new, 0, F)]
                    # hop match must be strong (same < 20 bound as the
                    # reference merge confirmation, SfM.cpp:51)
                    d = (rdist[p, np.clip(f_new, 0, F)] if v_new < w
                         else rdist[p, np.clip(cand, 0, F)])
                    p3d = self.feat2point[w, np.clip(cand, 0, F - 1)]
                    hit = ((cand >= 0) & (p3d >= 0)
                           & (d < cfg.strengthen_max_match_distance)
                           & reproj_ok(p3d))
                    target = np.where((target < 0) & hit, p3d, target)

        # 3D-distance merge with 2D feature confirmation
        close = np.zeros(len(fi), bool)
        if n > 0:
            ne, d2min = self._nearest_point(xyz)
            close = d2min < cfg.merge_point_min_match_distance ** 2
            obs_ne = self.obs[ne]                                     # (Mn, V)
            confirmed = np.zeros(len(fi), bool)
            for v_new, f_new in ((vi, fi), (vj, fj)):
                w = np.arange(self.V)
                a = np.minimum(v_new, w)
                b = np.maximum(v_new, w)
                p = pair_row[a, b]
                new_left = v_new < w
                lf = np.where(new_left[None, :], f_new[:, None], obs_ne)
                rf = np.where(new_left[None, :], obs_ne, f_new[:, None])
                lf_s = np.clip(lf, 0, F)
                hit = ((obs_ne >= 0) & (w[None, :] != v_new)
                       & (right_of[p[None, :], lf_s] == rf)
                       & (rdist[p[None, :], lf_s] < cfg.merge_feature_min_match_distance))
                confirmed |= hit.any(1)
            target = np.where((target < 0) & close & confirmed, ne, target)

        attach = target >= 0
        drop = ~attach & close
        new = ~attach & ~drop

        # attach both observations to the target point
        t_at = target[attach]
        self.obs[t_at, vi] = fi[attach]
        self.obs[t_at, vj] = fj[attach]
        self.feat2point[vi, fi[attach]] = t_at
        self.feat2point[vj, fj[attach]] = t_at

        n_new = int(new.sum())
        if n_new:
            self._grow_map(n_new)
            rows = np.arange(self.n_points, self.n_points + n_new)
            self.xyz[rows] = xyz[new]
            self.obs[rows, vi] = fi[new]
            self.obs[rows, vj] = fj[new]
            self.feat2point[vi, fi[new]] = rows
            self.feat2point[vj, fj[new]] = rows
            self.n_points += n_new
        self._log(1, lambda: f"  merge (numpy): {n_new} new points, {int(attach.sum())} "
                             f"merged, {int(drop.sum())} dropped")

    def find_2d3d_matches(self, view: int):
        """2D-3D correspondences for an unregistered view
        (SfM::find2D3DMatches, SfM.cpp:471-528): scan this view's matches
        against every good view; a match whose partner feature is claimed
        by a map point yields (feature uv, point xyz). On the native runtime
        when it is built, numpy otherwise."""
        if native.available() and self.match_idx is not None:
            pair_row = np.full((self.V * self.V,), -1, np.int32)
            for (a, b), p in self.pair_of.items():
                pair_row[a * self.V + b] = p
            return native.find_2d3d(self.feat2point, view, self.good_views, pair_row,
                                    self.match_idx, self.match_valid)
        point_of_feat = np.full((self.cfg.max_features,), -1, np.int64)
        for g in sorted(self.good_views):
            if g == view:
                continue
            a, b = (view, g) if view < g else (g, view)
            p = self.pair_of[(a, b)]
            idx = self.match_idx[p]
            valid = self.match_valid[p]
            if view < g:
                f_view, f_g = idx[:, 0], idx[:, 1]
            else:
                f_view, f_g = idx[:, 1], idx[:, 0]
            pts = self.feat2point[g, np.maximum(f_g, 0)]
            sel = valid & (pts >= 0) & (f_view >= 0)
            point_of_feat[f_view[sel]] = pts[sel]
        feats = np.nonzero(point_of_feat >= 0)[0]
        return feats, point_of_feat[feats]

    # ------------------------------------------------------------------ #
    # incremental registration
    # ------------------------------------------------------------------ #
    def add_more_views(self):
        """Register remaining views one by one (SfM.cpp:366-469).

        K is read once, before the first view, and Kinv at every view, as
        tpusfm reads them (``tpusfm/pipeline/incremental.py:853``, ``:879``,
        ``:928``): after a BA that moves the shared focal, PnP and
        triangulation normalise with the new focal and score and gate the
        reprojection in pixels with the first one (ROADMAP.md §3)."""
        K = self.intr.K
        with stage("sfm.hostloop.add_views", self._timings, "add_views_s"):
            while len(self.done_views) < self.V:
                with stage("sfm.hostloop.view"):
                    self._add_next_view(K)

    def _add_next_view(self, K: torch.Tensor):
        """One pass of ``add_more_views``: the pending view with the most
        2D-3D matches is marked done, then registered by PnP unless a gate
        rejects it, triangulated against every good view, merged, and the
        bundle adjusted."""
        cfg = self.cfg
        with stage("sfm.hostloop.find_2d3d", self._timings, "find_2d3d_s", add=True):
            candidates = {v: self.find_2d3d_matches(v)
                          for v in range(self.V) if v not in self.done_views}
        view = max(candidates, key=lambda v: len(candidates[v][0]))
        feats, pts = candidates[view]
        self.done_views.add(view)
        self._log(2, f"registering view {view} with {len(feats)} 2D-3D matches")
        if len(feats) < 6:
            self._log(3, f"view {view}: too few 2D-3D matches — skipped (SfM.cpp:398-403)")
            return

        n = min(len(feats), _PNP_CAP)
        Kinv = self.intr.Kinv
        with stage("sfm.hostloop.pnp", self._timings, "pnp_s", add=True):
            res = self._pnp(self._gen, self._dev(self.xyz[pts[:n]]),
                            self._dev(self.feat_xy[view][feats[:n]]),
                            torch.ones(n, dtype=torch.bool, device=self.device), K, Kinv)
            ok, pnp_ratio, n_inl = torch.stack([
                res.ok.to(torch.float32), res.inlier_ratio.to(torch.float32),
                res.inliers.sum().to(torch.float32)]).tolist()
        if not ok:
            self._log(3, f"view {view}: PnP inlier ratio {pnp_ratio:.2f} < "
                         f"{cfg.pose_inliers_minimal_ratio} — skipped")
            return
        # legacy sanity gate: inliers >= points/5 (MultiCameraPnP.cpp:287)
        if n_inl < cfg.min_pnp_inlier_fraction * n:
            self._log(3, f"view {view}: {int(n_inl)} PnP inliers < "
                         f"{cfg.min_pnp_inlier_fraction:.2f} x {n} correspondences "
                         f"— rejected (MultiCameraPnP.cpp:287)")
            return
        Rt_new = np_of(res.Rt)
        # legacy pose sanity gates (MultiCameraPnP.cpp:287-299):
        # runaway translation and incoherent (det != +1) rotations
        if np.linalg.norm(Rt_new[:, 3]) > cfg.max_translation_norm:
            self._log(3, f"view {view}: ||t||={np.linalg.norm(Rt_new[:, 3]):.1f} > "
                         f"{cfg.max_translation_norm} — rejected (MultiCameraPnP.cpp:292)")
            return
        if abs(np.linalg.det(Rt_new[:, :3]) - 1.0) > 1e-2:
            self._log(3, f"view {view}: incoherent rotation — rejected "
                         f"(CheckCoherentRotation, FindCameraMatrices.cpp:113-142)")
            return
        self.poses[view] = Rt_new
        self.pose_valid[view] = True

        # triangulate against every already-good view in one batched
        # call (SfM.cpp:413-461 without the serial loop): one slot per
        # good view with enough matches
        slots = [(g, *self._pair_match_uv(view, g)) for g in sorted(self.good_views)]
        slots = [s for s in slots if s[3].sum() >= 8]
        if slots:
            with stage("sfm.hostloop.triangulate", self._timings, "triangulate_s", add=True):
                xyzb, keepb, e1b, e2b = (np_of(x) for x in self._prune_triangulate(
                    self._gen, res.Rt, self._dev(self.poses[[s[0] for s in slots]]),
                    self._dev(np.stack([s[1] for s in slots])),
                    self._dev(np.stack([s[2] for s in slots])),
                    self._dev(np.stack([s[3] for s in slots])), K, Kinv))
            with stage("sfm.hostloop.merge", self._timings, "merge_s", add=True):
                for k, (g, _, _, _, idx) in enumerate(slots):
                    keep = keepb[k]
                    if cfg.adaptive_reprojection_filter and keep.any():
                        keep &= self._adaptive_filter(e1b[k], e2b[k], keep)
                    if keep.sum():
                        self._merge_points(xyzb[k][keep], view, idx[keep, 0], g, idx[keep, 1])
        self.good_views.add(view)
        self.adjust_bundle()
        self._notify()

    def _adaptive_filter(self, e1: np.ndarray, e2: np.ndarray, keep: np.ndarray) -> np.ndarray:
        """Legacy adaptive reprojection gate (MultiCameraPnP.cpp:347-358,
        Snavely §4.2): threshold = clamp(2.4 * 80th-percentile, keep_px,
        reject_px)."""
        cfg = self.cfg
        err = np.maximum(e1, e2)
        p = np.percentile(err[keep], cfg.adaptive_percentile)
        thr = min(max(cfg.adaptive_multiplier * p, cfg.adaptive_keep_px),
                  cfg.adaptive_reject_px)
        return err <= thr

    # ------------------------------------------------------------------ #
    # bundle adjustment
    # ------------------------------------------------------------------ #
    def adjust_bundle(self):
        """Global BA over all registered cameras + live points
        (SfM::adjustCurrentBundle, SfM.cpp:324-330)."""
        n = self.n_points
        if n == 0:
            return
        with stage("sfm.ba", self._timings, "ba_s", add=True) as ba:
            obs = self.obs[:n]
            uv = self.feat_xy[np.arange(self.V)[None, :], np.maximum(obs, 0)]      # (n, V, 2)
            out_Rt, out_pts, outK, summary = self._ba(
                self._dev(self.poses), self._dev(self.pose_valid), self._dev(self.xyz[:n]),
                torch.ones(n, dtype=torch.bool, device=self.device), self._dev(uv),
                self._dev(obs >= 0), self.intr.K)
            cost0, cost1, iters = torch.stack([
                summary.initial_cost.to(torch.float64), summary.final_cost.to(torch.float64),
                summary.iterations.to(torch.float64)]).tolist()
            improved = cost1 < cost0
            if improved:
                self.poses = np_of(out_Rt)
                self.xyz[:n] = np_of(out_pts)
                newK = np_of(outK)
                # rebuilt without the distortion coefficients, as the reference
                # does: the features are already undistorted
                self.intr = Intrinsics.create(float(newK[0, 0]), float(newK[0, 2]),
                                              float(newK[1, 2]), device=self.device)
        self._timings["ba_iters"] = self._timings.get("ba_iters", 0) + int(iters)
        self._log(2, f"BA: cost {cost0:.1f} -> {cost1:.1f} in {int(iters)} iters "
                     f"({ba.seconds:.2f}s)"
                     + ("" if improved else " — rejected (SfMBundleAdjustmentUtils.cpp:182-185)"))

    # ------------------------------------------------------------------ #
    # checkpoint / resume (same .npz keys as the reference: a checkpoint
    # written by either package loads in the other)
    # ------------------------------------------------------------------ #
    def save_checkpoint(self, path: str):
        """Serialize the full reconstruction state (track graph, poses,
        features, matches, intrinsics) to one .npz."""
        none = np.zeros(0)
        f = self.features
        np.savez_compressed(
            path,
            xyz=self.xyz[: self.n_points],
            obs=self.obs[: self.n_points],
            feat2point=self.feat2point,
            poses=self.poses,
            pose_valid=self.pose_valid,
            done_views=np.array(sorted(self.done_views), np.int32),
            good_views=np.array(sorted(self.good_views), np.int32),
            K=np_of(self.intr.K),
            feat_xy=self.feat_xy if self.feat_xy is not None else none,
            feat_valid=self.feat_valid if self.feat_valid is not None else none,
            feat_desc=np_of(f.desc) if f is not None else none,
            feat_score=np_of(f.score) if f is not None else none,
            feat_angle=np_of(f.angle) if f is not None else none,
            match_idx=self.match_idx if self.match_idx is not None else none,
            match_valid=self.match_valid if self.match_valid is not None else none,
            match_dist=self.match_dist if self.match_dist is not None else none,
        )

    def load_state(self, d):
        """Restore state from a mapping with save_checkpoint's keys (numpy
        arrays; the feature and match keys may be absent or empty). The
        incremental loop (add_more_views) can continue from here."""
        def get(key):
            return np.asarray(d[key]) if key in d and np.asarray(d[key]).size else None

        n = d["xyz"].shape[0]
        self.reset()
        self._grow_map(n)
        self.xyz[:n] = d["xyz"]
        self.obs[:n] = d["obs"]
        self.n_points = n
        self.feat2point = np.array(d["feat2point"], np.int32)
        self.poses = np.array(d["poses"], np.float32)
        self.pose_valid = np.array(d["pose_valid"], bool)
        self.done_views = set(int(v) for v in d["done_views"])
        self.good_views = set(int(v) for v in d["good_views"])
        K = np.asarray(d["K"])
        # without distortion coefficients, as in the reference's checkpoint
        self.intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]),
                                      device=self.device)
        self.feat_xy = get("feat_xy")
        self.feat_valid = get("feat_valid")
        if get("feat_desc") is not None:
            self.features = Features(
                xy=self._dev(d["feat_xy"], torch.float32),
                desc=self._dev(d["feat_desc"], torch.float32),
                score=self._dev(d["feat_score"], torch.float32),
                angle=self._dev(d["feat_angle"], torch.float32),
                valid=self._dev(d["feat_valid"], torch.bool))
        if get("match_idx") is not None:
            self.match_idx = np.array(d["match_idx"], np.int32)
            self.match_valid = np.array(d["match_valid"], bool)
            self.match_dist = get("match_dist")
            self._all_pairs()

    def load_checkpoint(self, path: str):
        """Restore state saved by save_checkpoint (of this package or of
        tpusfm)."""
        with np.load(path) as d:
            self.load_state(d)

    # ------------------------------------------------------------------ #
    # results
    # ------------------------------------------------------------------ #
    def mean_reprojection_error(self) -> float:
        n = self.n_points
        if n == 0:
            return float("nan")
        sel = (self.obs[:n] >= 0) & self.pose_valid[None, :]                  # (n, V)
        if not sel.any():
            return float("nan")
        uv = self.feat_xy[np.arange(self.V)[None, :], np.maximum(self.obs[:n], 0)]
        proj = camera.project_points(self._dev(self.poses), self.intr.K,
                                     self._dev(self.xyz[:n]))                 # (V, n, 2)
        err = np.linalg.norm(np_of(proj).transpose(1, 0, 2) - uv, axis=-1)
        return float(err[sel].mean())

    def _point_colors(self) -> np.ndarray:
        """RGB per point, averaged over originating views (legacy
        GetRGBForPointCloud, MultiCameraDistance.cpp:157-188); 255 without
        RGB images."""
        n = self.n_points
        out = np.full((n, 3), 255, np.uint8)
        if self.rgb is None:
            return out
        acc = np.zeros((n, 3), np.float64)
        cnt = np.zeros((n,), np.int64)
        for v in range(self.V):
            sel = self.obs[:n, v] >= 0
            if not sel.any():
                continue
            uv = self.feat_xy[v][self.obs[:n, v][sel]]
            x = np.clip(uv[:, 0].round().astype(int), 0, self.W - 1)
            y = np.clip(uv[:, 1].round().astype(int), 0, self.H - 1)
            acc[sel] += self.rgb[v][y, x]
            cnt[sel] += 1
        ok = cnt > 0
        out[ok] = (acc[ok] / cnt[ok, None]).round().astype(np.uint8)
        return out

    def _reconstruction(self, err: float) -> Reconstruction:
        n = self.n_points
        return Reconstruction(
            poses=self.poses.copy(), pose_valid=self.pose_valid.copy(),
            xyz=self.xyz[:n].copy(), rgb=self._point_colors(), obs=self.obs[:n].copy(),
            K=np_of(self.intr.K), mean_reprojection_error=err, stats=dict(self._timings))

    # ------------------------------------------------------------------ #
    # fused device-resident path (pipeline/engine.py)
    # ------------------------------------------------------------------ #
    def _fused_applicable(self) -> bool:
        return (
            self.cfg.fused
            and self.cfg.matcher == MatcherKind.RICH
            and not self.cfg.ba_refine_pp
            and not self._listeners          # observers need per-view host snapshots
        )

    def _run_fused(self) -> Reconstruction:
        """Device-resident execution: the whole incremental loop runs on the
        device (see pipeline/engine.py); the host performs a single image
        upload and a single batched result fetch."""
        from tpusfm_torch.pipeline.engine import FusedEngine

        if not hasattr(self, "_engine"):
            K = np_of(self.intr.K)
            self._engine = FusedEngine(self.cfg, self.V, self.H, self.W, f=float(K[0, 0]),
                                       cx=float(K[0, 2]), cy=float(K[1, 2]), device=self.device)
        extract_fn = lambda imgs: self._undistort_features(self._extract(imgs))
        gray_u8 = (np.clip(self.gray, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        self._fused_runs += 1
        out = self._engine.run(gray_u8, extract_fn, self._match,
                               seed=self._seed + self._fused_runs)
        if not bool(out["seeded"]):
            raise RuntimeError("no baseline pair could seed the reconstruction "
                               "(reference aborts the same way, MultiCameraPnP.cpp:144-147)")
        # mirror results into the host-side state for downstream consumers
        n = int(out["n_points"])
        if n >= self._engine.CAP:
            warnings.warn(f"map saturated engine_point_capacity={self._engine.CAP}: new points "
                          "were routed to the trash row; raise "
                          "SfMConfig.engine_point_capacity to keep them", RuntimeWarning)
        self.n_points = n
        self.xyz = out["xyz"][:n].copy()
        self.obs = out["obs"][:n].copy()
        self.poses = out["poses"].copy()
        self.pose_valid = out["pose_valid"].copy()
        self.feat_xy = out["feat_xy"]
        self.feat_valid = out["feat_valid"]
        self.done_views = set(range(self.V))
        self.good_views = set(int(v) for v in np.nonzero(self.pose_valid)[0])
        # keep the calibrated principal point and the distortion
        # coefficients: a repeated run() must keep undistorting features
        self.intr = Intrinsics.create(float(out["focal"]), self._engine.cx, self._engine.cy,
                                      dist=np_of(self.intr.dist), device=self.device)
        self._timings.update(self._engine.timings)
        stats = out["stats"]
        self._timings["ba_iters"] = int(stats[:, 9].sum())
        for r, row in enumerate(stats):
            if r == 0:
                i, j = int(row[0]) // 100, int(row[0]) % 100
                self._log(2, f"baseline {i},{j}: {int(row[4])} seed points "
                             f"(pose inliers {row[2]:.2f}), BA {row[7]:.1f} -> {row[8]:.1f} "
                             f"in {int(row[9])} iters")
            elif r == len(stats) - 1:
                if row[3] > 0:
                    self._log(2, f"final BA: {row[7]:.1f} -> {row[8]:.1f} "
                                 f"in {int(row[9])} iters")
            elif row[1] > 0 or row[3] > 0:
                self._log(2, f"view {int(row[0])}: {int(row[1])} 2D-3D matches, "
                             f"PnP ratio {row[2]:.2f}, ok={bool(row[3])}, "
                             f"+{int(row[4])} new / {int(row[5])} merged / "
                             f"{int(row[6])} dropped, BA {row[7]:.1f} -> {row[8]:.1f} "
                             f"in {int(row[9])} iters")
        err = float(out["mean_err"])
        self._log(2, f"done (fused): {n} points, {int(self.pose_valid.sum())}/{self.V} "
                     f"cameras, mean reprojection error {err:.3f}px, "
                     f"{self._timings['total_s']:.2f}s")
        return self._reconstruction(err)

    def run(self) -> Reconstruction:
        """Full pipeline (SfM::runSfM, SfM.cpp:63-95)."""
        with stage("sfm.run"):
            if self._fused_applicable():
                return self._run_fused()
            with stage("sfm.total", self._timings, "total_s"):
                self.extract()
                self.match()
                if not self.find_baseline_triangulation():
                    raise RuntimeError("no baseline pair could seed the reconstruction (reference "
                                       "aborts the same way, MultiCameraPnP.cpp:144-147)")
                self.add_more_views()
            err = self.mean_reprojection_error()
            self._log(2, f"done: {self.n_points} points, {int(self.pose_valid.sum())}/{self.V} "
                         f"cameras, mean reprojection error {err:.3f}px, "
                         f"{self._timings['total_s']:.2f}s")
            return self._reconstruction(err)


def run_sfm(directory: str, config: Optional[SfMConfig] = None,
            output_prefix: Optional[str] = None, device="cuda") -> Reconstruction:
    """End-to-end convenience entry (main.cpp:71-78 equivalent)."""
    from tpusfm_torch.io.images import load_image_directory

    cfg = config or SfMConfig()
    imgs = load_image_directory(directory, cfg.downscale)
    rec = SfMPipeline(imgs.gray, cfg, images_rgb=imgs.rgb, device=device).run()
    if output_prefix:
        rec.save_ply(output_prefix)
    return rec
