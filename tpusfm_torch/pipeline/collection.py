"""Collection-scale incremental SfM — the long-dimension architecture.

Counterpart of ``tpusfm/pipeline/collection.py``. The classic host loop
(``pipeline/incremental.py``) and the fused engine (``pipeline/engine.py``)
mirror the reference's all-pairs match matrix (SfM.cpp:157-212) and
per-insert cloud-merge scans (SfM.cpp:530-629); their lookup tables are
O(V^2 F) and cannot reach collections of hundreds of images. This module
keeps the same incremental semantics for the long view axis:

  * windowed pair graph — view i is matched against i+1..i+window
    (+ optional wraparound across a closed loop), O(V*window) pairs
    instead of O(V^2), matched in chunks of ``collection_match_chunk``
    pairs: on CUDA by the streaming top-2 kernel (``features/pallas_match``)
    when it applies, by the dense matcher otherwise; with a ``mesh`` the
    chunk length is a multiple of its size, the last chunk is padded to one
    with (0, 1) pairs, and each chunk is split over the ranks
    (``dist/matching.py``).
  * one global TRACK GRAPH built up front: connected components over the
    match edges via vectorised pointer-jumping label propagation. This
    replaces the reference's exact-feature/transitive/3D-distance merge
    per insertion (SfM.cpp:530-629, MultiCameraPnP.cpp:393-441) — a
    track IS the transitive closure those scans approximate one hop at
    a time.
  * incremental registration keeps the reference's add-view semantics
    (SfM.cpp:366-469): next view = most 2D-3D correspondences, RANSAC
    PnP with the pose-inlier >= 0.5 gate (SfMStereoUtilities.cpp:231)
    and the legacy ||t|| / inlier-fraction sanity gates
    (MultiCameraPnP.cpp:287-299), then per-track multi-view triangulation
    with the reprojection gate (SfMStereoUtilities.cpp:184-190).
  * BA is the matrix-free COO Schur solver (``ba/sparse.py``): a sliding
    local window every registration, a global solve every
    ``collection_global_ba_interval`` views and at the end. The reference
    runs a full dense-Schur Ceres solve after every view (SfM.cpp:464-466),
    which is O(V) global solves; local-window BA is the standard scalable
    equivalent. With a ``mesh`` the global solves are point-sharded over
    its ranks (``dist/sparse_ba.py``) and run their whole iteration budget
    in one call; on one device they continue in chunks of ``_ba_chunk``
    iterations and stop on a stall, so the two differ by design, as in
    tpusfm.

With a mesh every rank runs the whole pipeline (SPMD) from the same seed,
so each host decision comes out the same on every rank; a checksum of the
registered views is compared across the ranks after every registration
attempt, and a disagreement raises instead of leaving the ranks waiting
in different collectives.

The track graph (observations as one COO list over (track, view, feature),
poses, track points) is host numpy, index-heavy and mutated per view;
tensors go to the device per solver call. PyTorch compiles nothing, so the
reference's paddings to static shapes are gone: every device call gets the
real rows, and only the caps remain (``_TRI_CHUNK`` tracks per triangulation
call, ``collection_match_chunk`` pairs per matcher call). Random draws come
from one ``torch.Generator`` on the pipeline's device, made from ``seed``.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpusfm_torch import camera
from tpusfm_torch.ba.sparse import adjust_bundle_sparse
from tpusfm_torch.config import EssentialDecomposition, SfMConfig
from tpusfm_torch.dist import adjust_bundle_sparse_sharded, match_all_pairs_sharded
from tpusfm_torch.features import pallas_match
from tpusfm_torch.features.detect import extract_features
from tpusfm_torch.features.match import match_all_pairs
from tpusfm_torch.geometry.essential import epipolar_inliers, find_camera_from_match
from tpusfm_torch.geometry.homography import find_homography_inliers
from tpusfm_torch.geometry.linalg import smallest_eigenvector_psd
from tpusfm_torch.geometry.pnp import find_camera_pose_2d3d
from tpusfm_torch.geometry.triangulation import inv3x3, triangulate_hartley_sturm
from tpusfm_torch.types import Features, Intrinsics, Matches, np_of

_PAIR_ROWS = 128        # pairs per epipolar-prune / homography-ranking call
_TRI_CHUNK = 65536      # tracks per multi-view triangulation call
_TRI_K = 8              # max observations per multi-view triangulation


def window_pairs(V: int, window: int, wraparound: bool = False) -> np.ndarray:
    """Sequential pair list (P, 2) with i < j: (i, i+1..i+window), plus the
    seam pairs of a closed loop when wraparound (emitted as (j % V, i) so
    the i < j canonical ordering holds)."""
    pairs = set()
    for i in range(V):
        for d in range(1, window + 1):
            j = i + d
            if j < V:
                pairs.add((i, j))
            elif wraparound:
                pairs.add((j % V, i))
    return np.array(sorted(pairs), np.int32)


def tri_rows(Rt1, Rt2, uv1, uv2, valid, K, Kinv, *, gate: float, cos_min: float,
             iterations: int, eps: float):
    """Two-view triangulation of B rows, each with its own pair of poses:
    Rt1, Rt2 (B, 3, 4), uv1, uv2 (B, 2), valid (B,) -> X (B, 3), keep (B,).
    Gates: reprojection <= gate in both views, in front of both cameras,
    ray parallax of at least acos(cos_min), finite."""
    a, b = uv1[:, None, :], uv2[:, None, :]
    X = triangulate_hartley_sturm(Rt1, Rt2, camera.normalize_points(Kinv, a),
                                  camera.normalize_points(Kinv, b), iterations, eps)  # (B,1,3)
    e1 = torch.linalg.vector_norm(camera.project_points(Rt1, K, X) - a, dim=-1)[:, 0]
    e2 = torch.linalg.vector_norm(camera.project_points(Rt2, K, X) - b, dim=-1)[:, 0]
    z1 = camera.transform_points(Rt1, X)[:, 0, 2]
    z2 = camera.transform_points(Rt2, X)[:, 0, 2]
    X = X[:, 0]
    # parallax-angle gate (see SfMConfig.min_triangulation_angle_deg)
    ray1 = X - camera.camera_center(Rt1)
    ray2 = X - camera.camera_center(Rt2)
    cosang = (ray1 * ray2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(ray1, dim=-1) * torch.linalg.vector_norm(ray2, dim=-1),
        min=1e-12)
    keep = ((e1 <= gate) & (e2 <= gate) & (z1 > 0) & (z2 > 0) & (cosang <= cos_min)
            & torch.isfinite(X).all(-1))
    return X, keep & valid


def tri_multi(Rt, uv, msk, K, Kinv, *, gate: float, cos_min: float):
    """Batched N-view triangulation: DLT over all observations, then
    Gauss-Newton refinement of the 3D point, then per-observation gates.
    Rt (B, K, 3, 4), uv (B, K, 2), msk (B, K) float -> X (B, 3), keep (B,).

    The 2-view widest-baseline triangulation breaks down under accumulated
    pose drift: the two chosen views disagree by the full drift across the
    window and the dual reprojection gate mass-rejects. The N-view solve
    spreads the residual over every local view — drift-consistent points
    that keep the frontier fed and give the global BA long-range
    constraints. This is the standard multi-view DLT [HZ 12.2] the
    reference's per-pair loop approximates one pair at a time
    (MultiCameraPnP.cpp:308-444).

    No host sync: the 4x4 null vector comes from inverse iteration
    (``smallest_eigenvector_psd``) and the 3x3 Gauss-Newton systems from the
    closed-form inverse, neither of which reads an error flag back."""
    x = camera.normalize_points(Kinv, uv)                        # (B, K, 2)
    # DLT rows: x * P[2] - P[0], y * P[2] - P[1]
    r0 = x[..., 0:1] * Rt[:, :, 2] - Rt[:, :, 0]                 # (B, K, 4)
    r1 = x[..., 1:2] * Rt[:, :, 2] - Rt[:, :, 1]
    m2 = torch.cat([msk, msk], 1)                                # (B, 2K)
    wA = torch.cat([r0, r1], 1) * m2[..., None]                  # (B, 2K, 4)
    Xh = smallest_eigenvector_psd(wA.transpose(1, 2) @ wA)       # (B, 4)
    X = Xh[:, :3] / torch.where(Xh[:, 3:].abs() < 1e-12, 1e-12, Xh[:, 3:])
    R, t = Rt[..., :3], Rt[..., 3]                               # (B,K,3,3), (B,K,3)
    f, pp = K[0, 0], K[:2, 2]
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)

    def project(X):
        pc = (R * X[:, None, None, :]).sum(-1) + t               # (B, K, 3)
        z = torch.where(pc[..., 2:].abs() < 1e-9, 1e-9, pc[..., 2:])
        return pc, z, pc[..., :2] / z * f + pp

    for _ in range(5):
        # Gauss-Newton on pixel reprojection over all observations
        pc, z, pr = project(X)
        r = (pr - uv) * msk[..., None]                           # (B, K, 2)
        # d(pr)/dX = f/z * [R0 - x_n R2; R1 - y_n R2]
        J0 = (R[:, :, 0] - pc[..., 0:1] / z * R[:, :, 2]) * (f / z)
        J1 = (R[:, :, 1] - pc[..., 1:2] / z * R[:, :, 2]) * (f / z)
        J = torch.cat([J0, J1], 1) * m2[..., None]               # (B, 2K, 3)
        rr = torch.cat([r[..., 0], r[..., 1]], 1)                # (B, 2K)
        H = J.transpose(1, 2) @ J + 1e-6 * eye3
        g = (J * rr[..., None]).sum(1)                           # (B, 3)
        dX = (inv3x3(H, 1e-30) * g[:, None, :]).sum(-1)
        dX = torch.where(torch.isfinite(dX).all(-1, keepdim=True), dX, 0.0)
        X = X - dX

    pc, z, pr = project(X)
    err = torch.linalg.vector_norm(pr - uv, dim=-1)              # (B, K)
    n = torch.clamp(msk.sum(1), min=1.0)
    ok_err = ((err <= gate) * msk).sum(1) >= n                   # every observation in gate
    ok_z = ((pc[..., 2] > 0) * msk).sum(1) >= n                  # cheirality, all
    # parallax: widest pair of camera centers vs point
    rays = X[:, None, :] - camera.camera_center(Rt)              # (B, K, 3)
    rn = rays / torch.clamp(torch.linalg.vector_norm(rays, dim=-1, keepdim=True), min=1e-12)
    cosm = rn @ rn.transpose(1, 2)                               # (B, K, K)
    pairm = (msk[:, :, None] * msk[:, None, :]) > 0
    cmin = torch.where(pairm, cosm, 1.0).flatten(1).min(1).values
    keep = ok_err & ok_z & (cmin <= cos_min) & torch.isfinite(X).all(-1) & (n >= 2)
    return X, keep


@dataclasses.dataclass
class CollectionReconstruction:
    """Collection-scale result: the track graph stays COO (a dense (N, V)
    observation table at V=5000 would be the exact scaling bug this
    pipeline exists to avoid)."""

    poses: np.ndarray          # (V, 3, 4)
    pose_valid: np.ndarray     # (V,)
    xyz: np.ndarray            # (N, 3)
    rgb: np.ndarray            # (N, 3) uint8
    obs_point: np.ndarray      # (O,) int32 point index
    obs_view: np.ndarray       # (O,) int32 view index
    obs_feat: np.ndarray       # (O,) int32 feature index
    K: np.ndarray              # (3, 3)
    mean_reprojection_error: float
    stats: Dict

    @property
    def num_points(self) -> int:
        return self.xyz.shape[0]

    def save_ply(self, prefix: str):
        from tpusfm_torch.io.ply import save_cameras_ply, save_point_cloud_ply

        save_point_cloud_ply(prefix + "_points.ply", self.xyz, self.rgb)
        scale = float(np.median(np.linalg.norm(
            self.xyz - np.median(self.xyz, 0), axis=1))) if len(self.xyz) else 1.0
        save_cameras_ply(prefix + "_cameras.ply", self.poses, self.pose_valid,
                         scale=max(scale * 0.2, 1e-3))


class CollectionPipeline:
    """Track-graph incremental SfM over a windowed pair graph.

    Same public shape as SfMPipeline (construct -> run() -> result), but
    every data structure is O(V*window + O) instead of O(V^2):
    observations are one COO list over (track, view, feature). Runs on
    ``device`` ("cuda" unless the caller asks for "cpu"), or on the device
    of ``mesh`` (``dist.make_mesh``) when one is given.
    """

    def __init__(self, images_gray: np.ndarray, config: Optional[SfMConfig] = None,
                 intrinsics: Optional[Intrinsics] = None, mesh=None,
                 pairs: Optional[np.ndarray] = None, seed: int = 0, device="cuda"):
        self.cfg = cfg = config or SfMConfig()
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.gray = np.asarray(images_gray, np.float32)
        self.V, self.H, self.W = self.gray.shape
        if intrinsics is not None:
            K = np_of(intrinsics.K)
            self._set_intrinsics(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
        else:
            self._set_intrinsics(cfg.default_focal / max(cfg.downscale, 1e-6),
                                 self.W / 2.0, self.H / 2.0)
        self.pairs = (np.asarray(pairs, np.int32) if pairs is not None else
                      window_pairs(self.V, cfg.collection_window, cfg.collection_wraparound))
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._timings: Dict = {}
        self._build_kernels()
        # --- state ---
        self.feat_xy: Optional[np.ndarray] = None     # (V, F, 2)
        self.feat_valid: Optional[np.ndarray] = None  # (V, F)
        self.features: Optional[Features] = None      # on the device; None once matched
        self._extracted = False                       # run() skips extract() when set
        self.match_idx: Optional[np.ndarray] = None   # (P, M, 2)
        self.match_valid: Optional[np.ndarray] = None
        self.poses = np.zeros((self.V, 3, 4), np.float32)
        self.pose_valid = np.zeros(self.V, bool)
        self.reg_order: List[int] = []
        # track graph (filled by build_tracks)
        self.T = 0
        self.track_xyz: Optional[np.ndarray] = None   # (T, 3)
        self.track_ok: Optional[np.ndarray] = None    # (T,)
        self.obs_track = self.obs_view = self.obs_feat = None
        self.obs_uv = self.obs_alive = None
        self.node2track: Optional[np.ndarray] = None  # (V, F)
        self._ba_iters = 0
        self._last_ba = (0, 0.0, 0.0)   # the latest solve: iterations, initial and final cost

    # ------------------------------------------------------------------ #
    def _set_intrinsics(self, f: float, cx: float, cy: float):
        """K on the device for the solvers and on the host for the track
        graph's own reprojections (no read-back per use)."""
        self.intr = Intrinsics.create(f, cx, cy, device=self.device)
        self._K_host = np.array([[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]], np.float32)

    def _log(self, level: int, msg: str):
        if level >= self.cfg.console_debug_level:
            print(f"[tpusfm_torch.collection] {msg}", flush=True)

    def _dev(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype).to(self.device)

    def _add_time(self, key: str, since: float):
        self._timings[key] = self._timings.get(key, 0.0) + time.perf_counter() - since

    def _build_kernels(self):
        """The device stages, bound to the configuration. All take K/Kinv as
        arguments, so BA's focal refinements reach them. The geometry
        functions take a leading batch axis (pairs) as they are."""
        cfg = self.cfg
        self._extract = functools.partial(
            extract_features, max_features=cfg.max_features, desc_bits=cfg.desc_bits,
            pyramid_levels=cfg.pyramid_levels, pyramid_scale=cfg.pyramid_scale,
            fast_threshold=cfg.fast_threshold / 255.0, score_kind=cfg.detector_score,
            sampling=cfg.descriptor_sampling)
        # the streaming kernel instead of the F x F distance matrix (identical
        # match outputs); it has no cross-check and takes feature budgets that
        # are multiples of 256
        self._streaming = (self.device.type == "cuda" and not cfg.cross_check
                           and cfg.max_features % 256 == 0)
        self._chunk = cfg.collection_match_chunk
        if self.mesh is not None:
            self._chunk = max(self._chunk // self.mesh.size * self.mesh.size, self.mesh.size)

            def match_sharded(feats, signs, pairs):
                # (0, 1) pairs pad a chunk to a multiple of the mesh size; their
                # matches are dropped
                n = len(pairs)
                pad = pairs.new_tensor([[0, 1]]).expand(-n % self.mesh.size, 2)
                if signs is not None:
                    feats = dataclasses.replace(feats, desc=signs)
                m = match_all_pairs_sharded(
                    self.mesh, feats, torch.cat([pairs, pad]), ratio=cfg.match_ratio,
                    cross_check=cfg.cross_check, max_matches=cfg.max_matches)
                return Matches(idx=m.idx[:n], dist=m.dist[:n], valid=m.valid[:n])

            self._match_chunk = match_sharded
        elif self._streaming:
            self._match_chunk = lambda feats, signs, pairs: pallas_match.match_pairs(
                signs, feats.valid, pairs, ratio=cfg.match_ratio, max_matches=cfg.max_matches)
        else:
            self._match_chunk = lambda feats, signs, pairs: match_all_pairs(
                feats, pairs, ratio=cfg.match_ratio, cross_check=cfg.cross_check,
                max_matches=cfg.max_matches)

        self._h_rank = lambda gen, uv1, uv2, mask: find_homography_inliers(
            gen, uv1, uv2, mask, threshold_px=cfg.ransac_threshold_px,
            hypotheses=cfg.ransac_hypotheses // 2)[0]

        def epi_prune(gen, uv1, uv2, mask, K, Kinv):
            inl = epipolar_inliers(gen, uv1, uv2, mask, K, Kinv,
                                   threshold_px=cfg.epipolar_prune_threshold_px,
                                   hypotheses=cfg.epipolar_prune_hypotheses)
            # only prune pairs with enough matches for the 8-pt solver
            return torch.where(mask.sum(-1, keepdim=True) >= 16, inl & mask, mask)

        self._epi_prune = epi_prune
        self._two_view = functools.partial(
            find_camera_from_match, threshold_px=cfg.essential_threshold_px,
            hypotheses=cfg.ransac_hypotheses,
            use_horn=cfg.decomposition == EssentialDecomposition.HORN90,
            min_front_frac=cfg.cheirality_min_frac,
            max_front_reproj_px=cfg.cheirality_max_reproj_px)
        self._pnp = functools.partial(
            find_camera_pose_2d3d, threshold_px=cfg.pnp_threshold_px,
            hypotheses=cfg.pnp_hypotheses, min_inlier_ratio=cfg.pose_inliers_minimal_ratio)

        gate = cfg.min_reprojection_error
        cos_min = float(np.cos(np.radians(cfg.min_triangulation_angle_deg)))
        self._tri_rows = functools.partial(tri_rows, gate=gate, cos_min=cos_min,
                                           iterations=cfg.triangulation_iters,
                                           eps=cfg.triangulation_eps)
        self._tri_multi = functools.partial(tri_multi, gate=gate, cos_min=cos_min)
        self._tri_k = _TRI_K

        # Local BA must NOT refine the shared focal: with most cameras
        # frozen it would absorb window-local error into the one global
        # focal and silently corrupt every frozen view. Only the global
        # solves touch it (matching the reference, whose adjustBundle is
        # always global, SfMBundleAdjustmentUtils.cpp:138).
        self._local_ba = functools.partial(
            adjust_bundle_sparse, max_iterations=cfg.ba_incremental_iterations,
            function_tolerance=cfg.ba_incremental_tolerance,
            initial_lambda=cfg.ba_initial_lambda, share_focal=False)

        # Schur-CG information propagates ~one camera hop per CG iteration
        # through the camera-coupling graph, so the CG depth must scale
        # with the camera count or drift accumulates into loop-scale modes
        # the solver can never reach. Interval solves keep the ring
        # continuously distributed; the final polish gets a deeper budget
        # still; both caps step down for large collections.
        # Every GLOBAL solve runs as chunks of <= _ba_chunk LM iterations
        # with host-side continuation. Each chunk re-enters with the
        # previous chunk's poses/points/K, the initial lambda and a fresh
        # nu, and the two exits of the continuation (a chunk that stopped
        # early, a chunk-to-chunk cost stall) decide how many iterations
        # run: the chunks are part of the result, as in the reference.
        self._ba_chunk = 5
        big = self.V > 1000
        self._interval_cg = int(min(max(48, self.V), 96 if big else 192))
        # the chunk length is read at call time, like the reference's closure
        self._global_ba = lambda *a: adjust_bundle_sparse(
            *a, max_iterations=self._ba_chunk,
            function_tolerance=cfg.ba_function_tolerance,
            initial_lambda=cfg.ba_initial_lambda, share_focal=cfg.ba_share_focal,
            cg_iterations=self._interval_cg, huber_delta=cfg.collection_huber_px)
        self._final_cg = int(min(max(64, self.V), 128 if big else 256))
        self._final_ba = lambda *a: adjust_bundle_sparse(
            *a, max_iterations=self._ba_chunk,
            function_tolerance=cfg.ba_function_tolerance * 0.1,
            initial_lambda=cfg.ba_initial_lambda, share_focal=cfg.ba_share_focal,
            cg_iterations=self._final_cg, huber_delta=cfg.collection_huber_px)

    # ------------------------------------------------------------------ #
    # stages
    # ------------------------------------------------------------------ #
    def extract(self, chunk: int = 64):
        """Batched detection over all views, chunked to bound the response
        -map working set (SfM.cpp:141-154 semantics at collection scale)."""
        t0 = time.perf_counter()
        parts = [self._extract(self._dev(self.gray[s:s + chunk]))
                 for s in range(0, self.V, chunk)]
        self.features = Features(*(
            torch.cat([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(Features)))
        self.feat_xy = np_of(self.features.xy)
        self.feat_valid = np_of(self.features.valid)
        self._extracted = True
        self._timings["features_s"] = time.perf_counter() - t0
        self._log(1, f"extracted features for {self.V} views "
                     f"({self._timings['features_s']:.2f}s)")

    def match(self):
        """Windowed pair matching in chunks of ``collection_match_chunk``
        pairs (the last one shorter; with a mesh, chunks of a multiple of its
        size, sharded over its ranks) — the counterpart of the reference's
        std::thread pair fan-out, SfM.cpp:165-211."""
        cfg = self.cfg
        t0 = time.perf_counter()
        P = len(self.pairs)
        CH = self._chunk
        feats = self.features
        # ±1 int8 descriptors for the streaming kernel, once for all chunks
        signs = pallas_match.descriptor_signs(feats.desc) if self._streaming else None
        pairs = self._dev(self.pairs, torch.int64)
        chunks = [self._match_chunk(feats, signs, pairs[s:s + CH]) for s in range(0, P, CH)]
        self.match_idx = np.concatenate([np_of(m.idx) for m in chunks], 0)
        self.match_valid = np.concatenate([np_of(m.valid) for m in chunks], 0)
        # Descriptors are dead weight past this point (tracks consume only
        # feat_xy, which lives host-side): drop every reference so the
        # device memory goes back to the allocator for the global BA.
        del feats, signs, chunks
        self.features = None
        self._timings["matching_s"] = time.perf_counter() - t0
        self._log(1, f"matched {P} pairs ({self._timings['matching_s']:.2f}s, "
                     f"{'mesh' if self.mesh is not None else '1 dev'})")
        if cfg.epipolar_prune:
            self.prune_matches()

    def _pairs_uv(self, rows: np.ndarray):
        """Aligned (uv1, uv2) (n, M, 2) of pair rows; invalid slots gather
        feature 0 and stay masked."""
        i = self.pairs[rows, 0]
        j = self.pairs[rows, 1]
        idx = self.match_idx[rows]
        return (self.feat_xy[i[:, None], np.clip(idx[:, :, 0], 0, None)],
                self.feat_xy[j[:, None], np.clip(idx[:, :, 1], 0, None)])

    def prune_matches(self):
        """Per-pair epipolar RANSAC match pruning BEFORE track building
        (legacy PruneMatchesBasedOnF, MultiCameraPnP.cpp:463-485).

        At collection scale this is load-bearing, not a refinement: the
        track graph is a transitive closure, so a single geometrically
        wrong match chains two physical points into ONE track; BA then
        splits the difference across both and the map silently deforms."""
        t0 = time.perf_counter()
        P = len(self.pairs)
        before = int(self.match_valid.sum())
        for s in range(0, P, _PAIR_ROWS):
            rows = np.arange(s, min(s + _PAIR_ROWS, P))
            uv1, uv2 = self._pairs_uv(rows)
            self.match_valid[rows] = np_of(self._epi_prune(
                self._gen, self._dev(uv1), self._dev(uv2), self._dev(self.match_valid[rows]),
                self.intr.K, self.intr.Kinv))
        after = int(self.match_valid.sum())
        self._timings["prune_s"] = time.perf_counter() - t0
        self._log(1, f"epipolar prune: {before} -> {after} matches "
                     f"({self._timings['prune_s']:.2f}s)")

    def build_tracks(self):
        """Connected components over match edges -> global track graph.

        Vectorised pointer-jumping label propagation: every (view, feat)
        node takes the min label over its match neighbors, then labels
        chase their own targets (lab = lab[lab]), doubling the propagation
        distance per sweep — O(E) work per sweep, O(log diameter) sweeps.
        Tracks observing one view twice are cut at that view (the
        ambiguous observations are dropped — the reference's merge would
        have chained them into one bad point, SfM.cpp:566-587).
        Integer work on the host, array for array the reference's.
        """
        t0 = time.perf_counter()
        F = self.cfg.max_features
        vi = self.pairs[:, 0:1].astype(np.int64)   # (P, 1)
        vj = self.pairs[:, 1:2].astype(np.int64)
        li = self.match_idx[:, :, 0].astype(np.int64)
        ri = self.match_idx[:, :, 1].astype(np.int64)
        ok = self.match_valid
        a = (vi * F + np.clip(li, 0, F - 1))[ok]   # (E,)
        b = (vj * F + np.clip(ri, 0, F - 1))[ok]

        lab = np.arange(self.V * F, dtype=np.int64)
        for _ in range(64):
            prev = lab
            nxt = lab.copy()
            np.minimum.at(nxt, a, lab[b])
            np.minimum.at(nxt, b, lab[a])
            nxt = nxt[nxt]           # pointer jumping
            nxt = nxt[nxt]
            lab = nxt
            if np.array_equal(lab, prev):
                break

        nodes = np.unique(np.concatenate([a, b]))
        roots = lab[nodes]
        track_of_node, obs_track = np.unique(roots, return_inverse=True)
        self.T = len(track_of_node)
        self.obs_track = obs_track.astype(np.int64)
        self.obs_view = (nodes // F).astype(np.int32)
        self.obs_feat = (nodes % F).astype(np.int32)
        self.obs_uv = self.feat_xy[self.obs_view, self.obs_feat].astype(np.float32)
        self.obs_alive = np.ones(len(nodes), bool)

        # cut per-view conflicts: a track with two features in one view
        key = self.obs_track * self.V + self.obs_view
        _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
        self.obs_alive &= counts[inv] == 1

        # drop tracks left with < 2 observations
        live = np.bincount(self.obs_track[self.obs_alive], minlength=self.T)
        self.obs_alive &= live[self.obs_track] >= 2

        self.track_xyz = np.zeros((self.T, 3), np.float32)
        self.track_ok = np.zeros(self.T, bool)
        self.node2track = np.full((self.V, F), -1, np.int64)
        keep = self.obs_alive
        self.node2track[self.obs_view[keep], self.obs_feat[keep]] = self.obs_track[keep]
        self._timings["tracks_s"] = time.perf_counter() - t0
        self._log(1, f"track graph: {self.T} tracks, "
                     f"{int(self.obs_alive.sum())} observations "
                     f"({self._timings['tracks_s']:.2f}s)")

    # ------------------------------------------------------------------ #
    def find_baseline(self) -> bool:
        """Baseline pair: ascending homography-inlier ratio among candidate
        pairs, first pair passing the pose gates wins (SfM.cpp:215-321,
        sortViewsForBaseline :333-364)."""
        cfg = self.cfg
        t0 = time.perf_counter()
        counts = self.match_valid.sum(1)
        cand = np.nonzero(counts >= cfg.min_point_count_for_homography)[0]
        if len(cand) == 0:
            return False
        # H-inlier ratio, chunked batch
        ratios = np.full(len(cand), 2.0, np.float64)
        for s in range(0, len(cand), _PAIR_ROWS):
            rows = cand[s:s + _PAIR_ROWS]
            uv1, uv2 = self._pairs_uv(rows)
            msk = self.match_valid[rows]
            cnt = np_of(self._h_rank(self._gen, self._dev(uv1), self._dev(uv2), self._dev(msk)))
            ratios[s:s + len(rows)] = cnt / np.maximum(msk.sum(1), 1)
        order = cand[np.argsort(ratios)]

        # The reference iterates over EVERY pair in ascending H-inlier
        # order until one passes the pose gates (SfM.cpp:236-320). A
        # fixed small try budget breaks closed-loop collections whose
        # widest-window pairs alias under repetitive texture: all the
        # best-ranked (widest) pairs fail the inlier-ratio gate and the
        # narrow, matchable pairs are never reached.
        K, Kinv = self.intr.K, self.intr.Kinv
        Rt1 = torch.eye(3, 4, dtype=torch.float32, device=self.device)
        for p in order:
            i, j = map(int, self.pairs[p])
            uv1, uv2 = (self._dev(x[0]) for x in self._pairs_uv(np.array([p])))
            msk = self._dev(self.match_valid[p])
            res = self._two_view(self._gen, uv1, uv2, msk, K, Kinv)
            ok, ratio = torch.stack([res.ok.to(torch.float32),
                                     res.inlier_ratio.to(torch.float32)]).tolist()
            if not ok or ratio < cfg.pose_inliers_minimal_ratio:
                self._log(0, f"baseline {i},{j}: pose gate failed (ratio {ratio:.2f})")
                continue
            B = uv1.shape[0]
            X, keep = self._tri_rows(Rt1.expand(B, 3, 4), res.Rt.expand(B, 3, 4),
                                     uv1, uv2, res.inliers, K, Kinv)
            keep_np = np_of(keep)
            n_seed = int(keep_np.sum())
            if n_seed < cfg.min_point_count_for_homography // 2:
                self._log(0, f"baseline {i},{j}: only {n_seed} seed points")
                continue
            # map kept match slots -> tracks via the left-view node
            fi = self.match_idx[p, :, 0]
            tr = self.node2track[i, np.clip(fi, 0, None)]
            sel = keep_np & (tr >= 0)
            self.track_xyz[tr[sel]] = np_of(X)[sel]
            self.track_ok[tr[sel]] = True
            self.poses[i] = np.eye(3, 4, dtype=np.float32)
            self.poses[j] = np_of(res.Rt)
            self.pose_valid[[i, j]] = True
            self.reg_order = [i, j]
            self._timings["baseline_s"] = time.perf_counter() - t0
            self._log(1, f"baseline {i},{j}: {int(sel.sum())} seed tracks "
                         f"(pose inliers {ratio:.2f})")
            return True
        return False

    # ------------------------------------------------------------------ #
    def _pnp_view(self, v: int) -> bool:
        """Register view v from its 2D-3D track correspondences
        (SfM.cpp:471-528 + SfMStereoUtilities.cpp:208-243 + the legacy
        sanity gates MultiCameraPnP.cpp:287-299)."""
        cfg = self.cfg
        sel = np.nonzero((self.obs_view == v) & self.obs_alive
                         & self.track_ok[self.obs_track])[0]
        n = len(sel)
        if n < 8:
            return False
        t0 = time.perf_counter()
        res = self._pnp(self._gen, self._dev(self.track_xyz[self.obs_track[sel]]),
                        self._dev(self.obs_uv[sel]),
                        torch.ones(n, dtype=torch.bool, device=self.device),
                        self.intr.K, self.intr.Kinv)
        # one read-back: pose, inlier mask, ratio, ok
        out = np_of(torch.cat([res.Rt.reshape(12), res.inliers.to(torch.float32),
                               res.inlier_ratio.reshape(1).to(torch.float32),
                               res.ok.reshape(1).to(torch.float32)]))
        self._add_time("pnp_s", t0)
        Rt, inl, ratio, res_ok = out[:12].reshape(3, 4), out[12:12 + n] > 0, out[-2], out[-1] > 0
        ok = (res_ok
              and int(inl.sum()) >= max(n // 5, 6)
              and np.linalg.norm(Rt[:, 3]) <= cfg.max_translation_norm
              and abs(np.linalg.det(Rt[:, :3]) - 1.0) < 1e-2)
        self._log(0, f"view {v}: {n} 2D-3D matches, PnP ratio {ratio:.2f}, ok={ok}")
        if not ok:
            return False
        # PnP outliers are wrong track assignments — cut those observations
        self.obs_alive[sel[~inl]] = False
        self.poses[v] = Rt
        self.pose_valid[v] = True
        self.reg_order.append(v)
        return True

    def _tri_tracks(self, tr_ids: np.ndarray) -> int:
        """Multi-view triangulate the given tracks from ALL their alive
        registered observations (up to _tri_k, evenly spread over the
        view range); writes track_xyz/track_ok. Returns accepted count."""
        K_TRI = self._tri_k
        tr_ids = np.asarray(np.sort(tr_ids), np.int64)
        if len(tr_ids) == 0:
            return 0
        tmask = np.zeros(self.T, bool)
        tmask[tr_ids] = True
        sel = np.nonzero(self.obs_alive & self.pose_valid[self.obs_view]
                         & tmask[self.obs_track])[0]
        order = np.lexsort((self.obs_view[sel], self.obs_track[sel]))
        sel = sel[order]
        st = self.obs_track[sel]
        starts = np.searchsorted(st, tr_ids)
        ends = np.searchsorted(st, tr_ids, side="right")
        c = ends - starts
        tr_ids = tr_ids[c >= 2]
        starts = starts[c >= 2]
        c = c[c >= 2]
        B = len(tr_ids)
        if B == 0:
            return 0
        t0 = time.perf_counter()
        # per-track observation slots: all of them when c <= K, evenly
        # spread over the view-sorted range when c > K (max parallax)
        lin = np.arange(K_TRI)
        pos = np.where(
            (c >= K_TRI)[:, None],
            np.round(lin[None, :] * (c[:, None] - 1) / max(K_TRI - 1, 1)).astype(np.int64),
            np.minimum(lin[None, :], c[:, None] - 1))
        oidx = sel[starts[:, None] + pos]                       # (B, K)
        msk = (lin[None, :] < np.minimum(c, K_TRI)[:, None])
        n_ok = 0
        for s0 in range(0, B, _TRI_CHUNK):
            blk = slice(s0, min(s0 + _TRI_CHUNK, B))
            X, keep = self._tri_multi(
                self._dev(self.poses[self.obs_view[oidx[blk]]]), self._dev(self.obs_uv[oidx[blk]]),
                self._dev(msk[blk].astype(np.float32)), self.intr.K, self.intr.Kinv)
            out = np_of(torch.cat([X, keep[:, None].to(X.dtype)], 1))    # one read-back
            keep_np = out[:, 3] > 0
            ids = tr_ids[blk][keep_np]
            self.track_xyz[ids] = out[keep_np, :3]
            self.track_ok[ids] = True
            n_ok += int(keep_np.sum())
        self._add_time("triangulate_s", t0)
        return n_ok

    def _triangulate_new(self, v: int) -> int:
        """Triangulate tracks that gained an observation with the
        registration of v and are not yet in the map, from all their
        registered observations (legacy TriangulatePointsBetweenViews
        runs v against EVERY good view, MultiCameraPnP.cpp:308-444 —
        the N-view solve is the batched equivalent)."""
        sel = self.obs_alive & self.pose_valid[self.obs_view]
        cnt = np.bincount(self.obs_track[sel], minlength=self.T)
        in_v = np.nonzero((self.obs_view == v) & self.obs_alive)[0]
        tr = np.unique(self.obs_track[in_v])
        tr = tr[(~self.track_ok[tr]) & (cnt[tr] >= 2)]
        if len(tr) == 0:
            return 0
        n_ok = self._tri_tracks(tr)
        self._log(0, f"  triangulate: {n_ok}/{len(tr)} candidates passed "
                     f"the {self.cfg.min_reprojection_error:.0f}px gate")
        return n_ok

    def _retriangulate(self) -> int:
        """Re-triangulate pool tracks (never triangulated, or pruned back)
        that have >= 2 alive registered observations — runs after every
        global BA, when the poses are at their best. The reference's
        analog is re-running triangulation of a view pair after pose
        refinement (SfM.cpp:413-461); here it recovers tracks the
        interleaved pruning sent back to the pool."""
        sel = self.obs_alive & self.pose_valid[self.obs_view]
        cnt = np.bincount(self.obs_track[sel], minlength=self.T)
        tr = np.nonzero((~self.track_ok) & (cnt >= 2))[0]
        if len(tr) == 0:
            return 0
        return self._tri_tracks(tr)

    # ------------------------------------------------------------------ #
    def _ba(self, free_views: np.ndarray, global_ba: bool, final: bool = False) -> None:
        """COO bundle adjustment over the tracks observed by free_views.

        Local mode optimizes the sliding camera window against frozen
        older cameras; global mode frees every registered camera and
        shards point blocks over the mesh when one is given."""
        if global_ba:
            # cut gross outliers BEFORE the solve: LM over a heavy-tailed
            # residual set rejects its first trust-region steps and
            # stalls. The FINAL solves prune at a wider gate — closure
            # observations legitimately carry the whole accumulated loop
            # drift until the deep Huber solve absorbs it.
            self._prune_observations(
                self.cfg.collection_final_prune_factor if final else 1.0)
        free_mask = np.zeros(self.V, bool)
        free_mask[free_views] = True
        sel = (self.obs_alive & self.track_ok[self.obs_track] & self.pose_valid[self.obs_view])
        if global_ba:
            t_in = self.track_ok.copy()
        else:
            t_in = np.zeros(self.T, bool)
            t_in[self.obs_track[sel & free_mask[self.obs_view]]] = True
            t_in &= self.track_ok
        o_in = np.nonzero(sel & t_in[self.obs_track])[0]
        t_ids = np.unique(self.obs_track[o_in])
        if len(t_ids) < 8 or len(o_in) < 24:
            return
        t0 = time.perf_counter()
        remap = np.full(self.T, -1, np.int64)
        remap[t_ids] = np.arange(len(t_ids))
        n_pts, n_obs = len(t_ids), len(o_in)
        if global_ba and self.mesh is not None:
            out_Rt, out_pts, newK, summary = self._sharded_ba(free_mask, t_ids, o_in, remap, final)
            its, c0, c1 = self._summary_numbers(summary)
        else:
            out_Rt, out_pts, newK, its, c0, c1 = self._device_ba(free_mask, t_ids, o_in, remap,
                                                                global_ba, final)
        self._ba_iters += its
        self._last_ba = (its, c0, c1)
        self.poses = np.where(free_mask[:, None, None], np_of(out_Rt),
                              self.poses).astype(np.float32)
        self.track_xyz[t_ids] = np_of(out_pts)[:n_pts]
        if global_ba and self.cfg.ba_share_focal:
            self._set_intrinsics(float(newK[0, 0]), float(self._K_host[0, 2]),
                                 float(self._K_host[1, 2]))
        self._add_time("global_ba_s" if global_ba else "local_ba_s", t0)
        key = "ba_iters_global" if global_ba else "ba_iters_local"
        self._timings[key] = self._timings.get(key, 0) + its
        if global_ba:
            self._prune_observations()
        self._log(0 if not global_ba else 1,
                  f"{'global' if global_ba else 'local'} BA: {c0:.1f} -> {c1:.1f} in "
                  f"{its} iters ({n_pts} pts, {n_obs} obs)")

    def _sharded_ba(self, free_mask, t_ids, o_in, remap, final: bool):
        """The global solve point-sharded over the mesh: the whole iteration
        budget in one call, the points padded (with no observations) to a
        multiple of the mesh size."""
        cfg, n = self.cfg, self.mesh.size
        pts = np.zeros((-(-len(t_ids) // n) * n, 3), np.float32)
        pts[:len(t_ids)] = self.track_xyz[t_ids]
        return adjust_bundle_sparse_sharded(
            self.mesh, self._dev(self.poses), self._dev(free_mask), pts, self.obs_view[o_in],
            remap[self.obs_track[o_in]], self.obs_uv[o_in], np.ones(len(o_in), np.float32),
            self.intr.K, max_iterations=(2 if final else 1) * cfg.ba_max_iterations,
            function_tolerance=cfg.ba_function_tolerance * (0.1 if final else 1.0),
            initial_lambda=cfg.ba_initial_lambda, share_focal=cfg.ba_share_focal,
            cg_iterations=self._final_cg if final else self._interval_cg,
            huber_delta=cfg.collection_huber_px)

    def _device_ba(self, free_mask, t_ids, o_in, remap, global_ba: bool, final: bool):
        """A solve on this pipeline's device: the local window in one call, a
        global solve as a host-side continuation over chunks.
        Returns (poses, points, K, iterations, initial cost, final cost)."""
        n_obs = len(o_in)
        poses_t = self._dev(self.poses)
        free_t = self._dev(free_mask)
        fixed = (free_t, self._dev(self.track_xyz[t_ids]),
                 self._dev(self.obs_view[o_in], torch.int64),
                 self._dev(remap[self.obs_track[o_in]]), self._dev(self.obs_uv[o_in]),
                 torch.ones(n_obs, dtype=torch.float32, device=self.device))
        if global_ba:
            # host-side continuation over chunks of _ba_chunk LM iterations
            # (see _build_kernels) up to the iteration budget
            fn = self._final_ba if final else self._global_ba
            budget = (2 if final else 1) * self.cfg.ba_max_iterations
            pts_t, K_t = fixed[1], self.intr.K
            total_it = 0
            initial_cost = prev_cost = None
            while total_it < budget:
                poses_t, pts_t, K_t, summary = fn(poses_t, fixed[0], pts_t, *fixed[2:], K_t)
                it, c0, cost = self._summary_numbers(summary)
                total_it += it
                if initial_cost is None:
                    initial_cost = c0
                if it < self._ba_chunk:
                    break                      # converged inside the chunk
                if prev_cost is not None and cost >= prev_cost * (1 - 1e-6):
                    break                      # chunk-to-chunk stall
                prev_cost = cost
            out_Rt, out_pts, newK = poses_t, pts_t, K_t
            its, c0, c1 = total_it, initial_cost, cost
        else:
            out_Rt, out_pts, newK, summary = self._local_ba(poses_t, *fixed, self.intr.K)
            its, c0, c1 = self._summary_numbers(summary)
        return out_Rt, out_pts, newK, its, c0, c1

    def _check_ranks_agree(self, what: str):
        """With a mesh: raise unless every rank has registered the same views
        (a checksum of ``pose_valid``, its maximum and minimum over the
        ranks in one ``all_reduce``)."""
        if self.mesh is None:
            return
        w = (np.arange(self.V, dtype=np.int64) * 2654435761 + 1) % 2147483647
        c = int((w * self.pose_valid).sum())
        t = torch.tensor([c, -c], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.group)
        hi, neg_lo = t.tolist()
        if hi != -neg_lo:
            raise RuntimeError(f"the mesh's ranks registered different views after {what}")

    @staticmethod
    def _summary_numbers(summary):
        """(iterations, initial cost, final cost) of a BASummary in one read-back."""
        it, c0, c1 = torch.stack([summary.iterations.to(torch.float64),
                                  summary.initial_cost.to(torch.float64),
                                  summary.final_cost.to(torch.float64)]).tolist()
        return int(it), c0, c1

    def _reproject(self, o: np.ndarray):
        """(pixel reprojection error, depth) of observations o, on the host."""
        K = self._K_host
        Rt = self.poses[self.obs_view[o]]
        X = self.track_xyz[self.obs_track[o]]
        pc = np.einsum("oij,oj->oi", Rt[:, :, :3], X) + Rt[:, :, 3]
        z = np.where(np.abs(pc[:, 2:]) < 1e-9, 1e-9, pc[:, 2:])
        pr = pc[:, :2] / z * K[0, 0] + K[:2, 2]
        return np.linalg.norm(pr - self.obs_uv[o], axis=1), pc[:, 2]

    def _prune_observations(self, factor: float = 1.0):
        """Cut observations whose reprojection exceeds factor x the
        triangulation gate after a global BA; tracks left with < 2
        registered alive observations lose their point and go back to the
        triangulation pool (the collection-scale analog of the
        reference's per-merge reprojection confirmation)."""
        sel = np.nonzero(self.obs_alive & self.track_ok[self.obs_track]
                         & self.pose_valid[self.obs_view])[0]
        if not len(sel):
            return
        err, depth = self._reproject(sel)
        bad = (err > factor * self.cfg.min_reprojection_error) | (depth <= 0)
        self.obs_alive[sel[bad]] = False
        live = np.bincount(
            self.obs_track[self.obs_alive & self.pose_valid[self.obs_view]],
            minlength=self.T)
        lost = self.track_ok & (live < 2)
        self.track_ok[lost] = False
        if bad.sum():
            self._log(0, f"pruned {int(bad.sum())} observations, "
                         f"{int(lost.sum())} tracks back to pool")

    # ------------------------------------------------------------------ #
    def run(self) -> CollectionReconstruction:
        cfg = self.cfg
        t0 = time.perf_counter()
        if not self._extracted:
            self.extract()
        if self.match_idx is None:
            self.match()
        if self.track_xyz is None:
            self.build_tracks()
        t1 = time.perf_counter()
        if not self.find_baseline():
            raise RuntimeError(
                "no baseline pair could seed the reconstruction "
                "(reference aborts the same way, MultiCameraPnP.cpp:144-147)")
        self._check_ranks_agree("the baseline")
        self._triangulate_new(self.reg_order[1])
        self._ba(np.array(self.reg_order), global_ba=False)

        def global_round(level: int):
            self._ba(np.nonzero(self.pose_valid)[0], global_ba=True)
            n_re = self._retriangulate()
            if n_re:
                self._log(level, f"retriangulated {n_re} pool tracks")

        since_global = 0
        stalled = 0
        failed: set = set()
        while True:
            counts = np.bincount(
                self.obs_view[self.obs_alive & self.track_ok[self.obs_track]],
                minlength=self.V)
            counts[self.pose_valid] = 0
            for v in failed:
                counts[v] = 0
            v = int(np.argmax(counts))
            if counts[v] < 8:
                # The frontier stalled — every candidate failed PnP or
                # starved. PnP failures at a long-running frontier are
                # usually accumulated drift (local BA windows cannot fix
                # the whole chain): consolidate with a global BA +
                # retriangulation and RETRY the failed views once. Only a
                # stall that repeats immediately after a fresh global
                # round is terminal.
                if stalled >= 1 or not failed:
                    break
                self._log(1, f"frontier stalled at {len(failed)} failed views "
                             "- global consolidation + retry")
                global_round(0)
                failed.clear()
                since_global = 0
                stalled += 1
                continue
            registered = self._pnp_view(v)
            self._check_ranks_agree(f"view {v}")
            if not registered:
                failed.add(v)
                continue
            failed.clear()
            stalled = 0
            n_new = self._triangulate_new(v)
            self._log(0, f"view {v}: +{n_new} tracks triangulated")
            free = np.array(self.reg_order[-cfg.collection_local_ba_cams:])
            self._ba(free, global_ba=False)
            since_global += 1
            if since_global >= cfg.collection_global_ba_interval:
                global_round(0)
                failed.clear()     # a better map may revive failed views
                since_global = 0

        # final polish: deep-CG global BA, recover pruned tracks at the
        # refined poses, then one more deep pass over the completed map
        self._ba(np.nonzero(self.pose_valid)[0], global_ba=True, final=True)
        n_re = self._retriangulate()
        if n_re:
            self._log(1, f"retriangulated {n_re} pool tracks")
        self._ba(np.nonzero(self.pose_valid)[0], global_ba=True, final=True)
        self._timings["solve_s"] = time.perf_counter() - t1
        self._timings["total_s"] = time.perf_counter() - t0
        self._timings["ba_iters"] = self._ba_iters
        return self._result()

    # ------------------------------------------------------------------ #
    def mean_reprojection_error(self) -> float:
        o = np.nonzero(self.obs_alive & self.track_ok[self.obs_track]
                       & self.pose_valid[self.obs_view])[0]
        if not len(o):
            return float("inf")
        return float(self._reproject(o)[0].mean())

    def _result(self) -> CollectionReconstruction:
        ok = self.track_ok
        pid = np.full(self.T, -1, np.int64)
        pid[ok] = np.arange(int(ok.sum()))
        o = np.nonzero(self.obs_alive & ok[self.obs_track]
                       & self.pose_valid[self.obs_view])[0]
        err = self.mean_reprojection_error()
        # vertex colors: image intensity at the first observation
        xyz = self.track_xyz[ok]
        rgb = np.full((len(xyz), 3), 200, np.uint8)
        pts, first = np.unique(pid[self.obs_track[o]], return_index=True)
        oi = o[first]
        ui = np.clip(np.rint(self.obs_uv[oi, 0]), 0, self.W - 1).astype(np.int64)
        vi = np.clip(np.rint(self.obs_uv[oi, 1]), 0, self.H - 1).astype(np.int64)
        rgb[pts] = (self.gray[self.obs_view[oi], vi, ui] * 255).astype(np.uint8)[:, None]
        self._log(1, f"done: {len(xyz)} points, "
                     f"{int(self.pose_valid.sum())}/{self.V} cameras, "
                     f"mean reprojection error {err:.3f}px, "
                     f"{self._timings.get('total_s', 0.0):.2f}s")
        return CollectionReconstruction(
            poses=self.poses.copy(), pose_valid=self.pose_valid.copy(),
            xyz=xyz.copy(), rgb=rgb,
            obs_point=pid[self.obs_track[o]].astype(np.int32),
            obs_view=self.obs_view[o].copy(), obs_feat=self.obs_feat[o].copy(),
            K=self._K_host.copy(), mean_reprojection_error=err,
            stats=dict(self._timings),
        )
