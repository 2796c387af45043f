"""Single typed configuration covering every behavioral knob of the reference.

A copy of ``tpusfm/config.py``, field for field: importing that module
runs ``tpusfm/__init__.py``, which imports JAX, and the PyTorch port
must not. ``tpusfm_torch.convert.config_from_dict`` carries a
``tpusfm.SfMConfig`` across. Knobs that name TPU machinery
(``use_pallas_matcher``, ``mesh_axis``) keep their names; in the port
``use_pallas_matcher`` selects the streaming top-2 CUDA kernel.

The reference scatters its tuning constants across file-local consts and
compile-time defines (SfM.cpp:50-52, SfMStereoUtilities.cpp:41-42,
SfMCommon.h:53, SfM2DFeatureUtilities.cpp:35,39, FindCameraMatrices.cpp:45,
BundleAdjuster.cpp:36-40, IDistance.h:32-35). Here they are one dataclass.
"""
from __future__ import annotations

import dataclasses
import enum


class MatcherKind(enum.Enum):
    """Matcher strategy selection — reference runtime bitmask
    (IDistance.h:32-35, chosen in MultiCameraDistance.cpp:106-117)."""

    RICH = "rich"            # ORB-like detect+describe+match (default; M3, L4)
    OPTICAL_FLOW = "of"      # pyramidal LK flow matcher (L5)
    DENSE = "dense"          # dense Farneback-style flow (L11)
    SURF = "surf"            # float-descriptor blob pipeline (L6, GPUSURFFeatureMatcher)
    STEREO = "stereo"        # scanline-disparity matching (L11, StereoSGBM path)


class EssentialDecomposition(enum.Enum):
    """E -> (R, t) decomposition choice — reference compile-time
    ``DECOMPOSE_SVD`` switch (FindCameraMatrices.cpp:45)."""

    SVD_HZ = "svd"           # Hartley-Zisserman SVD (FindCameraMatrices.cpp:328-363)
    HORN90 = "horn"          # Horn'90 closed form (FindCameraMatrices.cpp:51-111)


@dataclasses.dataclass
class SfMConfig:
    # ---- features (reference: SfM2DFeatureUtilities.cpp:35-40) ----
    # 5120 = the reference's 5000-keypoint operating point rounded to the
    # MXU tile multiple. QUALITY.json (crazyhorse, one v5e chip): 5120
    # yields 2168 points at 0.76px vs 643 points at 0.45px for 2048, at
    # 1.35s vs 0.98s warm — the reference reenactment lands 2131 points,
    # so the 5120 default is the parity choice.
    max_features: int = 5120
    desc_bits: int = 256              # BRIEF descriptor length
    pyramid_levels: int = 4           # ORB default is 8 @ 1.2 scale
    pyramid_scale: float = 1.2
    fast_threshold: float = 20.0      # FAST intensity threshold (of 255)
    match_ratio: float = 0.8          # Lowe ratio (SfM2DFeatureUtilities.cpp:35)
    match_ratio_flow: float = 0.7     # legacy GPU/OF ratio (GPUSURFFeatureMatcher.cpp:120)
    cross_check: bool = False         # legacy RichFeatureMatcher BFMatcher(crossCheck=true)
    max_matches: int = 2048           # static match capacity per pair
    matcher: MatcherKind = MatcherKind.RICH
    use_pallas_matcher: bool = True   # fused streaming-top2 TPU kernel (features/pallas_match.py)
    # detector ranking score: "harris" (cv::ORB HARRIS_SCORE) or "min_eig"
    # (Shi-Tomasi, the legacy goodFeaturesToTrack sparse-LK seed,
    # FeatureMatching.cpp:314-331)
    detector_score: str = "harris"
    # BRIEF sample interpolation: "nearest" (1 gather/sample on the blurred
    # image — the detector's hot path on TPU; cv::ORB also reads integer
    # pixels) or "bilinear" (4 gathers, exact interpolation)
    descriptor_sampling: str = "nearest"
    max_disparity: int = 64           # STEREO strategy plane-sweep depth

    # ---- two-view geometry (reference: SfMStereoUtilities.cpp:41-42) ----
    ransac_threshold_px: float = 10.0         # RANSAC_THRESHOLD
    min_reprojection_error: float = 10.0      # MIN_REPROJECTION_ERROR triangulation gate
    essential_threshold_px: float = 1.0       # findEssentialMat thr (SfMStereoUtilities.cpp:97)
    essential_prob: float = 0.999
    ransac_hypotheses: int = 512              # batched-hypothesis count (replaces iterative RANSAC)
    pose_inliers_minimal_ratio: float = 0.5   # POSE_INLIERS_MINIMAL_RATIO (SfMCommon.h:53)
    min_point_count_for_homography: int = 100 # MIN_POINT_COUNT_FOR_HOMOGRAPHY (SfM.cpp:52)
    decomposition: EssentialDecomposition = EssentialDecomposition.SVD_HZ
    # global epipolar match-pruning pass before reconstruction — legacy
    # PruneMatchesBasedOnF (MultiCameraPnP.cpp:463-485)
    epipolar_prune: bool = True
    epipolar_prune_threshold_px: float = 3.0
    epipolar_prune_hypotheses: int = 128      # lax 3px gate needs fewer draws
                                              # than pose estimation
    triangulation_iters: int = 10             # Hartley-Sturm cap (Triangulation.h:52)
    triangulation_eps: float = 1e-4
    cheirality_min_frac: float = 0.75         # TestTriangulation gate (FindCameraMatrices.cpp:277-326)
    cheirality_max_reproj_px: float = 100.0   # reproj gate on the winning pose
                                              # (FindCameraMatrices.cpp:465-470)

    # ---- PnP (reference: SfMStereoUtilities.cpp:216-231) ----
    pnp_hypotheses: int = 256                 # reference: 100 RANSAC iters
    pnp_threshold_px: float = 10.0
    pnp_confidence: float = 0.99
    # legacy pose sanity gates (MultiCameraPnP.cpp:287-299)
    max_translation_norm: float = 200.0       # reject runaway poses, ||t|| <= 200
    min_pnp_inlier_fraction: float = 0.2      # legacy: inliers >= points/5
    # legacy adaptive triangulation filter: keep err <= max(2.4 * p80, 4px),
    # hard reject > 16px (MultiCameraPnP.cpp:347-358, Snavely §4.2)
    adaptive_reprojection_filter: bool = True
    adaptive_percentile: float = 80.0
    adaptive_multiplier: float = 2.4
    adaptive_keep_px: float = 4.0
    adaptive_reject_px: float = 16.0
    # legacy cross-view point strengthening: extend each new point's track
    # into other views via the match matrix before insertion
    # (MultiCameraPnP.cpp:393-441)
    cross_view_strengthen: bool = True
    # max descriptor distance for a strengthening hop match; the legacy scan
    # takes any ratio-passed submatch, but on feature-dense scenes unbounded
    # hops chain wrong tracks — bound them at a "strong match" distance
    # (~1/4 of the 256-bit budget)
    strengthen_max_match_distance: float = 64.0

    # ---- cloud merge (reference: SfM.cpp:50-51) ----
    merge_point_min_match_distance: float = 0.01
    merge_feature_min_match_distance: float = 20.0

    # ---- bundle adjustment (reference: SfMBundleAdjustmentUtils.cpp:171-177) ----
    ba_max_iterations: int = 100              # reference caps Ceres at 500 / 10 s
    ba_function_tolerance: float = 1e-6
    # Per-view (incremental) BA budget inside the add-view loop: each
    # registration only needs to keep the map consistent for the next PnP;
    # the final global BA (ba_max_iterations / ba_function_tolerance)
    # does the polishing. The reference runs Ceres with the same caps per
    # view, but its tolerance is a loose 1e-2 (SfMBundleAdjustmentUtils
    # .cpp:174) — these defaults are stricter than that while keeping the
    # per-view cost bounded.
    ba_incremental_iterations: int = 25
    ba_incremental_tolerance: float = 1e-4
    ba_initial_lambda: float = 1e-3
    ba_share_focal: bool = True               # one shared focal scalar (:138,164)
    ba_refine_pp: bool = False                # also refine principal point (legacy
                                              # SSBA FULL_BUNDLE_FOCAL_LENGTH_PP,
                                              # BundleAdjuster.cpp:219)
    ba_dtype: str = "float32"

    # ---- pipeline ----
    point_capacity: int = 65536               # static map size
    downscale: float = 1.0                    # CLI --downscale (main.cpp:47)
    default_focal: float = 2500.0             # hardcoded K (SfM.cpp:70-74)

    # ---- fused device engine (pipeline/engine.py) ----
    # Runs the whole incremental loop (baseline seed + add-view loop +
    # merge + BA) device-resident with zero host round-trips; the host
    # fetches results once at the end. This is the default execution path
    # for the RICH matcher; strategies that need per-pair host logic
    # (optical flow/dense/stereo) use the classic host-driven loop.
    fused: bool = True
    engine_point_capacity: int = 4096         # static map size of the fused engine
    engine_pnp_capacity: int = 4096           # static 2D-3D correspondence cap

    # ---- collection-scale pipeline (pipeline/collection.py) ----
    # The reference scales the view axis only by thread-parallel all-pairs
    # matching (SfM.cpp:165-211) — O(V^2) pairs. The collection pipeline
    # matches a sliding window of sequential pairs instead and replaces the
    # per-insert cloud-merge scans with one global track graph, which is
    # what reaches the 500/5000-image BASELINE configs.
    collection_window: int = 8                # match view i against i+1..i+window
    collection_wraparound: bool = False       # closed-loop collections: also match across the seam
    collection_local_ba_cams: int = 8         # sliding local-BA camera window
    collection_global_ba_interval: int = 50   # global COO BA every k registrations
    collection_match_chunk: int = 256         # pairs per matching dispatch
    # Huber robust-loss scale (px) for the collection pipeline's GLOBAL
    # BA solves. Loop-closure observations land with the full accumulated
    # loop drift as residual; a quadratic loss either lets them dominate
    # or (after pruning) discards the closure entirely — Huber keeps them
    # pulling linearly until the loop shuts. 0 disables (the reference
    # has no robust loss, SfMBundleAdjustmentUtils.cpp:92).
    collection_huber_px: float = 3.0
    # Observation-prune threshold multiplier applied before the FINAL
    # deep global solves: closure observations may legitimately sit far
    # outside the triangulation gate until that solve absorbs them.
    collection_final_prune_factor: float = 4.0
    # Minimum ray parallax for an accepted triangulation. Without it, the
    # cheirality + reprojection gates keep the biased-NEAR tail of the
    # low-parallax depth distribution (far/behind solutions get rejected),
    # every new PnP pose then fits too-near points, and the map scale
    # CONTRACTS compounding per view until it collapses — the classic
    # sequential-SfM failure the reference never hits because its photo
    # sets have wide baselines. 1.5 deg is the COLMAP default.
    min_triangulation_angle_deg: float = 1.5

    # ---- logging (reference: SfMCommon.h:38-44) ----
    console_debug_level: int = 2              # 0=TRACE..4=ERROR, clamped like SfM.h:77-83
    visual_debug_level: int = 4               # <=2 writes overlay dumps to debug_dir
    debug_dir: str = "tpusfm_debug"           # where visual-debug overlays land

    # ---- distribution ----
    mesh_axis: str = "devices"
