"""Batched multi-view geometry primitives (PyTorch, f32, leading batch dims).

Counterpart of ``tpusfm/geometry``: homography, essential, triangulation
and PnP solvers batched over hypotheses, pairs and points.
"""

from tpusfm_torch.geometry.linalg import (
    hartley_normalize_2d,
    skew,
    smallest_singular_vector,
)
from tpusfm_torch.geometry.homography import (
    homography_dlt,
    homography_transfer_error,
    find_homography_inliers,
)
from tpusfm_torch.geometry.essential import (
    essential_8pt,
    sampson_error,
    decompose_essential_hz,
    decompose_essential_horn90,
    pick_pose_by_cheirality,
    find_camera_from_match,
)
from tpusfm_torch.geometry.triangulation import (
    triangulate_dlt,
    triangulate_hartley_sturm,
    triangulate_views,
    reprojection_errors,
)
from tpusfm_torch.geometry.pnp import pnp_dlt, refine_pose_gn, find_camera_pose_2d3d

__all__ = [
    "hartley_normalize_2d",
    "skew",
    "smallest_singular_vector",
    "homography_dlt",
    "homography_transfer_error",
    "find_homography_inliers",
    "essential_8pt",
    "sampson_error",
    "decompose_essential_hz",
    "decompose_essential_horn90",
    "pick_pose_by_cheirality",
    "find_camera_from_match",
    "triangulate_dlt",
    "triangulate_hartley_sturm",
    "triangulate_views",
    "reprojection_errors",
    "pnp_dlt",
    "refine_pose_gn",
    "find_camera_pose_2d3d",
]
