"""Visualization & visual debugging (counterpart of ``tpusfm/viz``).

- visual-debug overlays written to disk (keypoints, match lines,
  reprojections) in place of the reference's imshow panels;
- a dependency-free standalone HTML point-cloud viewer with orbit
  controls, and a live listener-fed viewer with a timeline;
- point-cloud post-filters (statistical outlier removal, voxel grid).
"""

from tpusfm_torch.viz.cloud_filter import sor_filter, sor_filter_mask, voxel_grid_filter
from tpusfm_torch.viz.debug import draw_keypoints, draw_matches, draw_reprojections
from tpusfm_torch.viz.html_viewer import export_html_viewer
from tpusfm_torch.viz.live_viewer import LiveViewer

__all__ = [
    "draw_keypoints",
    "draw_matches",
    "draw_reprojections",
    "export_html_viewer",
    "LiveViewer",
    "sor_filter",
    "sor_filter_mask",
    "voxel_grid_filter",
]
