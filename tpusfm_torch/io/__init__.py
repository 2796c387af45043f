"""Host-side IO: dataset loading, calibration and PLY/PCD export."""

from tpusfm_torch.io.calibration import load_calibration, mock_calibration
from tpusfm_torch.io.images import ImageSet, load_image, load_image_directory
from tpusfm_torch.io.ply import save_cameras_ply, save_pcd, save_point_cloud_ply

__all__ = ["load_image_directory", "load_image", "ImageSet", "save_point_cloud_ply",
           "save_cameras_ply", "save_pcd", "load_calibration", "mock_calibration"]
