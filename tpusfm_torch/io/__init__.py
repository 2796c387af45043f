"""Host-side IO: dataset loading and PLY/PCD export."""

from tpusfm_torch.io.images import ImageSet, load_image_directory
from tpusfm_torch.io.ply import save_cameras_ply, save_pcd, save_point_cloud_ply

__all__ = ["load_image_directory", "ImageSet", "save_point_cloud_ply",
           "save_cameras_ply", "save_pcd"]
