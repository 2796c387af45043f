"""The collection pipeline's PnP registration (``_pnp_view``: the 2D-3D
correspondences of a view through ``find_camera_pose_2d3d``), seconds per
job: ``CollectionPipeline._timings["pnp_s"]``. Only the collection has a
``tracks_s`` stage."""
from portbench.metrics import mean_stat


def read(ctx):
    return mean_stat(ctx, "pnp_s", only_with="tracks_s")
