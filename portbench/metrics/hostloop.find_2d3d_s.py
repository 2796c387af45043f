"""The host loop's 2D-3D search (``find_2d3d_matches`` for every pending view
at every registration), seconds per job: ``SfMPipeline._timings["find_2d3d_s"]``."""
from portbench.metrics import mean_stat


def read(ctx):
    return mean_stat(ctx, "find_2d3d_s")
