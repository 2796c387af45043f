"""The host loop's add_more_views (PnP, triangulation, merge and the BA after
each registration), seconds per job: ``SfMPipeline._timings["add_views_s"]``."""
from portbench.metrics import mean_stat


def read(ctx):
    return mean_stat(ctx, "add_views_s")
