"""FusedEngine's epipolar prune, seconds per job: ``timings["prune_s"]``."""
from portbench.metrics import mean_stat


def read(ctx):
    return mean_stat(ctx, "prune_s", only_with="rank_s")
