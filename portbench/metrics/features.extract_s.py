"""The detector stage (features/detect.py: FAST, Harris, BRIEF over the
pyramid), seconds per job: the pipeline's ``features_s``."""
from portbench.metrics import mean_stat


def read(ctx):
    return mean_stat(ctx, "features_s")
