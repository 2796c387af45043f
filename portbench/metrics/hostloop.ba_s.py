"""The host loop's dense LM bundle adjustment (ba/lm.py through
adjust_bundle), seconds per job: ``SfMPipeline._timings["ba_s"]``."""
from portbench.metrics import mean_stat


def read(ctx):
    return mean_stat(ctx, "ba_s")
