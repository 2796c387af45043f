"""The known-pose solve (``CollectionPipeline.run(known_poses=)``: every
track triangulated from the priors, then the final polish), seconds per
job: the mean of the stage timing ``priors_s`` over the window's jobs."""
from portbench.metrics import mean_stat


def read(ctx):
    return mean_stat(ctx, "priors_s")
