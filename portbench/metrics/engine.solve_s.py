"""FusedEngine's solve stage (baseline, the add-view steps, the final BA),
seconds per job: ``FusedEngine.timings["solve_s"]``, which it stops after a
synchronise. Only the fused path has a ``rank_s`` stage."""
from portbench.metrics import mean_stat


def read(ctx):
    return mean_stat(ctx, "solve_s", only_with="rank_s")
