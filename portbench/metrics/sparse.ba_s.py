"""The collection pipeline's COO bundle adjustment (``ba/sparse.py``: the
sliding local solves and the global ones), seconds per job: the sum of
``CollectionPipeline._timings["local_ba_s"]`` and ``["global_ba_s"]``. Only
the collection has a ``tracks_s`` stage."""
from portbench.metrics import mean_stat


def read(ctx):
    return mean_stat(ctx, ("local_ba_s", "global_ba_s"), only_with="tracks_s")
