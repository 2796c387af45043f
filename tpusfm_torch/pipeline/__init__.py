"""Incremental SfM pipeline: the fused device path, the host-driven loop,
the two-view variant and the collection-scale pipeline (counterpart of
``tpusfm/pipeline``)."""

from tpusfm_torch.pipeline.collection import (
    CollectionPipeline,
    CollectionReconstruction,
    window_pairs,
)
from tpusfm_torch.pipeline.incremental import Reconstruction, SfMPipeline, run_sfm
from tpusfm_torch.pipeline.two_view import reconstruct_two_view

__all__ = ["SfMPipeline", "Reconstruction", "run_sfm", "reconstruct_two_view",
           "CollectionPipeline", "CollectionReconstruction", "window_pairs"]
