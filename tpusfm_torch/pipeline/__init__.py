"""Incremental SfM pipeline: the fused device path (counterpart of
``tpusfm/pipeline``)."""

from tpusfm_torch.pipeline.incremental import Reconstruction, SfMPipeline, run_sfm

__all__ = ["SfMPipeline", "Reconstruction", "run_sfm"]
