"""Utilities (counterpart of ``tpusfm/utils``)."""

from tpusfm_torch.utils.profiling import stage

__all__ = ["stage"]
