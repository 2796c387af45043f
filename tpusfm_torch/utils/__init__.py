"""Utilities (counterpart of ``tpusfm/utils``)."""

from tpusfm_torch.utils.profiling import profile, profiled, trace_to

__all__ = ["profile", "profiled", "trace_to"]
