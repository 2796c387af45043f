"""Feature layer: batched detection, description and matching
(counterpart of ``tpusfm/features``)."""

from tpusfm_torch.features.detect import extract_features, fast_harris_response
from tpusfm_torch.features.match import (
    match_pair,
    match_all_pairs,
    hamming_distance_matrix,
    l2_distance_matrix,
)

__all__ = [
    "extract_features",
    "fast_harris_response",
    "match_pair",
    "match_all_pairs",
    "hamming_distance_matrix",
    "l2_distance_matrix",
]
