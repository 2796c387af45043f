"""Minimal two-view reconstruction pipeline.

Counterpart of ``tpusfm/pipeline/two_view.py``, the legacy ``Distance``
stereo-pair variant of IDistance (legacy/SfMToyLib_Old/Distance.h:40-133:
OnlyMatchFeatures -> FindCameraMatrices -> TriangulatePoints): one matched
pair in, relative pose + triangulated cloud out, on the batched device
stages of the full pipeline.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from tpusfm_torch.config import SfMConfig
from tpusfm_torch.pipeline.incremental import Reconstruction, SfMPipeline
from tpusfm_torch.types import Intrinsics


def reconstruct_two_view(
    img1: np.ndarray,
    img2: np.ndarray,
    config: Optional[SfMConfig] = None,
    intrinsics: Optional[Intrinsics] = None,
    rgb1: Optional[np.ndarray] = None,
    rgb2: Optional[np.ndarray] = None,
    seed: int = 0,
    device="cuda",
) -> Reconstruction:
    """Reconstruct from exactly two grayscale images (H, W) in [0, 1]."""
    gray = np.stack([np.asarray(img1, np.float32), np.asarray(img2, np.float32)])
    rgb = None
    if rgb1 is not None and rgb2 is not None:
        rgb = np.stack([rgb1, rgb2])
    pipe = SfMPipeline(gray, config or SfMConfig(), images_rgb=rgb, intrinsics=intrinsics,
                       seed=seed, device=device)
    pipe.extract()
    pipe.match()
    if not pipe.find_baseline_triangulation():
        raise RuntimeError("two-view reconstruction failed: no valid pose "
                           "(legacy Distance pipeline fails the same way)")
    return pipe._reconstruction(pipe.mean_reprojection_error())
