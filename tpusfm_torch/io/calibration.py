"""Camera calibration loading with mock-K fallback.

Counterpart of ``tpusfm/io/calibration.py``, the legacy calibration path
(legacy/SfMToyLib_Old/MultiCameraDistance.cpp:76-98): try to load an
OpenCV-style ``out_camera_data.yml`` (camera_matrix + distortion
coefficients); if absent, fall back to a mock K with focal = max(w, h)
and principal point at the image center (:83-89). The modern library's
hardcoded f=2500 default (SfM.cpp:70-74) lives in SfMConfig.default_focal.
"""
from __future__ import annotations

import os
import re

import numpy as np
import yaml

from tpusfm_torch.types import Intrinsics


def mock_calibration(width: int, height: int, focal: float | None = None,
                     device="cuda") -> Intrinsics:
    """K = [f 0 cx; 0 f cy; 0 0 1] with f = max(w, h) unless given.

    Mirrors legacy MultiCameraDistance.cpp:83-89 (mock K) and, with
    ``focal`` set, the modern hardcoded intrinsics (SfM.cpp:70-74).
    """
    f = float(focal) if focal is not None else float(max(width, height))
    return Intrinsics.create(f, width / 2.0, height / 2.0, device=device)


def _parse_opencv_yaml(text: str) -> dict:
    """Minimal parser for OpenCV FileStorage YAML (``%YAML:1.0`` headers and
    !!opencv-matrix tags choke standard loaders)."""
    text = re.sub(r"^%YAML.*$", "", text, flags=re.M)
    text = text.replace("!!opencv-matrix", "")
    return yaml.safe_load(text) or {}


def load_calibration(path: str, width: int, height: int, downscale: float = 1.0,
                     device="cuda") -> Intrinsics:
    """Load calibration YAML; fall back to mock K when missing/invalid."""
    if not os.path.exists(path):
        return mock_calibration(width, height, device=device)
    try:
        with open(path) as fh:
            data = _parse_opencv_yaml(fh.read())
        K = np.asarray(data["camera_matrix"]["data"], np.float32).reshape(3, 3)
        dist = None
        dc = data.get("distortion_coefficients", {})
        if isinstance(dc, dict) and "data" in dc:
            d = np.asarray(dc["data"], np.float32).ravel()
            dist = np.zeros(5, np.float32)
            dist[: min(5, d.size)] = d[:5]
        if downscale and downscale != 1.0:
            K[:2] /= downscale
    except (KeyError, TypeError, ValueError, yaml.YAMLError):
        return mock_calibration(width, height, device=device)
    # Intrinsics models a single focal (the reference BA optimizes one
    # shared focal scalar); average fx/fy if they differ.
    return Intrinsics.create(float(0.5 * (K[0, 0] + K[1, 1])), float(K[0, 2]), float(K[1, 2]),
                             dist, device=device)

