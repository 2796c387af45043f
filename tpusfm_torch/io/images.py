"""Dataset directory loading with downscale (counterpart of
``tpusfm/io/images.py``): the native threaded decoder of ``csrc/imageio.cc``
(``tpusfm_torch/native.py``) when it builds, PIL otherwise."""
from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np

_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".pgm", ".bmp")


@dataclasses.dataclass
class ImageSet:
    gray: np.ndarray        # (V, H, W) float32 in [0, 1]
    rgb: np.ndarray         # (V, H, W, 3) uint8
    paths: List[str]

    @property
    def num_views(self) -> int:
        return self.gray.shape[0]

    @property
    def shape(self):
        return self.gray.shape[1:]


def _to_gray(rgb: np.ndarray) -> np.ndarray:
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
            + 0.114 * rgb[..., 2]).astype(np.float32) / 255.0


def load_image_directory(directory: str, downscale: float = 1.0) -> ImageSet:
    """Load every image of a directory, sorted by file name, resized to
    1/downscale of the first image's size (one static shape per batch).

    Fast path: the native threaded decoder (and its resize); PIL when it is
    unavailable or a file does not decode there. Gray comes from the decoded
    bytes in numpy on both paths, so equal bytes give equal floats (the
    native decoder's own gray, which tpusfm keeps, differs in the last bit)."""
    from PIL import Image

    from tpusfm_torch import native

    paths = sorted(os.path.join(directory, f) for f in os.listdir(directory)
                   if f.lower().endswith(_EXTS))
    if not paths:
        raise FileNotFoundError(f"no images found in {directory!r}")
    size = native.image_size(paths[0])
    if size is not None:
        h, w = size
        if downscale and downscale != 1.0:
            h, w = int(round(h / downscale)), int(round(w / downscale))
        out = native.load_images(paths, h, w)
        if out is not None:
            return ImageSet(gray=_to_gray(out[0]), rgb=out[0], paths=paths)
    rgbs = []
    target = None
    for p in paths:
        with Image.open(p) as im:
            img = np.asarray(im.convert("RGB"))
        if target is None:
            h, w = img.shape[:2]
            if downscale and downscale != 1.0:
                h, w = int(round(h / downscale)), int(round(w / downscale))
            target = (h, w)
        if img.shape[:2] != target:
            img = np.asarray(Image.fromarray(img).resize((target[1], target[0]),
                                                         Image.BILINEAR))
        rgbs.append(img)
    rgb = np.stack(rgbs).astype(np.uint8)
    return ImageSet(gray=_to_gray(rgb), rgb=rgb, paths=paths)


def load_image(path: str, downscale: float = 1.0):
    """Load a single image -> (gray (H, W) float32 [0,1], rgb (H, W, 3) u8)."""
    from PIL import Image

    with Image.open(path) as im:
        img = np.asarray(im.convert("RGB"))
    if downscale and downscale != 1.0:
        h, w = img.shape[:2]
        img = np.asarray(Image.fromarray(img).resize(
            (int(round(w / downscale)), int(round(h / downscale))), Image.BILINEAR))
    rgb = img.astype(np.uint8)
    return _to_gray(rgb), rgb
