"""Job kind ``collection``: one reconstruction through ``CollectionPipeline.run()``.

As ``sfm``, with the collection pipeline: its windowed pairs are matched
in chunks (one K1 launch each), and the reconstruction's observations come
back as a COO list. The benchmark wraps the pipeline's own ``_extract`` and
``_match_chunk`` attributes to keep their outputs for the jobs it checks.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def reference_images(job_cfg, images: np.ndarray) -> np.ndarray:
    """The collection pipeline's detector takes the float32 images as they are."""
    return images.astype(np.float32)


def make_config(job_cfg):
    from tpusfm_torch import SfMConfig

    return SfMConfig(**job_cfg["pipeline"], console_debug_level=5)


def run(scene, sfm_cfg, seed: int, device: str, keep: bool):
    import torch

    from tpusfm_torch.pipeline import CollectionPipeline
    from tpusfm_torch.types import Features, Intrinsics

    K = scene["K"]
    pipe = CollectionPipeline(scene["images"], sfm_cfg, seed=seed, device=device,
                              intrinsics=Intrinsics.create(float(K[0, 0]), float(K[0, 2]),
                                                           float(K[1, 2]), device=device))
    kept = {"features": [], "matches": [], "calls": {"match_top2": []}}
    extract, match = pipe._extract, pipe._match_chunk
    parts = []

    def spy_extract(images):
        feats = extract(images)
        if keep:
            parts.append(feats)
        return feats

    def spy_match(feats, signs, pairs):
        m = match(feats, signs, pairs)
        F = int(feats.desc.shape[1])
        kept["calls"]["match_top2"].append((int(pairs.shape[0]), F, F))
        if keep:
            kept["matches"].append((pairs, m))
        return m

    pipe._extract, pipe._match_chunk = spy_extract, spy_match
    rec = pipe.run()
    if parts:
        kept["features"].append(Features(*(torch.cat([getattr(p, f.name) for p in parts])
                                           for f in dataclasses.fields(Features))))
    return {
        "poses": rec.poses, "pose_valid": rec.pose_valid, "xyz": rec.xyz, "K": rec.K,
        "obs_point": rec.obs_point, "obs_view": rec.obs_view, "obs_feat": rec.obs_feat,
        "feat_xy": pipe.feat_xy, "reported_px": float(rec.mean_reprojection_error),
        "stats": dict(rec.stats), "kept": kept,
    }

