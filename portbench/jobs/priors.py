"""Job kind ``priors``: one reconstruction from known poses through
``CollectionPipeline.run(known_poses=)``.

As ``collection``, with the scene's true poses perturbed as priors from
the job's seed (``perturb``) and handed to ``run``: no registration, every
track triangulated from the priors, then the final global bundle
adjustment. The benchmark wraps the pipeline's own ``_extract`` and
``_match_chunk`` attributes to keep their outputs for the jobs it checks.
"""
from __future__ import annotations

import dataclasses
import inspect

import numpy as np

# the priors' noise per axis: the source's 0.002 (the configuration's ``prior_sigma``)
SIGMA = 0.002


def reference_images(job_cfg, images: np.ndarray) -> np.ndarray:
    """The collection pipeline's detector takes the float32 images as they are."""
    return images.astype(np.float32)


def make_config(job_cfg):
    """The pipeline's settings; exits at once when ``CollectionPipeline.run``
    takes no known poses, rather than fail every job of the window."""
    from tpusfm_torch import SfMConfig
    from tpusfm_torch.pipeline import CollectionPipeline

    if "known_poses" not in inspect.signature(CollectionPipeline.run).parameters:
        raise SystemExit("job kind priors: CollectionPipeline.run takes no known_poses, "
                         "so this checkout cannot reconstruct from known poses")
    return SfMConfig(**job_cfg["pipeline"], console_debug_level=5)


def _rotation(w: np.ndarray) -> np.ndarray:
    """exp([w]x) of (V, 3) axis-angle vectors (Rodrigues), float64 (V, 3, 3)."""
    th = np.linalg.norm(w, axis=1)[:, None, None]
    k = w / np.maximum(th[:, :, 0], 1e-300)
    X = np.zeros((len(w), 3, 3))
    X[:, 0, 1], X[:, 0, 2], X[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    X = X - X.transpose(0, 2, 1)
    return np.eye(3) + np.sin(th) * X + (1.0 - np.cos(th)) * (X @ X)


def perturb(poses: np.ndarray, seed: int, sigma: float) -> np.ndarray:
    """Priors from true world-to-camera poses (V, 3, 4): each rotation turned
    by exp(w), w ~ N(0, sigma^2) per axis, each translation moved by
    N(0, sigma^2) per axis; float32."""
    rng = np.random.default_rng([seed, 11])
    P = np.asarray(poses, np.float64)
    w = sigma * rng.standard_normal((len(P), 3))
    dt = sigma * rng.standard_normal((len(P), 3))
    R = _rotation(w) @ P[:, :, :3]
    return np.concatenate([R, (P[:, :, 3] + dt)[:, :, None]], 2).astype(np.float32)


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
    rec = pipe.run(known_poses=perturb(scene["gt_poses"], seed, SIGMA))
    if parts:
        kept["features"].append(Features(*(torch.cat([getattr(p, f.name) for p in parts])
                                           for f in dataclasses.fields(Features))))
    return {
        "poses": rec.poses, "pose_valid": rec.pose_valid, "xyz": rec.xyz, "K": rec.K,
        "obs_point": rec.obs_point, "obs_view": rec.obs_view, "obs_feat": rec.obs_feat,
        "feat_xy": pipe.feat_xy, "reported_px": float(rec.mean_reprojection_error),
        "stats": dict(rec.stats), "kept": kept,
    }
