"""Job kind ``sfm``: one reconstruction through ``SfMPipeline.run()``.

The configuration's ``scene`` is rendered by ``portbench.render``; its
``pipeline`` settings, with the workload's overrides on top (``fused``),
make the ``SfMConfig``. The timed call hands the gray images and the
intrinsics to a new pipeline and returns once the poses and points are
on the host. The benchmark looks at what the pipeline's detector and
matcher return by wrapping the pipeline's own ``_extract`` and ``_match``
attributes: it keeps their outputs for the jobs it will check, and the
shapes of every matcher call under the name of the kernel it launches
(``calls["match_top2"]``: one K1 launch each, as (pairs, query features,
key features)).
"""
from __future__ import annotations

import numpy as np


def reference_images(job_cfg, images: np.ndarray) -> np.ndarray:
    """The images as the pipeline states its detector receives them, float32:
    the fused path takes them to 8-bit levels first, each level k as the
    correctly rounded k / 255 (``FusedEngine.run``); the host loop does not."""
    if job_cfg["pipeline"].get("fused", True):
        u8 = (np.clip(images, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        return (np.arange(256, dtype=np.float32) / np.float32(255.0))[u8]
    return images.astype(np.float32)


def make_config(job_cfg):
    from tpusfm_torch import MatcherKind, SfMConfig

    kw = dict(job_cfg["pipeline"])
    kw["matcher"] = MatcherKind(kw.get("matcher", "rich"))
    return SfMConfig(**kw, console_debug_level=5)


def run(scene, sfm_cfg, seed: int, device: str, keep: bool):
    """One reconstruction of ``scene``; returns the record the harness judges."""
    from tpusfm_torch.pipeline import SfMPipeline
    from tpusfm_torch.types import Intrinsics

    K = scene["K"]
    pipe = SfMPipeline(scene["images"], sfm_cfg, seed=seed, device=device,
                       intrinsics=Intrinsics.create(float(K[0, 0]), float(K[0, 2]),
                                                    float(K[1, 2]), device=device))
    kept = {"features": [], "matches": [], "calls": {"match_top2": []}}
    extract, match = pipe._extract, pipe._match

    def spy_extract(images):
        feats = extract(images)
        if keep:
            kept["features"].append(feats)
        return feats

    def spy_match(feats, pairs):
        m = match(feats, pairs)
        kept["calls"]["match_top2"].append((int(pairs.shape[0]), int(feats.desc.shape[1]),
                           int(feats.desc.shape[1])))
        if keep:
            kept["matches"].append((pairs, m))
        return m

    pipe._extract, pipe._match = spy_extract, spy_match
    rec = pipe.run()
    obs_point, obs_view = np.nonzero(rec.obs >= 0)
    return {
        "poses": rec.poses, "pose_valid": rec.pose_valid, "xyz": rec.xyz, "K": rec.K,
        "obs_point": obs_point, "obs_view": obs_view,
        "obs_feat": rec.obs[obs_point, obs_view], "feat_xy": pipe.feat_xy,
        "reported_px": float(rec.mean_reprojection_error), "stats": dict(rec.stats),
        "kept": kept,
    }
