"""The incremental SfM pipeline — the fused device path.

Counterpart of ``tpusfm/pipeline/incremental.py`` for the path that
``SfMPipeline.run()`` takes by default (RICH matcher, ``fused=True``):
one batched detector call, all-pairs matching on the streaming CUDA
matcher, then the device-resident engine (``pipeline/engine.py``). The
host-driven loop (``fused=False``, other matchers, principal-point BA)
is not ported yet; those configurations raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from tpusfm_torch import camera
from tpusfm_torch.config import MatcherKind, SfMConfig
from tpusfm_torch.features.detect import extract_features
from tpusfm_torch.features.match import match_all_pairs
from tpusfm_torch.features.pallas_match import match_pairs
from tpusfm_torch.types import Features, Intrinsics, np_of

_NOT_PORTED = ("only the fused reconstruction path (RICH matcher, fused=True, "
               "ba_refine_pp=False) is ported to PyTorch; the host-driven loop is "
               "ROADMAP.md queue 1, item 7")


@dataclasses.dataclass
class Reconstruction:
    """Final reconstruction state (host numpy)."""

    poses: np.ndarray          # (V, 3, 4)
    pose_valid: np.ndarray     # (V,)
    xyz: np.ndarray            # (N, 3)
    rgb: np.ndarray            # (N, 3) uint8
    obs: np.ndarray            # (N, V) int32 feature index, -1 sentinel
    K: np.ndarray              # (3, 3)
    mean_reprojection_error: float
    stats: Dict

    @property
    def num_points(self) -> int:
        return self.xyz.shape[0]

    def save_ply(self, prefix: str):
        from tpusfm_torch.io.ply import save_cameras_ply, save_point_cloud_ply

        save_point_cloud_ply(prefix + "_points.ply", self.xyz, self.rgb)
        scale = (float(np.median(np.linalg.norm(self.xyz - np.median(self.xyz, 0), axis=1)))
                 if len(self.xyz) else 1.0)
        save_cameras_ply(prefix + "_cameras.ply", self.poses, self.pose_valid,
                         scale=max(scale * 0.2, 1e-3))


class SfMPipeline:
    """Construct with images, ``run()``, export via the Reconstruction.

    images_gray (V, H, W) float32 in [0, 1]. Runs on ``device`` ("cuda"
    unless the caller asks for "cpu")."""

    def __init__(self, images_gray: np.ndarray, config: Optional[SfMConfig] = None,
                 images_rgb: Optional[np.ndarray] = None,
                 intrinsics: Optional[Intrinsics] = None, seed: int = 0,
                 device="cuda"):
        self.cfg = config or SfMConfig()
        self.device = torch.device(device)
        self.gray = np.asarray(images_gray, np.float32)
        self.rgb = images_rgb
        self.V, self.H, self.W = self.gray.shape
        if intrinsics is not None:
            self.intr = Intrinsics(*(torch.as_tensor(x, device=self.device)
                                     for x in (intrinsics.K, intrinsics.Kinv, intrinsics.dist)))
        else:
            f = self.cfg.default_focal / max(self.cfg.downscale, 1e-6)
            self.intr = Intrinsics.create(f, self.W / 2.0, self.H / 2.0, device=self.device)
        self._init_intr = self.intr
        self._build_kernels()
        self.reset(seed)

    def reset(self, seed: int = 0):
        """Clear reconstruction state; a reset pipeline replays the same
        random streams."""
        self.intr = self._init_intr
        self._seed = seed
        self._timings = {}
        cap = self.cfg.point_capacity
        self.xyz = np.zeros((cap, 3), np.float32)
        self.obs = np.full((cap, self.V), -1, np.int32)
        self.n_points = 0
        self.poses = np.zeros((self.V, 3, 4), np.float32)
        self.pose_valid = np.zeros((self.V,), bool)
        self.feat_xy: Optional[np.ndarray] = None
        self._fused_runs = -1

    def _build_kernels(self):
        cfg = self.cfg
        self._extract = functools.partial(
            extract_features, max_features=cfg.max_features, desc_bits=cfg.desc_bits,
            pyramid_levels=cfg.pyramid_levels, pyramid_scale=cfg.pyramid_scale,
            fast_threshold=cfg.fast_threshold / 255.0, score_kind=cfg.detector_score,
            sampling=cfg.descriptor_sampling)
        # the streaming matcher needs the full distance matrix only for
        # cross-check; it takes feature budgets that are multiples of 256
        if (cfg.use_pallas_matcher and not cfg.cross_check and cfg.matcher == MatcherKind.RICH
                and cfg.max_features % 256 == 0):
            self._match = lambda feats, pairs: match_pairs(
                feats.desc, feats.valid, pairs, ratio=cfg.match_ratio,
                max_matches=cfg.max_matches)
        else:
            self._match = functools.partial(
                match_all_pairs, ratio=cfg.match_ratio, cross_check=cfg.cross_check,
                max_matches=cfg.max_matches)

    def _log(self, level: int, msg: str):
        if level >= self.cfg.console_debug_level:
            print(f"[tpusfm_torch] {msg}", flush=True)

    def _undistort_features(self, feats: Features) -> Features:
        """Undistort keypoints once after extraction when the calibration
        carries distortion; every later stage is then pinhole."""
        if not bool((self.intr.dist != 0).any()):
            return feats
        xy = camera.undistort_points(self.intr.K, self.intr.Kinv, self.intr.dist, feats.xy)
        return dataclasses.replace(feats, xy=xy)

    def _fused_applicable(self) -> bool:
        return (self.cfg.fused and self.cfg.matcher == MatcherKind.RICH
                and not self.cfg.ba_refine_pp)

    def _point_colors(self) -> np.ndarray:
        """RGB per point averaged over its observing views (255 without RGB)."""
        n = self.n_points
        out = np.full((n, 3), 255, np.uint8)
        if self.rgb is None:
            return out
        acc = np.zeros((n, 3), np.float64)
        cnt = np.zeros((n,), np.int64)
        for v in range(self.V):
            sel = self.obs[:n, v] >= 0
            if not sel.any():
                continue
            uv = self.feat_xy[v][self.obs[:n, v][sel]]
            x = np.clip(uv[:, 0].round().astype(int), 0, self.W - 1)
            y = np.clip(uv[:, 1].round().astype(int), 0, self.H - 1)
            acc[sel] += self.rgb[v][y, x]
            cnt[sel] += 1
        ok = cnt > 0
        out[ok] = (acc[ok] / cnt[ok, None]).round().astype(np.uint8)
        return out

    def _run_fused(self) -> Reconstruction:
        from tpusfm_torch.pipeline.engine import FusedEngine

        if not hasattr(self, "_engine"):
            K = np_of(self.intr.K)
            self._engine = FusedEngine(self.cfg, self.V, self.H, self.W, f=float(K[0, 0]),
                                       cx=float(K[0, 2]), cy=float(K[1, 2]), device=self.device)
        extract_fn = lambda imgs: self._undistort_features(self._extract(imgs))
        gray_u8 = (np.clip(self.gray, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        self._fused_runs += 1
        out = self._engine.run(gray_u8, extract_fn, self._match,
                               seed=self._seed + self._fused_runs)
        if not bool(out["seeded"]):
            raise RuntimeError("no baseline pair could seed the reconstruction "
                               "(reference aborts the same way, MultiCameraPnP.cpp:144-147)")
        n = int(out["n_points"])
        if n >= self._engine.CAP:
            warnings.warn(f"map saturated engine_point_capacity={self._engine.CAP}: new points "
                          "were routed to the trash row; raise "
                          "SfMConfig.engine_point_capacity to keep them", RuntimeWarning)
        self.n_points = n
        self.xyz = out["xyz"][:n].copy()
        self.obs = out["obs"][:n].copy()
        self.poses = out["poses"].copy()
        self.pose_valid = out["pose_valid"].copy()
        self.feat_xy = out["feat_xy"]
        self.intr = Intrinsics.create(float(out["focal"]), self._engine.cx, self._engine.cy,
                                      dist=np_of(self.intr.dist), device=self.device)
        self._timings.update(self._engine.timings)
        stats = out["stats"]
        self._timings["ba_iters"] = int(stats[:, 9].sum())
        err = float(out["mean_err"])
        self._log(2, f"done (fused): {n} points, {int(self.pose_valid.sum())}/{self.V} "
                     f"cameras, mean reprojection error {err:.3f}px, "
                     f"{self._timings['total_s']:.2f}s")
        return Reconstruction(poses=self.poses.copy(), pose_valid=self.pose_valid.copy(),
                              xyz=self.xyz.copy(), rgb=self._point_colors(), obs=self.obs.copy(),
                              K=np_of(self.intr.K), mean_reprojection_error=err,
                              stats=dict(self._timings))

    def run(self) -> Reconstruction:
        """Full pipeline (SfM::runSfM, SfM.cpp:63-95) on the fused path."""
        if not self._fused_applicable():
            raise NotImplementedError(_NOT_PORTED)
        return self._run_fused()


def run_sfm(directory: str, config: Optional[SfMConfig] = None,
            output_prefix: Optional[str] = None, device="cuda") -> Reconstruction:
    """End-to-end convenience entry (main.cpp:71-78 equivalent)."""
    from tpusfm_torch.io.images import load_image_directory

    cfg = config or SfMConfig()
    imgs = load_image_directory(directory, cfg.downscale)
    rec = SfMPipeline(imgs.gray, cfg, images_rgb=imgs.rgb, device=device).run()
    if output_prefix:
        rec.save_ply(output_prefix)
    return rec
