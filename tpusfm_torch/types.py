"""Core data model: fixed-shape, padded, masked struct-of-arrays.

Counterpart of ``tpusfm/types.py`` as frozen dataclasses of tensors.
Variable-length collections (keypoints, matches, map points) are padded
to static capacities with validity masks; provenance is a dense
``(N_points, N_views)`` int32 table with -1 sentinels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _tensors(cls):
    return dataclasses.dataclass(frozen=True)(cls)


@_tensors
class Intrinsics:
    """Pinhole intrinsics: K (3,3), Kinv (3,3), dist (5,) (k1 k2 p1 p2 k3)."""

    K: torch.Tensor
    Kinv: torch.Tensor
    dist: torch.Tensor

    @staticmethod
    def create(f: float, cx: float, cy: float, dist=None,
               device="cpu") -> "Intrinsics":
        K = torch.tensor([[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]],
                         dtype=torch.float32, device=device)
        d = (torch.zeros(5, dtype=torch.float32, device=device) if dist is None
             else torch.as_tensor(np.asarray(dist, np.float32), device=device))
        return Intrinsics(K=K, Kinv=torch.linalg.inv(K), dist=d)

    @property
    def focal(self) -> torch.Tensor:
        return self.K[0, 0]

    @property
    def pp(self) -> torch.Tensor:
        return self.K[:2, 2]


@_tensors
class Features:
    """Per-view keypoints + ±1 descriptors, padded to capacity F."""

    xy: torch.Tensor      # (V, F, 2) float32 pixel coords
    desc: torch.Tensor    # (V, F, D) ±1 (0 on invalid slots)
    score: torch.Tensor   # (V, F)
    angle: torch.Tensor   # (V, F) radians
    valid: torch.Tensor   # (V, F) bool

    @property
    def num_views(self) -> int:
        return self.xy.shape[0]

    @property
    def capacity(self) -> int:
        return self.xy.shape[1]

    def view(self, i: int) -> "Features":
        """View i's features as a batch of one: (1, F, ...)."""
        return Features(*(getattr(self, f.name)[i:i + 1] for f in dataclasses.fields(self)))


@_tensors
class Matches:
    """Matches padded to capacity M: idx (..., M, 2) int32 (-1 padded),
    dist (..., M) float32, valid (..., M) bool. idx[..., 0] indexes the
    left view's features, idx[..., 1] the right view's."""

    idx: torch.Tensor
    dist: torch.Tensor
    valid: torch.Tensor

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum(-1)


@_tensors
class PointCloud:
    """Map points + dense provenance: obs[n, v] = feature index or -1."""

    xyz: torch.Tensor     # (N, 3)
    rgb: torch.Tensor     # (N, 3) in [0, 1]
    obs: torch.Tensor     # (N, V) int32
    valid: torch.Tensor   # (N,) bool

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum()

    @staticmethod
    def empty(capacity: int, num_views: int, device="cpu") -> "PointCloud":
        return PointCloud(
            xyz=torch.zeros(capacity, 3, device=device),
            rgb=torch.zeros(capacity, 3, device=device),
            obs=torch.full((capacity, num_views), -1, dtype=torch.int32, device=device),
            valid=torch.zeros(capacity, dtype=torch.bool, device=device),
        )


@_tensors
class Poses:
    """World->camera [R|t] per view plus a registered mask."""

    Rt: torch.Tensor      # (V, 3, 4)
    valid: torch.Tensor   # (V,) bool

    @staticmethod
    def empty(num_views: int, device="cpu") -> "Poses":
        return Poses(Rt=torch.zeros(num_views, 3, 4, device=device),
                     valid=torch.zeros(num_views, dtype=torch.bool, device=device))

    def set(self, view: int, Rt: torch.Tensor) -> "Poses":
        """A copy with view's pose set to Rt (3, 4) and marked registered."""
        new_Rt, valid = self.Rt.clone(), self.valid.clone()
        new_Rt[view] = Rt
        valid[view] = True
        return Poses(Rt=new_Rt, valid=valid)


def np_of(x: torch.Tensor) -> np.ndarray:
    """Tensor -> writable host numpy copy (one sync point)."""
    return x.detach().cpu().numpy().copy()
