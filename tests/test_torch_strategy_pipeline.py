"""Each matcher strategy through both packages' ``SfMPipeline``.

``make_scene(n_views=5, n_dots=400)`` goes through tpusfm's and the port's
pipeline at seed 1 with the configuration of tests/test_torch_host_loop.py,
once per strategy (optical flow, dense, stereo, SURF blobs). The fused path
is the rich matcher's only, in both packages, so every run is the
host-driven loop. The random streams differ, so the parity is statistical:
where tpusfm meets the reference's bars (>= 4 of 5 cameras, < 1 px, ATE
< 0.2 of the camera spread), the port meets them too and its camera centres
agree with tpusfm's within an ATE of 5% of the spread; where tpusfm does
not (the stereo strategy assumes rectified pairs and seeds only its
baseline here), the port registers as many cameras, give or take one.
"""
import numpy as np
import pytest
import torch

from tests.synthetic_scene import camera_centers, make_scene
from tests.test_torch_host_loop import CFG, _agree, _ate, _meets_bars
from tpusfm import SfMConfig as JConfig
from tpusfm.config import MatcherKind as JMatcherKind
from tpusfm.pipeline import SfMPipeline as JPipeline
from tpusfm.types import Intrinsics as JIntrinsics
from tpusfm_torch import MatcherKind, SfMConfig
from tpusfm_torch.pipeline import SfMPipeline
from tpusfm_torch.types import Intrinsics

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    return make_scene(n_views=5, n_dots=400)


def _meets(scene, rec) -> bool:
    pv = rec.pose_valid
    if pv.sum() < 4 or not rec.mean_reprojection_error < 1.0:
        return False
    gt_c = camera_centers(scene[1][pv])
    return _ate(camera_centers(rec.poses[pv]), gt_c) < 0.2 * np.linalg.norm(
        gt_c.max(0) - gt_c.min(0))


@pytest.mark.parametrize("kind", ["of", "dense", "stereo", "surf"])
def test_strategy_against_tpusfm(scene, kind):
    imgs, _, K, _ = scene
    f, cx, cy = float(K[0, 0]), float(K[0, 2]), float(K[1, 2])
    ref = JPipeline(imgs, JConfig(**CFG, fused=False, matcher=JMatcherKind(kind)), seed=1,
                    intrinsics=JIntrinsics.create(f, cx, cy)).run()
    pipe = SfMPipeline(imgs, SfMConfig(**CFG, matcher=MatcherKind(kind)), seed=1,
                       intrinsics=Intrinsics.create(f, cx, cy), device="cpu")
    assert not pipe._fused_applicable()
    rec = pipe.run()
    assert np.isfinite(rec.xyz).all() and rec.num_points > 0
    assert ((rec.obs >= 0).sum(1) >= 2).all()
    if _meets(scene, ref):
        _meets_bars(scene[1], rec.poses, rec.pose_valid, rec.mean_reprojection_error)
        _agree(rec, ref)
    else:
        assert abs(int(rec.pose_valid.sum()) - int(ref.pose_valid.sum())) <= 1
