"""The port's viz, eval and profiling modules against tpusfm's.

``sor_filter_mask`` and ``voxel_grid_filter`` on seeded numpy clouds: the
mask must equal ``tpusfm.viz``'s exactly, the centroids to 1e-5. ``eval``
agrees with ``tpusfm.eval`` to 1e-6. Overlays, HTML viewer and live viewer
repeat the cases of tests/test_viz.py on the port; the stage helper that
took the place of profile/report times a block and spans it in a trace.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import tpusfm.eval as jeval
import tpusfm.viz as jviz
from tpusfm_torch import SfMConfig, eval as teval
from tpusfm_torch.pipeline import SfMPipeline
from tpusfm_torch.types import Intrinsics
from tpusfm_torch.utils import profiling
from tpusfm_torch.viz import (
    LiveViewer,
    draw_keypoints,
    draw_matches,
    draw_reprojections,
    export_html_viewer,
    sor_filter,
    sor_filter_mask,
    voxel_grid_filter,
)

torch.set_num_threads(1)


def _cloud(seed, n=400, n_out=12):
    rng = np.random.default_rng(seed)
    dense = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    outliers = rng.uniform(50, 60, (n_out, 3)).astype(np.float32)
    return np.concatenate([dense, outliers])


@pytest.mark.parametrize("seed,n,mean_k,mult", [(2, 400, 50, 1.0), (5, 1500, 50, 1.0),
                                                (7, 300, 8, 2.0)])
def test_sor_filter_mask_equals_reference(seed, n, mean_k, mult):
    pts = _cloud(seed, n)             # n = 1500 spans two query tiles
    valid = np.random.default_rng(seed).uniform(0, 1, len(pts)) < 0.9
    for v in (None, valid):
        got = sor_filter_mask(pts, v, mean_k=mean_k, stddev_mult=mult, device="cpu")
        want = jviz.sor_filter_mask(pts, v, mean_k=mean_k, stddev_mult=mult)
        np.testing.assert_array_equal(got, want)
    assert not got[n:].any() and got[:n].sum() >= 0.8 * n


def test_sor_filter_removes_outliers_and_respects_small_clouds():
    pts = _cloud(2)
    mask = sor_filter_mask(pts, mean_k=50, stddev_mult=1.0, device="cpu")
    assert not mask[400:].any()
    assert mask[:400].sum() >= 360
    colors = np.tile(np.arange(len(pts))[:, None], (1, 3)).astype(np.uint8)
    fpts, fcol = sor_filter(pts, colors, device="cpu")
    assert fpts.shape[0] == fcol.shape[0] == mask.sum()
    # fewer valid points than mean_k: no-op passthrough of the valid mask
    small = np.random.default_rng(0).normal(size=(30, 3)).astype(np.float32)
    valid = np.ones(30, bool)
    valid[5] = False
    assert (sor_filter_mask(small, valid, mean_k=50, device="cpu") == valid).all()


def test_voxel_grid_filter_equals_reference():
    pts = np.array([[0.01, 0.01, 0.01], [0.02, 0.03, 0.02], [5.0, 5.0, 5.0]], np.float32)
    out = voxel_grid_filter(pts, leaf_size=0.1, device="cpu")
    assert out.shape == (2, 3)
    near = out[np.argmin(np.abs(out).sum(1))]
    np.testing.assert_allclose(near, pts[:2].mean(0), atol=1e-5)

    rng = np.random.default_rng(4)
    cloud = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (2000, 3)).astype(np.float32)
    got_p, got_c = voxel_grid_filter(cloud, colors, leaf_size=0.25, device="cpu")
    want_p, want_c = jviz.voxel_grid_filter(cloud, colors, leaf_size=0.25)
    assert got_p.shape == want_p.shape and 100 < len(got_p) < 2000
    np.testing.assert_allclose(got_p, want_p, atol=1e-5)
    np.testing.assert_allclose(got_c, want_c, atol=1e-5)
    np.testing.assert_allclose(voxel_grid_filter(cloud, leaf_size=0.25, device="cpu"), want_p,
                               atol=1e-5)


def test_eval_equals_reference():
    rng = np.random.default_rng(0)
    from tpusfm_torch.camera import euler_to_matrix

    gt = np.stack([np.concatenate([euler_to_matrix(*rng.uniform(-0.3, 0.3, 3)).numpy(),
                                   rng.uniform(-2, 2, (3, 1)).astype(np.float32)], 1)
                   for _ in range(6)])
    # the same trajectory under a similarity, plus noise on the centres
    Rg = euler_to_matrix(0.4, -0.2, 0.7).numpy()
    est = gt.copy()
    est[:, :, :3] = gt[:, :, :3] @ Rg.T
    est[:, :, 3] = 1.7 * gt[:, :, 3] + rng.normal(0, 0.01, (6, 3))
    assert abs(teval.ate_rmse(est, gt) - jeval.ate_rmse(est, gt)) < 1e-6
    assert 0.0 < teval.ate_rmse(est, gt) < 0.05
    np.testing.assert_allclose(teval.rotation_errors_deg(est, gt),
                               jeval.rotation_errors_deg(est, gt), atol=1e-6)
    np.testing.assert_allclose(teval.camera_centers(est), jeval.camera_centers(est), atol=1e-6)
    for a, b in zip(teval.umeyama_alignment(teval.camera_centers(est), teval.camera_centers(gt)),
                    jeval.umeyama_alignment(jeval.camera_centers(est), jeval.camera_centers(gt))):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_overlays(tmp_path):
    img = np.random.default_rng(0).uniform(0, 1, (120, 160)).astype(np.float32)
    xy = np.random.default_rng(1).uniform(10, 100, (40, 2)).astype(np.float32)
    p1 = str(tmp_path / "kp.png")
    draw_keypoints(p1, img, xy)
    p2 = str(tmp_path / "m.png")
    draw_matches(p2, img, img, xy, xy + 3.0)
    p3 = str(tmp_path / "r.png")
    draw_reprojections(p3, img, xy, xy + 1.5)
    for p in (p1, p2, p3):
        assert os.path.getsize(p) > 500


def test_html_viewer_and_reconstruction_exports(tmp_path):
    from tpusfm_torch.pipeline import Reconstruction

    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    rgb = (rng.uniform(0, 255, (500, 3))).astype(np.uint8)
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (3, 1, 1))
    valid = np.array([True, True, False])
    p = str(tmp_path / "v.html")
    export_html_viewer(p, xyz, rgb, poses, valid)
    html = open(p).read()
    assert "500 points" in html and "2 cameras" in html
    assert html.count("rgb(") >= 1

    rec = Reconstruction(poses=poses, pose_valid=valid, xyz=xyz, rgb=rgb,
                         obs=np.zeros((500, 3), np.int32), K=np.eye(3, dtype=np.float32),
                         mean_reprojection_error=0.5, stats={})
    kept = rec.select_points(np.arange(500) % 2 == 0)
    assert kept.num_points == 250 and kept.obs.shape == (250, 3) and kept.rgb.shape == (250, 3)
    np.testing.assert_array_equal(kept.xyz, xyz[::2])
    assert kept.poses is rec.poses and kept.mean_reprojection_error == 0.5
    kept.save_html(str(tmp_path / "k.html"))
    assert "250 points" in open(tmp_path / "k.html").read()


def test_live_viewer_streams_frames(tmp_path):
    html = str(tmp_path / "live.html")
    v = LiveViewer(html)
    rng = np.random.default_rng(0)
    for k in range(3):
        n = 50 + 20 * k
        xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        rgb = rng.integers(0, 255, (n, 3)).astype(np.uint8)
        poses = np.tile(np.eye(3, 4, dtype=np.float32), (2 + k, 1, 1))
        v.update(xyz, rgb, poses, np.ones(2 + k, bool))
    frames = json.load(open(tmp_path / "frames.json"))
    assert len(frames) == 3
    assert len(frames[2]["cams"]) == 4
    assert [len(f["pts"]) for f in frames] == [300, 420, 540]
    page = open(html).read()
    assert "seek" in page and "LIVE" in page


def test_profile_accumulates_and_traces(tmp_path):
    """``profiling.stage``: host-clock seconds into a timing (added with
    ``add=True``, else in place of the last), and under torch.profiler a
    span of the same name around the block's operators."""
    timings = {}
    for _ in range(2):
        with profiling.stage("stage_a", timings, "a_s", add=True):
            time.sleep(0.01)
    with profiling.stage("stage_b", timings, "b_s") as b:
        time.sleep(0.01)
    with profiling.stage("stage_b", timings, "b_s") as b:
        pass
    assert timings["a_s"] >= 0.02 and timings["b_s"] == b.seconds < 0.01
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.stage("stage_c", timings, "c_s"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    (span,) = [e for e in events if e.get("name") == "stage_c"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm and all(span["ts"] <= e["ts"] and e["ts"] + e["dur"] <= span["ts"] + span["dur"]
                      for e in mm)
    assert timings["c_s"] > 0.0


def test_visual_debug_dumps(tmp_path):
    from tests.synthetic_scene import make_scene

    imgs, poses, K, dots = make_scene(n_views=3, n_dots=200, h=120, w=160)
    cfg = SfMConfig(max_features=512, max_matches=256, console_debug_level=5,
                    visual_debug_level=1, debug_dir=str(tmp_path / "dbg"),
                    epipolar_prune=False)
    pipe = SfMPipeline(imgs, cfg, device="cpu",
                       intrinsics=Intrinsics.create(float(K[0, 0]), float(K[0, 2]),
                                                    float(K[1, 2])))
    pipe.extract()
    pipe.match()
    files = os.listdir(cfg.debug_dir)
    assert any(f.startswith("matches_") for f in files)
    assert any(f.startswith("keypoints_") for f in files)
