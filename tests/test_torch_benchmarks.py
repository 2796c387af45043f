"""The port's benchmark tools (tpusfm_torch/tools/{synthetic, strecha_eval,
stress4k, scale_bench, config5_partial}.py) against the reference's
(benchmarks/), on the CPU.

Tolerances:
- Renders: the torch renderer repeats numpy's float64 operations in order;
  the products numpy hands to BLAS are written out and tanh may round
  differently, so an 8-bit pixel may differ by one (<= 1 LSB everywhere,
  >= 99.9% of pixels equal) and a float32 image by a few ulps (<= 1e-6);
  ``.camera`` files are byte-identical.
- Undistortion: both packages iterate the inverse Brown model 8 times in
  float32; the keypoints agree to 1e-3 px.
- Whole reconstructions draw from different random streams (threefry and
  torch.Generator), so their parity is statistical: both meet the bars
  (all but one camera, < 1 px, ATE < 5% of the camera spread) and their
  camera counts are within one.
- Bundle-adjustment problems: the same numpy draws give equal arrays; the
  solvers are float32 with sums in other orders, so costs agree to 1e-5
  relative.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from benchmarks import scale_bench as ref_scale
from benchmarks import strecha_eval as ref_eval
from benchmarks import strecha_fixture as ref_fixture
from benchmarks.collection_fixture import make_collection_textured
from tpusfm import SfMConfig as JConfig
from tpusfm.pipeline import SfMPipeline as JPipeline
from tpusfm.pipeline import window_pairs as j_window_pairs
from tpusfm.types import Features as JFeatures
from tpusfm.types import Intrinsics as JIntrinsics
from tpusfm_torch import SfMConfig
from tpusfm_torch.pipeline import SfMPipeline
from tpusfm_torch.tools import config5_partial, scale_bench, strecha_eval, stress4k, synthetic
from tpusfm_torch.types import Features, Intrinsics

torch.set_num_threads(1)

DIST = (-0.20, 0.05, 0.0)


def _pixels(path):
    return np.asarray(Image.open(path)).astype(np.int64)


@pytest.mark.parametrize("n_views,h,w,dist", [
    (3, 96, 128, DIST),
    (2, 64, 96, (0.0, 0.0, 0.0)),
    (1, 8, 1536, DIST),          # detail = 3: the loop of extra octaves runs
])
def test_fixture_equals_reference(tmp_path, n_views, h, w, dist):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    want_poses, want_K = ref_fixture.make_fixture(str(ref_dir), n_views=n_views, h=h, w=w,
                                                  dist=dist)
    got_poses, got_K = synthetic.make_fixture(str(port_dir), n_views=n_views, h=h, w=w,
                                              dist=dist, device="cpu")
    assert np.array_equal(got_poses, want_poses) and np.array_equal(got_K, want_K)
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(port_dir)) and len(names) == 2 * n_views
    for name in names:
        if name.endswith(".camera"):
            assert (ref_dir / name).read_bytes() == (port_dir / name).read_bytes(), name
            continue
        want, got = _pixels(ref_dir / name), _pixels(port_dir / name)
        assert got.shape == want.shape == (h, w)
        assert np.abs(got - want).max() <= 1
        assert (got == want).mean() >= 0.999
        assert want.std() > 20          # textured, not blank


def test_fixture_view_renders_what_the_png_holds(tmp_path):
    synthetic.make_fixture(str(tmp_path), n_views=2, h=48, w=64, dist=DIST)
    poses, K = synthetic.fixture_poses(2, 48, 64)
    view = synthetic.render_fixture_view(poses[1], K, DIST, 48, 64)
    assert view.dtype == torch.uint8
    assert np.array_equal(view.numpy(), _pixels(tmp_path / "0001.png"))


def test_collection_scene_equals_reference():
    want_imgs, want_poses, want_K = make_collection_textured(n_views=12)
    imgs, poses, K = synthetic.make_collection_scene(n_views=12)
    assert np.array_equal(imgs, want_imgs)        # the numpy route: the same operations
    assert np.array_equal(poses, want_poses) and np.array_equal(K, want_K)
    dev_imgs, dev_poses, _ = synthetic.make_collection_scene(n_views=12, device="cpu")
    assert dev_imgs.dtype == np.float32 and np.array_equal(dev_poses, want_poses)
    assert np.abs(dev_imgs - want_imgs).max() <= 1e-6
    assert (dev_imgs == want_imgs).mean() >= 0.999


def test_load_strecha_camera_equals_reference(tmp_path):
    ref_fixture.make_fixture(str(tmp_path), n_views=3, h=24, w=32, dist=DIST)
    for name in sorted(f for f in os.listdir(tmp_path) if f.endswith(".camera")):
        got = strecha_eval.load_strecha_camera(str(tmp_path / name))
        want = ref_eval.load_strecha_camera(str(tmp_path / name))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    K, dist, poses = strecha_eval.load_ground_truth(str(tmp_path))
    assert np.allclose(dist, DIST) and poses.shape == (3, 3, 4)
    assert np.allclose(poses, ref_fixture.make_fixture(str(tmp_path / "again"), n_views=3,
                                                       h=24, w=32, dist=DIST)[0], atol=1e-7)


def test_undistort_features_equals_reference():
    """SfMPipeline._undistort_features in both packages on the same raw
    keypoints, at the fixture's distortion (shifts of up to ~20 px)."""
    rng = np.random.default_rng(0)
    V, F, h, w, f = 3, 256, 384, 512, 520.0
    xy = np.stack([rng.uniform(0, w, (V, F)), rng.uniform(0, h, (V, F))], -1).astype(np.float32)
    desc = np.where(rng.uniform(size=(V, F, 256)) > 0.5, 1.0, -1.0).astype(np.float32)
    score = rng.uniform(size=(V, F)).astype(np.float32)
    valid = rng.uniform(size=(V, F)) > 0.1
    dist = [DIST[0], DIST[1], 0.0, 0.0, DIST[2]]
    blank = np.zeros((V, 8, 8), np.float32)
    jpipe = JPipeline(blank, JConfig(console_debug_level=5),
                      intrinsics=JIntrinsics.create(f, w / 2, h / 2, dist=dist))
    tpipe = SfMPipeline(blank, SfMConfig(console_debug_level=5),
                        intrinsics=Intrinsics.create(f, w / 2, h / 2, dist=dist), device="cpu")
    want = jpipe._undistort_features(JFeatures(
        xy=jnp.asarray(xy), desc=jnp.asarray(desc), score=jnp.asarray(score),
        angle=jnp.zeros((V, F)), valid=jnp.asarray(valid)))
    got = tpipe._undistort_features(Features(
        xy=torch.as_tensor(xy), desc=torch.as_tensor(desc), score=torch.as_tensor(score),
        angle=torch.zeros(V, F), valid=torch.as_tensor(valid)))
    want_xy = np.asarray(want.xy)
    assert np.abs(got.xy.numpy() - want_xy).max() < 1e-3
    assert np.linalg.norm(want_xy - xy, axis=-1).max() > 5.0       # the model did move them
    assert torch.equal(got.desc, torch.as_tensor(desc)) and torch.equal(got.valid,
                                                                        torch.as_tensor(valid))


# Six views at the fixture's own size. Smaller renders (6 x 192x256 at either
# focal, 6 x 288x384) leave the ATE bar in both packages alike (0.69-1.28 of a
# 5.0 spread), so they test the scene, not the port.
SMALL_FIXTURE = dict(n_views=6, h=384, w=512)
SMALL_CONFIG = dict(downscale=1.0, ba_share_focal=False, max_features=1024, max_matches=512,
                    console_debug_level=5)


def test_evaluate_distorted_fixture_against_reference(tmp_path):
    """The calibrated reconstruction of a small distorted fixture, end to end
    in both packages."""
    synthetic.make_fixture(str(tmp_path), dist=DIST, **SMALL_FIXTURE)
    got = strecha_eval.evaluate(str(tmp_path), 1.0, SfMConfig(**SMALL_CONFIG), device="cpu")
    want = ref_eval.evaluate(str(tmp_path), 1.0, JConfig(**SMALL_CONFIG))
    want["detail"]["camera_spread"] = got["detail"]["camera_spread"]   # the same cameras
    assert strecha_eval.meets_bars(got), got
    assert strecha_eval.meets_bars(want), want
    n_got, n_want = (int(r["detail"]["cameras"].split("/")[0]) for r in (got, want))
    assert abs(n_got - n_want) <= 1


def test_stress_run_rehearsal():
    """stress4k's cold run, reset() and warm run at a CPU's size (3 views at
    256x192 test the tool, not the configuration): the warm run takes the
    fused path, undistorts the keypoints again and reconstructs."""
    out = stress4k.run(views=3, width=256, height=192, features=512, matches=512,
                       device="cpu", card="cpu")
    assert out["fused"] and out["match_top2_launches_warm"] == 0     # the plain version
    assert out["undistortion_shift_max_px"] > 5.0
    assert int(out["cameras"].split("/")[0]) >= 2 and out["points"] > 0
    assert out["mean_reprojection_px"] < 1.0
    assert out["cold_s"] > 0 and out["warm_s"] > 0 and out["stage_s"]["features_s"] > 0


def test_matching_problem_equals_reference():
    rng = np.random.default_rng(0)
    want1 = np.sign(rng.standard_normal((3, 256, 256))).astype(np.float32)
    want2 = np.sign(rng.standard_normal((3, 256, 256))).astype(np.float32)
    d1, d2, v2 = scale_bench.matching_problem(3, 256, device="cpu")
    assert d1.dtype == torch.int8 and v2.dtype == torch.bool and bool(v2.all())
    assert np.array_equal(d1.numpy(), want1) and np.array_equal(d2.numpy(), want2)
    line = scale_bench.bench_matching(3, 256, repeats=1, device="cpu")
    assert line["metric"] == "match_pairs_per_s" and line["value"] > 0


def test_sparse_problem_against_reference():
    want = ref_scale.bench_sparse_ba(20, 500, 4, iterations=3, cg_iterations=24, repeats=1)
    got = scale_bench.bench_sparse_ba(20, 500, 4, iterations=3, cg_iterations=24, repeats=1,
                                      device="cpu")
    w, g = want["detail"], got["detail"]
    assert abs(g["initial_cost"] - w["initial_cost"]) <= 1e-5 * w["initial_cost"]
    assert g["final_cost"] < g["initial_cost"] and g["iterations"] == 3
    prob = scale_bench.sparse_problem(20, 500, 4)
    assert prob.cam_idx.shape == (2000,) and prob.cams.shape == (20, 6)


def test_dense_problem_against_reference(monkeypatch, eight_devices):
    """The dense bench on a gloo world of one against tpusfm's 8-device CPU
    mesh: every solve's inputs equal, every solve's initial cost within
    1e-5, both lowering it."""
    import tpusfm.dist
    import torch.distributed as dist

    import tpusfm_torch.dist

    seen = {"ref": [], "port": []}

    def spy(key, fn):
        def call(mesh, *args, **kw):
            out = fn(mesh, *args, **kw)
            seen[key].append(([np.asarray(a) for a in args], float(out[3].initial_cost),
                              float(out[3].final_cost)))
            return out
        return call

    monkeypatch.setattr(tpusfm.dist, "adjust_bundle_sharded",
                        spy("ref", tpusfm.dist.adjust_bundle_sharded))
    monkeypatch.setattr(tpusfm_torch.dist, "adjust_bundle_sharded",
                        spy("port", tpusfm_torch.dist.adjust_bundle_sharded))
    ref_scale.bench_distributed_ba(256, 8, iterations=3, repeats=1)
    try:
        line = scale_bench.bench_distributed_ba(256, 8, iterations=3, repeats=1, device="cpu")
    finally:
        dist.destroy_process_group()
    assert "1 rank" in line["unit"]
    assert len(seen["ref"]) == len(seen["port"]) == 2
    for (want_args, want_c0, want_c1), (got_args, got_c0, got_c1) in zip(seen["ref"],
                                                                         seen["port"]):
        for w, g in zip(want_args[:-1], got_args[:-1]):       # all but K
            assert np.array_equal(g, w)
        assert np.allclose(got_args[-1], want_args[-1])
        assert abs(got_c0 - want_c0) <= 1e-5 * want_c0
        assert got_c1 < got_c0 and want_c1 < want_c0


def test_config5_probe_rehearsal():
    out = config5_partial.run(views=24, device="cpu", card="cpu")
    assert out["pairs"] == len(j_window_pairs(24, 8, True)) == 24 * 8
    assert out["match_top2_launches"] == 0          # the plain matcher on the CPU
    assert out["tracks"] > 0 and out["tracks_triangulated"] > 0 and out["observations"] > 0
    assert out["ba_iterations"] > 0 and out["ba_final_cost"] < out["ba_initial_cost"]
    assert out["mean_reprojection_px"] < 1.0
    assert set(out["stage_s"]) >= {"render_s", "features_s", "matching_s", "prune_s",
                                   "tracks_s", "triangulate_s", "global_ba_s"}
