"""The port's host-driven reconstruction loop against tpusfm's.

``make_scene(n_views=5, n_dots=400)`` goes through both packages' host
loops (``fused=False``) with the configuration of
tests/test_pipeline_extras.py. The random streams differ (threefry vs
torch.Generator), so end-to-end parity is statistical: the port must meet
the reference's bars (>= 4 of 5 cameras, < 1 px mean reprojection, ATE
< 0.2 of the camera spread) and its camera centres must agree with
tpusfm's host loop, and with the port's own fused run, within an ATE of
5% of the camera spread after similarity alignment.

Checkpoints cross the packages in both directions (same ``.npz`` keys),
and host state carried over through ``tpusfm_torch.convert`` gives equal
2D-3D lookups (exactly) and reprojection errors (to 1e-4 px). The
reference is pinned to its numpy path. One JAX host-loop run per module,
at seed 1: on this scene (homography-inlier ratios near 0.98, so short
baselines) tpusfm's own host loop leaves its bars at seed 0 (ATE 26% of
the spread, the shared focal drifting from 300 to 417 px) and meets them
at seed 1 (ATE 0.9%), which is the run a port can be held against.
"""
import dataclasses

import numpy as np
import pytest
import torch

import tpusfm.native as jnative
from tests.synthetic_scene import camera_centers, make_scene, umeyama_alignment
from tpusfm import SfMConfig as JConfig
from tpusfm.pipeline import SfMPipeline as JPipeline
from tpusfm.types import Intrinsics as JIntrinsics
from tpusfm_torch import MatcherKind, SfMConfig, convert
from tpusfm_torch.pipeline import SfMPipeline
from tpusfm_torch.types import Intrinsics

torch.set_num_threads(1)
CFG = dict(max_features=1024, max_matches=512, console_debug_level=5,
           min_point_count_for_homography=60)


def _ate(est, ref):
    s, R, t = umeyama_alignment(est, ref)
    return float(np.sqrt(np.mean(np.sum((ref - (s * (est @ R.T) + t)) ** 2, 1))))


def _meets_bars(poses_gt, poses, pose_valid, reproj_px):
    assert int(pose_valid.sum()) >= 4
    assert reproj_px < 1.0
    gt_c = camera_centers(poses_gt[pose_valid])
    spread = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
    assert _ate(camera_centers(poses[pose_valid]), gt_c) < 0.2 * spread


def _agree(rec_a, rec_b):
    both = rec_a.pose_valid & rec_b.pose_valid
    assert int(both.sum()) >= 4
    ref_c = camera_centers(rec_b.poses[both])
    spread = float(np.linalg.norm(ref_c.max(0) - ref_c.min(0)))
    assert _ate(camera_centers(rec_a.poses[both]), ref_c) < 0.05 * spread


@pytest.fixture(scope="module")
def scene():
    return make_scene(n_views=5, n_dots=400)


def _port_pipe(scene, seed=0, **kw):
    imgs, _, K, _ = scene
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
    return SfMPipeline(imgs, SfMConfig(**{**CFG, "fused": False, **kw}), intrinsics=intr,
                       device="cpu", seed=seed)


def _spy_intrinsics(pipe, names):
    """Record (stage, focal of the K, focal of the Kinv) that each named
    stage of ``pipe`` is handed; K and Kinv are every stage's last two
    arguments."""
    calls = []
    for name in names:
        def spy(*a, _fn=getattr(pipe, name), _name=name):
            calls.append((_name, float(np.asarray(a[-2])[0, 0]),
                          float(1.0 / np.asarray(a[-1])[0, 0])))
            return _fn(*a)
        setattr(pipe, name, spy)
    return calls


@pytest.fixture(scope="module")
def port_run(scene):
    """(pipeline, reconstruction, listener snapshots) of the port's host loop."""
    pipe = _port_pipe(scene)
    snapshots = []
    pipe.add_listener(lambda xyz, rgb, p, pv: snapshots.append((len(xyz), int(pv.sum()))))
    return pipe, pipe.run(), snapshots


@pytest.fixture(scope="module")
def ref_run(scene, tmp_path_factory):
    """tpusfm's host loop by stages: (pipeline, path of the checkpoint saved
    after its baseline, reconstruction)."""
    imgs, _, K, _ = scene
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "available", lambda: False)
    try:
        pipe = JPipeline(imgs, JConfig(**CFG, fused=False), seed=1,
                         intrinsics=JIntrinsics.create(float(K[0, 0]), float(K[0, 2]),
                                                       float(K[1, 2])))
        pipe.extract()
        pipe.match()
        assert pipe.find_baseline_triangulation()
        ckpt = str(tmp_path_factory.mktemp("ref") / "after_baseline.npz")
        pipe.save_checkpoint(ckpt)
        pipe.add_more_views()
    finally:
        mp.undo()
    rec = dataclasses.make_dataclass("Rec", ["poses", "pose_valid"])(pipe.poses.copy(),
                                                                   pipe.pose_valid.copy())
    return pipe, ckpt, rec


def test_host_loop_meets_reference_bars(scene, port_run):
    pipe, rec, _ = port_run
    _meets_bars(scene[1], rec.poses, rec.pose_valid, rec.mean_reprojection_error)
    assert rec.num_points > 100
    assert ((rec.obs >= 0).sum(1) >= 2).all()
    assert set(rec.stats) >= {"features_s", "matching_s", "prune_s", "baseline_s",
                              "add_views_s", "ba_s", "ba_iters", "total_s"}
    assert pipe.done_views == set(range(5))
    assert pipe.good_views == set(np.nonzero(rec.pose_valid)[0].tolist())


def test_host_loop_agrees_with_tpusfm_host_loop(port_run, ref_run):
    _agree(port_run[1], ref_run[2])
    assert abs(port_run[1].num_points - ref_run[0].n_points) <= 0.25 * ref_run[0].n_points


def test_add_view_steps_read_K_once(scene, ref_run):
    """From the same state after the baseline (tpusfm's checkpoint), both
    packages' add_more_views hand PnP and the triangulation the K read
    before the first view and the Kinv of the current focal, which each BA
    moves (tpusfm/pipeline/incremental.py:853, :879, :928): the triangulation
    normalises with the new focal and gates the reprojection with the first
    one. A port that read K afresh at every view kept more points and left
    tpusfm's outcome on the 1024x768 scene (ROADMAP.md §3)."""
    _, ckpt, _ = ref_run
    imgs, _, K, _ = scene
    ref = JPipeline(imgs, JConfig(**CFG, fused=False), seed=1,
                    intrinsics=JIntrinsics.create(float(K[0, 0]), float(K[0, 2]),
                                                  float(K[1, 2])))
    ref.load_checkpoint(ckpt)
    port = convert.load_tpusfm_checkpoint(_port_pipe(scene), ckpt)
    entry = float(np.asarray(ref.intr.K)[0, 0])
    assert float(port.intr.K[0, 0]) == entry
    seen = {"tpusfm": _spy_intrinsics(ref, ("_jit_pnp", "_jit_prune_triangulate")),
            "port": _spy_intrinsics(port, ("_pnp", "_prune_triangulate"))}
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "available", lambda: False)
    try:
        ref.add_more_views()
    finally:
        mp.undo()
    port.add_more_views()
    for name, calls in seen.items():
        assert {c[0] for c in calls} == set(
            ("_jit_pnp", "_jit_prune_triangulate") if name == "tpusfm"
            else ("_pnp", "_prune_triangulate")), name
        assert all(c[1] == entry for c in calls), (name, calls)
        moved = [c for c in calls if abs(c[2] - entry) > 1e-3 * entry]
        assert moved, f"{name}: no BA moved the focal, so the check shows nothing"


def test_host_loop_agrees_with_fused_run(scene, port_run):
    imgs, _, K, _ = scene
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
    pipe = SfMPipeline(imgs, SfMConfig(**CFG), intrinsics=intr, device="cpu")
    assert pipe._fused_applicable()
    rec = pipe.run()
    _agree(port_run[1], rec)
    # the fused result is mirrored into the host state
    assert pipe.done_views == set(range(5))
    assert pipe.good_views == set(np.nonzero(rec.pose_valid)[0].tolist())
    assert pipe.feat_valid.shape == (5, 1024) and pipe.feat_valid.dtype == bool


def test_update_listener_streams_growing_cloud(port_run):
    _, rec, snapshots = port_run
    assert len(snapshots) >= 2, "listener must fire for baseline + each view"
    sizes = [s[0] for s in snapshots]
    assert sizes[-1] >= sizes[0]
    assert snapshots[0][1] == 2  # baseline registers exactly two cameras
    assert snapshots[-1] == (rec.num_points, int(rec.pose_valid.sum()))


def test_listeners_route_to_classic_path():
    """Observers need per-view host snapshots, so a pipeline with a
    registered listener must not take the fused device path."""
    pipe = SfMPipeline(np.zeros((3, 32, 32), np.float32),
                       SfMConfig(max_features=16, max_matches=8), device="cpu")
    assert pipe._fused_applicable()
    pipe.add_listener(lambda *a: None)
    assert not pipe._fused_applicable()


def test_reset_replays_bit_for_bit(port_run):
    pipe, rec, snapshots = port_run
    n_calls = len(snapshots)
    pipe.reset(1)                       # another seed draws other samples
    other = torch.rand(8, generator=pipe._gen)
    pipe.reset(0)
    assert not torch.equal(torch.rand(8, generator=pipe._gen), other)
    pipe.reset(0)
    assert pipe.n_points == 0 and pipe.features is None and not pipe.done_views
    again = pipe.run()
    np.testing.assert_array_equal(again.poses, rec.poses)
    np.testing.assert_array_equal(again.xyz, rec.xyz)
    np.testing.assert_array_equal(again.obs, rec.obs)
    assert again.mean_reprojection_error == rec.mean_reprojection_error
    assert snapshots[n_calls:] == snapshots[:n_calls]


def test_checkpoint_resume(tmp_path, scene):
    pipe = _port_pipe(scene)
    pipe.extract()
    pipe.match()
    assert pipe.find_baseline_triangulation()
    ckpt = str(tmp_path / "state.npz")
    pipe.save_checkpoint(ckpt)

    pipe2 = _port_pipe(scene)
    pipe2.load_checkpoint(ckpt)
    assert pipe2.n_points == pipe.n_points
    assert pipe2.done_views == pipe.done_views and pipe2.good_views == pipe.good_views
    np.testing.assert_array_equal(pipe2.poses, pipe.poses)
    np.testing.assert_array_equal(pipe2.match_valid, pipe.match_valid)
    assert torch.equal(pipe2.features.desc, pipe.features.desc)
    # resume the incremental loop from the checkpoint
    pipe2.add_more_views()
    _meets_bars(scene[1], pipe2.poses, pipe2.pose_valid, pipe2.mean_reprojection_error())


def test_tpusfm_checkpoint_resumes_in_port(scene, ref_run):
    """A checkpoint saved by tpusfm after its baseline loads into the port,
    which finishes the reconstruction within the bars."""
    ref, ckpt, _ = ref_run
    pipe = convert.load_tpusfm_checkpoint(_port_pipe(scene), ckpt)
    with np.load(ckpt) as d:
        assert pipe.n_points == len(d["xyz"]) > 16
        assert len(pipe.done_views) == 2 and pipe.good_views == pipe.done_views
        np.testing.assert_array_equal(pipe.poses, d["poses"])
        np.testing.assert_array_equal(pipe.features.desc.numpy(), d["feat_desc"])
        np.testing.assert_array_equal(pipe.match_idx, d["match_idx"])
    pipe.add_more_views()
    _meets_bars(scene[1], pipe.poses, pipe.pose_valid, pipe.mean_reprojection_error())
    both = pipe.pose_valid & ref.pose_valid
    assert int(both.sum()) >= 4


def test_port_checkpoint_loads_in_tpusfm(tmp_path, scene, port_run):
    pipe = port_run[0]
    ckpt = str(tmp_path / "port_state.npz")
    pipe.save_checkpoint(ckpt)
    imgs, _, K, _ = scene
    ref = JPipeline(imgs, JConfig(**CFG, fused=False),
                    intrinsics=JIntrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2])))
    ref.load_checkpoint(ckpt)
    assert ref.n_points == pipe.n_points
    assert ref.done_views == pipe.done_views and ref.good_views == pipe.good_views
    np.testing.assert_array_equal(ref.poses, pipe.poses)
    np.testing.assert_array_equal(ref.obs[: ref.n_points], pipe.obs[: pipe.n_points])
    np.testing.assert_array_equal(np.asarray(ref.features.desc), pipe.features.desc.numpy())
    # tolerance 1e-4 px: the same float32 state projected by two libraries
    assert abs(ref.mean_reprojection_error() - pipe.mean_reprojection_error()) < 1e-4


def test_carried_state_gives_equal_lookups(scene, ref_run):
    """tpusfm's final host state, carried through convert as numpy arrays,
    gives the port the same 2D-3D lookups (exactly) and the same mean
    reprojection error (to 1e-4 px)."""
    ref = ref_run[0]
    state = dict(xyz=ref.xyz[: ref.n_points], obs=ref.obs[: ref.n_points],
                 feat2point=ref.feat2point, poses=ref.poses, pose_valid=ref.pose_valid,
                 done_views=np.array(sorted(ref.done_views)),
                 good_views=np.array(sorted(ref.good_views)), K=np.asarray(ref.intr.K),
                 feat_xy=ref.feat_xy, feat_valid=ref.feat_valid, match_idx=ref.match_idx,
                 match_valid=ref.match_valid, match_dist=ref.match_dist)
    pipe = convert.pipeline_state_from_numpy(_port_pipe(scene), state)
    assert pipe.features is None            # descriptors were not carried
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "available", lambda: False)
    try:
        for view in range(5):
            (fr, pr), (ft, pt) = ref.find_2d3d_matches(view), pipe.find_2d3d_matches(view)
            np.testing.assert_array_equal(ft, fr)
            np.testing.assert_array_equal(pt, pr)
            assert len(ft) > 6
        for a, b in zip(pipe._match_lookup(), ref._match_lookup()):
            np.testing.assert_array_equal(a, b)
    finally:
        mp.undo()
    assert abs(pipe.mean_reprojection_error() - ref.mean_reprojection_error()) < 1e-4


def test_ba_refine_pp_runs(scene):
    # seed 1, as the runs held to tpusfm's above: with the principal point
    # refined too, tpusfm's own host loop leaves its bars at seed 0 on this
    # scene and meets them at seeds 1-3
    pipe = _port_pipe(scene, seed=1, fused=True, ba_refine_pp=True)
    assert not pipe._fused_applicable()
    pp0 = pipe.intr.K[:2, 2].clone()
    rec = pipe.run()
    _meets_bars(scene[1], rec.poses, rec.pose_valid, rec.mean_reprojection_error)
    moved = float((torch.as_tensor(rec.K[:2, 2]) - pp0).abs().max())
    assert moved > 0.0, "the principal point was not refined"


@pytest.mark.parametrize("kind", [MatcherKind.OPTICAL_FLOW, MatcherKind.DENSE,
                                  MatcherKind.STEREO, MatcherKind.SURF])
def test_other_matchers_name_their_roadmap_item(kind):
    """Every other matcher strategy builds a pipeline that extracts and
    matches (ROADMAP.md queue 1, item 10, is done): one scale of FAST/BRIEF
    for the flow strategies, 64-float blob descriptors for SURF, and a match
    matrix over every pair, each pair's matches one to one."""
    imgs, _, K, _ = make_scene(n_views=3, n_dots=150, h=120, w=160, focal=150.0)
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
    pipe = SfMPipeline(imgs, SfMConfig(max_features=256, max_matches=128, console_debug_level=5,
                                       matcher=kind), intrinsics=intr, device="cpu")
    assert not pipe._fused_applicable()
    pipe.extract()
    assert pipe.features.desc.shape == (3, 256, 64 if kind == MatcherKind.SURF else 256)
    assert pipe.feat_valid.sum(1).min() > 20
    pipe.match()
    assert pipe.match_idx.shape == (3, 128, 2) and pipe.pairs == [(0, 1), (0, 2), (1, 2)]
    assert pipe.match_valid.sum() > 10
    for p in range(3):
        left, right = pipe.match_idx[p][pipe.match_valid[p]].T
        assert len(set(left)) == len(left)
        if kind != MatcherKind.SURF:         # the flow strategies claim a right keypoint once
            assert len(set(right)) == len(right)
