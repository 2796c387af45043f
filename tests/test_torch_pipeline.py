"""The port's fused reconstruction path against tpusfm.

End to end: ``make_scene(n_views=5, n_dots=400)`` goes through both
packages with the configuration of tests/test_pipeline.py. The random
streams differ (threefry vs torch.Generator), so the parity is
statistical: the port must meet the reference's own acceptance bars
(>= 4 of 5 cameras, < 1 px mean reprojection, ATE < 0.2 of the camera
spread) and its camera centres must agree with tpusfm's within an ATE of
5% of the camera spread after similarity alignment (measured: ~0.3%).

Stage tests feed identical intermediate state to both engines through
``tpusfm_torch.convert`` and compare exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic_scene import camera_centers, make_scene, umeyama_alignment
from tpusfm import SfMConfig as JConfig
from tpusfm.pipeline import SfMPipeline as JPipeline
from tpusfm.pipeline.engine import EngineState as JState
from tpusfm.pipeline.engine import FusedEngine as JEngine
from tpusfm.types import Intrinsics as JIntrinsics
from tpusfm_torch import MatcherKind, SfMConfig, convert
from tpusfm_torch.pipeline import SfMPipeline
from tpusfm_torch.pipeline.engine import FusedEngine
from tpusfm_torch.types import Intrinsics

torch.set_num_threads(1)
CFG = dict(max_features=1024, max_matches=512, console_debug_level=5,
           min_point_count_for_homography=60)


def _ate(est, ref):
    s, R, t = umeyama_alignment(est, ref)
    return float(np.sqrt(np.mean(np.sum((ref - (s * (est @ R.T) + t)) ** 2, 1))))


@pytest.fixture(scope="module")
def scene():
    return make_scene(n_views=5, n_dots=400)


@pytest.fixture(scope="module")
def port_rec(scene):
    imgs, _, K, _ = scene
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
    return SfMPipeline(imgs, SfMConfig(**CFG), intrinsics=intr, device="cpu").run()


@pytest.fixture(scope="module")
def ref_rec(scene):
    imgs, _, K, _ = scene
    intr = JIntrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
    return JPipeline(imgs, JConfig(**CFG), intrinsics=intr).run()


def test_port_meets_reference_bars(scene, port_rec):
    _, poses, _, _ = scene
    sel = port_rec.pose_valid
    assert int(sel.sum()) >= 4
    assert port_rec.mean_reprojection_error < 1.0
    gt_c = camera_centers(poses[sel])
    spread = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
    assert _ate(camera_centers(port_rec.poses[sel]), gt_c) < 0.2 * spread
    assert port_rec.num_points > 100
    assert ((port_rec.obs >= 0).sum(1) >= 2).all()
    assert set(port_rec.stats) >= {"features_s", "matching_s", "prune_s", "rank_s",
                                   "solve_s", "fetch_s", "total_s"}


def test_port_agrees_with_tpusfm(port_rec, ref_rec):
    both = port_rec.pose_valid & ref_rec.pose_valid
    assert int(both.sum()) >= 4
    ref_c = camera_centers(ref_rec.poses[both])
    spread = float(np.linalg.norm(ref_c.max(0) - ref_c.min(0)))
    assert _ate(camera_centers(port_rec.poses[both]), ref_c) < 0.05 * spread
    assert abs(port_rec.num_points - ref_rec.num_points) <= 0.2 * ref_rec.num_points
    assert abs(port_rec.mean_reprojection_error - ref_rec.mean_reprojection_error) < 0.25


def test_ply_export_and_unported_paths(tmp_path, scene, port_rec):
    """PLY export, and the optical-flow strategy end to end: it leaves the
    fused path (the rich matcher's only) for the host loop, registers the
    views and exports what it reports."""
    prefix = str(tmp_path / "rec")
    port_rec.save_ply(prefix)
    assert f"element vertex {port_rec.num_points}" in open(prefix + "_points.ply").read()
    imgs, _, K, _ = scene
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
    pipe = SfMPipeline(imgs, SfMConfig(**CFG, matcher=MatcherKind.OPTICAL_FLOW),
                       intrinsics=intr, device="cpu")
    assert not pipe._fused_applicable()
    rec = pipe.run()
    assert int(rec.pose_valid.sum()) >= 4 and rec.mean_reprojection_error < 1.0
    assert "add_views_s" in rec.stats and "solve_s" not in rec.stats
    rec.save_ply(prefix + "_of")
    assert f"element vertex {rec.num_points}" in open(prefix + "_of_points.ply").read()


def test_convert_config_roundtrip():
    ref = JConfig(max_features=768, matcher=JConfig().matcher, cross_check=True)
    d = dataclasses.asdict(ref)
    cfg = convert.config_from_dict(d)
    assert dataclasses.asdict(cfg).keys() == d.keys()
    for k, v in d.items():
        got = getattr(cfg, k)
        assert getattr(got, "value", got) == getattr(v, "value", v), k
    with pytest.raises(KeyError):
        convert.config_from_dict({"no_such_field": 1})


def _stage_inputs(seed=0, V=3, F=256, M=64, CAP=128, n0=20):
    """A small engine state with live points, lookups and new points, in numpy."""
    rng = np.random.default_rng(seed)
    P = V * (V - 1) // 2
    idx = np.stack([np.stack([rng.permutation(F)[:M], rng.permutation(F)[:M]], 1)
                    for _ in range(P)]).astype(np.int32)
    valid = rng.uniform(0, 1, (P, M)) < 0.8
    dist = rng.integers(0, 80, (P, M)).astype(np.float32)
    feat_xy = rng.uniform(0, 300, (V, F, 2)).astype(np.float32)
    xyz = np.zeros((CAP + 1, 3), np.float32)
    xyz[:n0] = rng.uniform(-2, 2, (n0, 3)) + np.array([0, 0, 8])
    obs = np.full((CAP + 1, V), -1, np.int32)
    f2p = np.full((V, F + 1), -1, np.int32)
    for n in range(n0):                       # tracks in views 0 and 1 from pair (0, 1)
        a, b = idx[0, n]
        obs[n, 0], obs[n, 1] = a, b
        f2p[0, a], f2p[1, b] = n, n
    poses = np.zeros((V, 3, 4), np.float32)
    poses[:, :, :3] = np.eye(3)
    poses[1, 0, 3] = 0.5
    state = dict(xyz=xyz, obs=obs, feat2point=f2p, n_points=np.int32(n0), poses=poses,
                 pose_valid=np.array([True, True, False]), done=np.array([True, True, False]),
                 good=np.array([True, True, False]), focal=np.float32(300.0),
                 stats=np.zeros((V + 1, 10), np.float32))
    p = 1                                     # pair (0, 2)
    xyz_new = (rng.uniform(-2, 2, (M, 3)) + np.array([0, 0, 8])).astype(np.float32)
    xyz_new[:10] = xyz[:10] + 1e-3            # close to live points
    keep = rng.uniform(0, 1, M) < 0.7
    return dict(idx=idx, valid=valid, dist=dist, feat_xy=feat_xy, state=state, p=p,
                xyz_new=xyz_new, keep=keep, V=V, F=F, M=M, CAP=CAP)


def test_engine_lookup_and_merge_match_reference():
    s = _stage_inputs()
    jcfg = JConfig(max_features=s["F"], max_matches=s["M"], engine_point_capacity=s["CAP"])
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jeng = JEngine(jcfg, s["V"], 240, 320, 300.0, 160.0, 120.0)
    teng = FusedEngine(cfg, s["V"], 240, 320, 300.0, 160.0, 120.0, device="cpu")
    m = convert.matches_from_numpy(s["idx"], s["dist"], s["valid"])
    lk_j = jeng._jit_lookup(jnp.asarray(s["idx"]), jnp.asarray(s["valid"]),
                            jnp.asarray(s["dist"]))
    lk_t = teng.build_lookup(m.idx.long(), m.valid, m.dist)
    for a, b in zip(lk_t, lk_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    st_t = convert.engine_state_from_numpy(s["state"])
    st_j = JState(**{k: jnp.asarray(v) for k, v in s["state"].items()})
    p = s["p"]
    fi, fj = s["idx"][p, :, 0], s["idx"][p, :, 1]
    out_j = jax.jit(jeng._merge_points)(
        st_j, jnp.asarray(s["xyz_new"]), jnp.asarray(s["keep"]), jnp.int32(0), jnp.int32(2),
        jnp.asarray(fi), jnp.asarray(fj), *lk_j, jnp.asarray(s["feat_xy"]))
    out_t = teng._merge_points(st_t, torch.as_tensor(s["xyz_new"]), torch.as_tensor(s["keep"]),
                               torch.tensor(0), torch.tensor(2), torch.as_tensor(fi).long(),
                               torch.as_tensor(fj).long(), *lk_t,
                               torch.as_tensor(s["feat_xy"]))
    st2_j, st2_t = out_j[0], out_t[0]
    n = int(st2_j.n_points)
    assert int(st2_t.n_points) == n and n > s["state"]["n_points"]
    assert [int(x) for x in out_t[1:]] == [int(x) for x in out_j[1:]]
    np.testing.assert_array_equal(st2_t.xyz[:n].numpy(), np.asarray(st2_j.xyz)[:n])
    np.testing.assert_array_equal(st2_t.obs[:n].numpy(), np.asarray(st2_j.obs)[:n])
    f = s["F"]
    np.testing.assert_array_equal(st2_t.feat2point[:, :f].numpy(),
                                  np.asarray(st2_j.feat2point)[:, :f])

    # adaptive gate, batched over views, equals the reference per view
    rng = np.random.default_rng(1)
    e1, e2 = rng.gamma(2.0, 1.5, (2, 3, s["M"])).astype(np.float32)
    keep = rng.uniform(0, 1, (3, s["M"])) < 0.6
    got = teng._adaptive_gate(torch.as_tensor(e1), torch.as_tensor(e2), torch.as_tensor(keep))
    for v in range(3):
        np.testing.assert_array_equal(got[v].numpy(), np.asarray(jeng._adaptive_gate(
            jnp.asarray(e1[v]), jnp.asarray(e2[v]), jnp.asarray(keep[v]))))


def test_left_of_duplicates_pick_lowest_left_index():
    cfg = SfMConfig(max_features=8, max_matches=4)
    eng = FusedEngine(cfg, 2, 10, 10, 10.0, 5.0, 5.0, device="cpu")
    idx = torch.tensor([[[5, 3], [1, 3], [2, 6], [0, 0]]])
    valid = torch.tensor([[True, True, True, False]])
    _, _, left_of = eng.build_lookup(idx, valid, torch.zeros(1, 4))
    assert left_of[0, 3] == 1 and left_of[0, 6] == 2 and left_of[0, 0] == -1
