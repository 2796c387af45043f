"""The port's collection-scale pipeline against tpusfm/pipeline/collection.py.

Everything runs on the CPU; the JAX side runs as its own tests run it
(``mesh=None``, so the plain matcher). Integer stages (``window_pairs``,
``build_tracks``) must be equal array for array. The batched N-view
triangulation is held to the reference's on the same inputs (X to 1e-3 units
at depths of 8-14 units, ``keep`` equal). The RANSAC stages draw from
different random streams in the two packages, so whole runs are compared by
the reference's own gates and by the distance between the two packages'
camera centres after similarity alignment (2% of the scene scale).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.collection_fixture import make_collection
from tpusfm import SfMConfig as JConfig
from tpusfm.pipeline import CollectionPipeline as JPipeline
from tpusfm.pipeline import window_pairs as j_window_pairs
from tpusfm.types import Intrinsics as JIntrinsics
from tpusfm_torch import SfMConfig
from tpusfm_torch.convert import collection_state_from_numpy
from tpusfm_torch.eval import ate_rmse
from tpusfm_torch.pipeline import CollectionPipeline, CollectionReconstruction, window_pairs
from tpusfm_torch.types import Intrinsics

torch.set_num_threads(1)

_INJECTED_CFG = dict(max_features=512, max_matches=512, console_debug_level=5,
                     collection_window=4, ba_share_focal=False, ba_incremental_iterations=10,
                     min_point_count_for_homography=60)


@pytest.mark.parametrize("V,window,wrap", [(6, 2, False), (6, 2, True), (16, 4, False),
                                           (120, 6, True), (5, 8, True), (2, 1, False)])
def test_window_pairs_equal(V, window, wrap):
    got, want = window_pairs(V, window, wrap), j_window_pairs(V, window, wrap)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if (V, window, wrap) == (120, 6, True):
        assert len(got) == 720


@functools.lru_cache(maxsize=None)
def _injected():
    """tests/test_collection.py's injected-observation fixture: exact
    projections (+0.3 px noise) as features, co-visibility as matches."""
    V, ND, F, M = 16, 400, 512, 512
    imgs, poses_gt, K, dots = make_collection(n_views=V, n_dots=ND, arc_degrees=60.0)
    rng = np.random.default_rng(0)
    h, w = imgs.shape[1:]
    feat_xy = np.zeros((V, F, 2), np.float32)
    feat_valid = np.zeros((V, F), bool)
    vis = np.zeros((V, ND), bool)
    for v in range(V):
        pc = dots @ poses_gt[v][:, :3].T + poses_gt[v][:, 3]
        uv = pc[:, :2] / pc[:, 2:] * K[0, 0] + K[:2, 2]
        ok = ((pc[:, 2] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < w)
              & (uv[:, 1] >= 0) & (uv[:, 1] < h))
        vis[v] = ok
        feat_xy[v, :ND] = uv + rng.normal(0, 0.3, (ND, 2))
        feat_valid[v, :ND] = ok
    pairs = j_window_pairs(V, 4)
    match_idx = np.full((len(pairs), M, 2), -1, np.int32)
    match_valid = np.zeros((len(pairs), M), bool)
    for p, (i, j) in enumerate(pairs):
        both = np.nonzero(vis[i] & vis[j])[0][:M]
        match_idx[p, : len(both), 0] = both
        match_idx[p, : len(both), 1] = both
        match_valid[p, : len(both)] = True
    state = dict(feat_xy=feat_xy, feat_valid=feat_valid, match_idx=match_idx,
                 match_valid=match_valid)
    return imgs, poses_gt, K, vis, state


def _pipes(state_keys=("feat_xy", "feat_valid", "match_idx", "match_valid")):
    imgs, poses_gt, K, vis, state = _injected()
    f, cx, cy = float(K[0, 0]), float(K[0, 2]), float(K[1, 2])
    jpipe = JPipeline(imgs, JConfig(**_INJECTED_CFG), intrinsics=JIntrinsics.create(f, cx, cy))
    for k in state_keys:
        setattr(jpipe, k, state[k].copy())
    jpipe.features = object()          # the reference's sentinel: skip extract()
    tpipe = CollectionPipeline(imgs, SfMConfig(**_INJECTED_CFG),
                               intrinsics=Intrinsics.create(f, cx, cy), device="cpu")
    collection_state_from_numpy(tpipe, {k: state[k] for k in state_keys})
    return jpipe, tpipe


_TRACK_ARRAYS = ("obs_track", "obs_view", "obs_feat", "obs_uv", "obs_alive", "node2track",
                 "track_xyz", "track_ok")


def test_build_tracks_identical():
    """Integer work on the same matches: identical arrays, dtypes included.
    A wrong match (two features of one view in one track) exercises the cut."""
    jpipe, tpipe = _pipes()
    for pipe in (jpipe, tpipe):
        pipe.match_idx[0, 0, 1] = pipe.match_idx[0, 1, 1]      # chain two points into one track
        pipe.build_tracks()
    assert tpipe.T == jpipe.T > 0
    for name in _TRACK_ARRAYS:
        got, want = getattr(tpipe, name), getattr(jpipe, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert not tpipe.obs_alive.all() and tpipe.obs_alive.sum() > 1000
    # the whole state crosses over at this stage boundary too
    _, other = _pipes()
    collection_state_from_numpy(other, {k: getattr(jpipe, k) for k in
                                        _TRACK_ARRAYS + ("poses", "pose_valid", "reg_order")})
    assert other.T == jpipe.T and other.reg_order == [] and other._extracted
    assert np.array_equal(other.node2track, jpipe.node2track)


def test_multiview_triangulation_matches_reference():
    """tri_multi against CollectionPipeline._jit_tri_multi on the inputs of
    tests/test_collection.py::test_multiview_triangulation_kernel."""
    rng = np.random.default_rng(0)
    f, cx, cy = 300.0, 64.0, 48.0
    Km = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32)
    blank = np.zeros((2, 8, 8), np.float32)
    jpipe = JPipeline(blank, JConfig(min_triangulation_angle_deg=1.5, console_debug_level=5),
                      intrinsics=JIntrinsics.create(f, cx, cy))
    tpipe = CollectionPipeline(blank, SfMConfig(min_triangulation_angle_deg=1.5,
                                                console_debug_level=5),
                               intrinsics=Intrinsics.create(f, cx, cy), device="cpu")
    KT = tpipe._tri_k
    assert KT == jpipe._tri_k

    pts = np.stack([rng.uniform(-2, 2, 64), rng.uniform(-2, 2, 64),
                    rng.uniform(8, 14, 64)], 1).astype(np.float32)
    poses = []
    for k in range(KT):
        th = 0.06 * k
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        t = np.array([-0.8 * k, 0.0, 0.05 * k], np.float32)
        poses.append(np.concatenate([R, t[:, None]], 1))
    poses = np.stack(poses)                              # (K, 3, 4)
    B = 64
    Rt = np.broadcast_to(poses, (B, KT, 3, 4)).copy()
    uv = np.zeros((B, KT, 2), np.float32)
    for k in range(KT):
        pc = pts @ poses[k][:, :3].T + poses[k][:, 3]
        uv[:, k] = pc[:, :2] / pc[:, 2:] * f + [cx, cy]
    msk = np.ones((B, KT), np.float32)
    msk[:, KT // 2:] *= (rng.uniform(size=(B, KT - KT // 2)) < 0.7)
    msk[0, 2:] = 0.0                                     # 2-view row
    uv_noisy = uv + rng.normal(0, 0.5, uv.shape).astype(np.float32)

    def both(Rt_, uv_, msk_):
        jX, jkeep = jpipe._jit_tri_multi(jnp.asarray(Rt_), jnp.asarray(uv_), jnp.asarray(msk_),
                                         jnp.asarray(Km), jnp.asarray(np.linalg.inv(Km)))
        tX, tkeep = tpipe._tri_multi(torch.as_tensor(Rt_), torch.as_tensor(uv_),
                                     torch.as_tensor(msk_), torch.as_tensor(Km),
                                     torch.as_tensor(np.linalg.inv(Km)))
        assert tX.dtype == torch.float32 and tkeep.dtype == torch.bool
        return np.asarray(jX), np.asarray(jkeep), tX.numpy(), tkeep.numpy()

    jX, jkeep, tX, tkeep = both(Rt, uv, msk)
    assert np.array_equal(tkeep, jkeep) and tkeep.mean() > 0.9
    assert np.abs(tX[tkeep] - pts[tkeep]).max() < 1e-2       # the reference's own bar
    assert np.abs(tX[tkeep] - jX[tkeep]).max() < 1e-3
    # noisy observations: the Gauss-Newton refinement, not only the DLT
    jX, jkeep, tX, tkeep = both(Rt, uv_noisy, msk)
    assert np.array_equal(tkeep, jkeep) and tkeep.mean() > 0.9
    assert np.abs(tX[tkeep] - jX[tkeep]).max() < 1e-3
    # corrupt one observation far beyond the gate -> rejected
    uv_bad = uv.copy()
    uv_bad[:, 1] += 35.0
    _, jkeep, _, tkeep = both(Rt, uv_bad, msk)
    assert not tkeep.any() and not jkeep.any()
    # zero-baseline cameras -> the parallax gate rejects
    Rt0 = np.broadcast_to(poses[0], (B, KT, 3, 4)).copy()
    uv0 = np.broadcast_to(uv[:, 0:1], (B, KT, 2)).copy()
    _, jkeep, _, tkeep = both(Rt0, uv0, np.ones((B, KT), np.float32))
    assert not tkeep.any() and not jkeep.any()


def test_collection_run_on_injected_observations():
    """The injected-observation run of tests/test_collection.py through both
    packages: the track graph + registration + BA stack recovers the orbit
    to the noise floor, and the two packages' camera centres agree."""
    imgs, poses_gt, K, vis, _ = _injected()
    jpipe, tpipe = _pipes()
    V = len(imgs)
    rec = tpipe.run()
    jrec = jpipe.run()
    assert isinstance(rec, CollectionReconstruction)
    for r in (rec, jrec):
        assert int(r.pose_valid.sum()) == V
        assert r.mean_reprojection_error < 0.6      # ~ injected noise
        assert ate_rmse(r.poses, poses_gt) < 0.1    # scene scale is 16
        # the track graph must have fused windowed matches into long tracks
        assert r.num_points < vis.any(0).sum() * 1.2
        assert np.bincount(r.obs_point).max() >= 6
    assert ate_rmse(rec.poses, jrec.poses) < 0.02 * 16.0
    assert rec.stats["ba_iters"] > 0 and rec.stats["ba_iters"] == (
        rec.stats["ba_iters_local"] + rec.stats["ba_iters_global"])
    assert set(jrec.stats) <= set(rec.stats) | {"features_s", "matching_s", "prune_s"}
    assert rec.xyz.shape == (rec.num_points, 3) and np.isfinite(rec.xyz).all()
    assert len(rec.obs_point) == len(rec.obs_view) == len(rec.obs_feat)
    assert rec.obs_point.max() == rec.num_points - 1
    # vertex colours: image intensity at each point's first observation, as
    # the reference's loop over observations picks it
    first = {}
    for k, t in enumerate(rec.obs_point):
        first.setdefault(int(t), k)
    for t in list(first)[:50]:
        v, fidx = rec.obs_view[first[t]], rec.obs_feat[first[t]]
        u, vv = tpipe.feat_xy[v, fidx]
        g = int(imgs[v, int(np.clip(round(vv), 0, imgs.shape[1] - 1)),
                     int(np.clip(round(u), 0, imgs.shape[2] - 1))] * 255)
        assert tuple(rec.rgb[t]) == (g, g, g)


def test_collection_end_to_end_from_images(tmp_path):
    """Full path from rendered images on one CPU device (``mesh=None``, the
    plain matcher), real detector in the loop, with the gates of
    tests/test_collection.py::test_collection_end_to_end_sharded."""
    V = 12
    imgs, poses_gt, K, dots = make_collection(n_views=V, n_dots=350, arc_degrees=45.0, seed=3)
    cfg = SfMConfig(max_features=768, max_matches=384, console_debug_level=5,
                    collection_window=4, ba_share_focal=False, ba_incremental_iterations=10,
                    ba_max_iterations=50, min_point_count_for_homography=60)
    pipe = CollectionPipeline(imgs, cfg, intrinsics=Intrinsics.create(
        float(K[0, 0]), float(K[0, 2]), float(K[1, 2])), mesh=None, device="cpu")
    assert pipe.features is None and not pipe._extracted
    pipe.extract()
    assert pipe._extracted and pipe.features.desc.shape == (V, 768, 256)
    pipe.match()
    # the descriptors are freed once matched; run() must not extract again
    assert pipe.features is None and pipe._extracted
    assert pipe.match_idx.shape == (len(pipe.pairs), 384, 2)
    rec = pipe.run()
    assert int(rec.pose_valid.sum()) >= V - 2
    assert rec.mean_reprojection_error < 1.5
    assert rec.num_points > 150
    assert rec.stats["ba_iters"] > 0
    for key in ("features_s", "matching_s", "prune_s", "tracks_s", "baseline_s", "solve_s",
                "total_s"):
        assert rec.stats[key] >= 0.0
    rec.save_ply(str(tmp_path / "rec"))
    with open(tmp_path / "rec_points.ply") as fh:
        assert f"element vertex {rec.num_points}\n" in fh.read(2000)
    with open(tmp_path / "rec_cameras.ply") as fh:
        assert f"element vertex {5 * int(rec.pose_valid.sum())}\n" in fh.read(2000)


def test_make_collection_equals_reference():
    """The port's numpy dot collection: tpusfm's poses, K and dots exactly,
    its images to float32 round-off (XLA's and numpy's exp and products)."""
    from tpusfm_torch.tools.synthetic import make_collection as t_make_collection

    want = make_collection(n_views=6, n_dots=200, arc_degrees=45.0, seed=3)
    got = t_make_collection(n_views=6, n_dots=200, arc_degrees=45.0, seed=3)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.float32 and got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    assert (want[0] > 0.1).mean() > 0.01


def test_mesh_of_one_rank():
    """CollectionPipeline(mesh=) with a mesh of one gloo rank: the sharded
    matcher gives the unsharded pipeline's matches, and the injected-
    observation run through the sharded global BA (its whole budget in one
    call) meets the gates of test_collection_run_on_injected_observations."""
    import torch.distributed as dist

    from tpusfm_torch.dist import make_mesh

    imgs, poses_gt, K, vis, state = _injected()
    f, cx, cy = float(K[0, 0]), float(K[0, 2]), float(K[1, 2])
    mesh = make_mesh(device="cpu")
    try:
        cfg = SfMConfig(**_INJECTED_CFG)
        piped = [CollectionPipeline(imgs[:4], cfg, intrinsics=Intrinsics.create(f, cx, cy),
                                    mesh=m, device="cpu") for m in (mesh, None)]
        for pipe in piped:
            pipe.extract()
            pipe.match()
        assert piped[0].mesh is mesh and piped[0]._chunk == cfg.collection_match_chunk
        assert piped[0].match_valid.sum() > 0
        np.testing.assert_array_equal(piped[0].match_idx, piped[1].match_idx)
        np.testing.assert_array_equal(piped[0].match_valid, piped[1].match_valid)

        pipe = CollectionPipeline(imgs, cfg, intrinsics=Intrinsics.create(f, cx, cy), mesh=mesh)
        assert pipe.device == mesh.device
        collection_state_from_numpy(pipe, state)
        rec = pipe.run()
    finally:
        dist.destroy_process_group()
    assert int(rec.pose_valid.sum()) == len(imgs)
    assert rec.mean_reprojection_error < 0.6
    assert ate_rmse(rec.poses, poses_gt) < 0.1
    assert rec.stats["ba_iters_global"] > 0


def test_matcher_dispatch_on_cpu():
    """On the CPU the pipeline takes the dense matcher; the streaming kernel
    is chosen only for a CUDA device, no cross-check and a feature budget
    that is a multiple of 256."""
    blank = np.zeros((2, 8, 8), np.float32)
    for kw in (dict(max_features=1024), dict(max_features=1000),
               dict(max_features=1024, cross_check=True)):
        pipe = CollectionPipeline(blank, SfMConfig(console_debug_level=5, **kw), device="cpu")
        assert not pipe._streaming
    assert pipe._ba_chunk == 5 and pipe._interval_cg == 48 and pipe._final_cg == 64


# --- known poses: CollectionPipeline.run(known_poses=) on a whole tiny ring
# (portbench's ring250 configuration at its tiny sizes: 32 views over the full
# circle, window 8 with the seam pairs), the priors the true poses perturbed by
# 0.002 per axis, judged by the plain float64 reference of portbench ---
PRIOR_V = 32
PRIOR_CFG = dict(max_features=512, max_matches=256, collection_window=8,
                 collection_wraparound=True, ba_max_iterations=20, ba_share_focal=False,
                 console_debug_level=5)
HUBER_PX = 3.0          # SfMConfig().collection_huber_px: the loss the final BA minimises
GAP_LIMIT = 0.01        # portbench's point_gap and camera_gap limits


@functools.lru_cache(maxsize=None)
def _prior_ring():
    from portbench import render
    from portbench.run import load_module

    imgs, poses_gt, K = render.ring_sector(PRIOR_V, 0, PRIOR_V, 192, 256, 300.0, 2026, "cpu")
    priors = load_module("jobs", "priors").perturb(poses_gt, 7, 0.002)
    return imgs, poses_gt, K, priors


def _prior_pipe(**state):
    imgs, _, K, _ = _prior_ring()
    pipe = CollectionPipeline(imgs, SfMConfig(**PRIOR_CFG), seed=3, device="cpu",
                              intrinsics=Intrinsics.create(float(K[0, 0]), float(K[0, 2]),
                                                           float(K[1, 2])))
    if state:
        collection_state_from_numpy(pipe, state)
    return pipe


def _judge(pipe, rec):
    """The reference's numbers of a reconstruction: mean px, point and camera
    gaps at the final BA's Huber scale, ATE and the true cameras' spread."""
    from portbench.reference import geometry

    _, poses_gt, _, _ = _prior_ring()
    uv = pipe.feat_xy[rec.obs_view, rec.obs_feat]
    args = (rec.poses, rec.K, rec.xyz, rec.obs_point, rec.obs_view, uv)
    px = geometry.reprojection(*args).mean()
    ate, spread = geometry.ate(rec.poses, poses_gt)
    return {"px": px, "point_gap": geometry.point_gap(*args, huber=HUBER_PX),
            "camera_gap": geometry.camera_gap(*args, huber=HUBER_PX), "ate": ate,
            "spread": spread}


@pytest.fixture(scope="module")
def priors_run():
    """One known-pose run under the profiler: (pipeline, reconstruction,
    {span: [(start, end), ...]})."""
    from torch.profiler import ProfilerActivity, profile

    _, _, _, priors = _prior_ring()
    pipe = _prior_pipe()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = pipe.run(known_poses=priors)
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("sfm."):
            spans.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return pipe, rec, {k: sorted(v) for k, v in spans.items()}


def test_known_poses_reconstruct_the_ring_to_the_reference(priors_run):
    pipe, rec, _ = priors_run
    st = rec.stats
    assert rec.pose_valid.all() and pipe.reg_order == list(range(PRIOR_V))
    assert st["views_tried"] == st["views_registered"] == st["global_rounds"] == 0
    assert st["ba_iters"] == st["ba_iters_global"] > 0 and "ba_iters_local" not in st
    assert 0 < st["tracks_triangulated"] <= pipe.T and rec.num_points > 300
    jd = _judge(pipe, rec)
    assert jd["point_gap"] <= GAP_LIMIT and jd["camera_gap"] <= GAP_LIMIT, jd
    assert abs(rec.mean_reprojection_error - jd["px"]) <= 1e-4 and jd["px"] < 1.0
    assert jd["ate"] < 0.05 * jd["spread"], jd


def test_known_poses_without_the_polish_miss_the_camera_gap(priors_run, monkeypatch):
    """The mutant: the final polish a no-op. The cameras stay at the perturbed
    priors, and refining each alone removes most of the cost."""
    pipe, _, _ = priors_run
    monkeypatch.setattr(CollectionPipeline, "_polish", lambda self: None)
    mutant = _prior_pipe(**{k: getattr(pipe, k) for k in ("feat_xy", "feat_valid", "match_idx",
                                                          "match_valid")})
    rec = mutant.run(known_poses=_prior_ring()[3])
    assert rec.stats["ba_iters"] == 0 and rec.pose_valid.all()
    assert _judge(mutant, rec)["camera_gap"] > GAP_LIMIT


def test_known_pose_spans_and_prune_chunks(priors_run):
    """One ``sfm.run`` holding one ``sfm.collection.priors`` (no registration
    span), ceil(P / 128) ``sfm.prune.chunk`` spans inside ``sfm.prune``, as
    many as the stats' ``prune_chunks``."""
    pipe, rec, spans = priors_run
    (run,) = spans["sfm.run"]
    (priors,) = spans["sfm.collection.priors"]
    (prune,) = spans["sfm.prune"]
    assert "sfm.collection.solve" not in spans and "sfm.collection.view" not in spans
    chunks = spans["sfm.prune.chunk"]
    assert len(chunks) == -(-len(pipe.pairs) // 128) == rec.stats["prune_chunks"] == 2
    assert all(prune[0] <= s and e <= prune[1] for s, e in chunks)
    assert run[0] <= prune[0] and prune[1] <= priors[0] and priors[1] <= run[1]
    held = [iv for k in ("sfm.collection.triangulate", "sfm.collection.global_ba",
                         "sfm.sparse.lm_iter") for iv in spans[k]]
    assert len(spans["sfm.collection.global_ba"]) == 2
    assert all(priors[0] <= s and e <= priors[1] for s, e in held)


@pytest.mark.parametrize("bad", ["views", "shape", "nan", "text"])
def test_known_poses_of_a_wrong_shape_or_value_raise(bad):
    pipe = CollectionPipeline(np.zeros((3, 8, 8), np.float32), SfMConfig(console_debug_level=5),
                              device="cpu")
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (3, 1, 1))
    poses = {"views": poses[:2], "shape": np.zeros((3, 4, 4)), "text": poses.astype(str),
             "nan": np.where(np.arange(12).reshape(3, 4) == 5, np.nan, poses)}[bad]
    with pytest.raises(ValueError):
        pipe.run(known_poses=poses)
    assert not pipe._extracted          # refused before any work


# the stats of run() on the injected observations, as before known poses
_INJECTED_STATS = {"ba_iters", "ba_iters_global", "ba_iters_local", "baseline_s", "global_ba_s",
                   "global_rounds", "local_ba_s", "pnp_graph_captures", "pnp_graph_replays",
                   "pnp_s", "solve_s", "total_s", "tracks_s", "views_registered", "views_tried"}


def test_run_without_priors_keeps_its_stats_and_outcome(monkeypatch):
    """``run()`` is the incremental solve as before: the same stats keys, the
    polish once at its end, nothing of the known-pose path, and the outcome
    of ``test_collection_run_on_injected_observations``."""
    imgs, poses_gt, K, vis, _ = _injected()
    calls = []
    for name in ("_polish", "_from_priors"):
        plain = getattr(CollectionPipeline, name)
        monkeypatch.setattr(CollectionPipeline, name,
                            lambda self, *a, _n=name, _f=plain: calls.append(_n) or _f(self, *a))
    _, tpipe = _pipes()
    rec = tpipe.run(known_poses=None)
    assert calls == ["_polish"]
    assert set(rec.stats) == _INJECTED_STATS
    assert int(rec.pose_valid.sum()) == len(imgs) and rec.mean_reprojection_error < 0.6
    assert ate_rmse(rec.poses, poses_gt) < 0.1
