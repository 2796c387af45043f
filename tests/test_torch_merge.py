"""The port's host-side track graph against tpusfm's numpy path.

``_insert_points`` (full mergeNewPointCloud semantics, SfM.cpp:530-629),
``_match_lookup``, ``find_2d3d_matches`` and ``_adaptive_filter`` are
host numpy code in both packages. The semantic cases of tests/test_merge.py
run on the port, and on identical inputs the port's ``xyz``, ``obs``,
``feat2point`` and ``n_points`` must equal tpusfm's EXACTLY (tolerance 0;
``_adaptive_filter``'s masks likewise, its thresholds being the same
float64 arithmetic). The reference is pinned to its numpy path (its
native C++ runtime, when built, would otherwise take over).
"""
import dataclasses

import numpy as np
import pytest
import torch

import tpusfm.native as jnative
from tpusfm import SfMConfig as JConfig
from tpusfm.pipeline import SfMPipeline as JPipeline
from tpusfm_torch import SfMConfig, convert
from tpusfm_torch.pipeline import SfMPipeline

torch.set_num_threads(1)
V, F, M = 3, 32, 8


@pytest.fixture(autouse=True)
def reference_on_numpy_path(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


def _set_matches(pipe, idx, valid, dist):
    n_views = pipe.V
    pipe.pairs = [(i, j) for i in range(n_views) for j in range(i + 1, n_views)]
    pipe.pair_of = {p: n for n, p in enumerate(pipe.pairs)}
    pipe.match_idx, pipe.match_valid, pipe.match_dist = idx.copy(), valid.copy(), dist.copy()
    pipe._lookup = None


def make_pipe(strengthen=True):
    cfg = SfMConfig(max_features=F, max_matches=M, console_debug_level=5,
                    cross_view_strengthen=strengthen)
    pipe = SfMPipeline(np.zeros((V, 32, 32), np.float32), cfg, device="cpu")
    P = V * (V - 1) // 2
    idx = np.full((P, M, 2), -1, np.int32)
    valid = np.zeros((P, M), bool)
    dist = np.full((P, M), 1e9, np.float32)
    pair_of = {(0, 1): 0, (0, 2): 1, (1, 2): 2}

    def add_match(i, j, fi, fj, d):
        p = pair_of[(i, j)]
        slot = int(valid[p].sum())
        idx[p, slot], valid[p, slot], dist[p, slot] = (fi, fj), True, d

    # pair (0,1): 2<->3 close match; 8<->16 (for the transitive test)
    add_match(0, 1, 2, 3, 5.0)
    add_match(0, 1, 8, 16, 4.0)
    # pair (0,2): 2<->6 close match (confirms the coincident-point fusion)
    add_match(0, 2, 2, 6, 5.0)
    _set_matches(pipe, idx, valid, dist)
    return pipe


@pytest.mark.parametrize("strengthen", [True, False])
def test_merge_semantics(strengthen):
    pipe = make_pipe(strengthen)
    one = lambda *x: np.array([x], np.float32)
    # 1. seed point A from pair (0,1), features (2, 3)
    pipe._insert_points(one(1.0, 1.0, 1.0), 0, np.array([2]), 1, np.array([3]))
    assert pipe.n_points == 1
    assert pipe.obs[0, 0] == 2 and pipe.obs[0, 1] == 3
    # 2. coincident point from pair (1,2), features (9, 6): within 0.01 of A
    #    and CONFIRMED by match (0,2): 2<->6 dist 5 -> fuse
    pipe._insert_points(one(1.0, 1.0, 1.005), 1, np.array([9]), 2, np.array([6]))
    assert pipe.n_points == 1, "coincident confirmed point must fuse"
    assert pipe.obs[0, 2] == 6 and pipe.feat2point[2, 6] == 0
    # 3. close but UNCONFIRMED point from (1,2), features (10, 11): dropped
    pipe._insert_points(one(1.0, 1.0, 1.002), 1, np.array([10]), 2, np.array([11]))
    assert pipe.n_points == 1, "close unconfirmed point must be dropped"
    # 4. far point appends
    pipe._insert_points(one(5.0, 5.0, 5.0), 1, np.array([12]), 2, np.array([13]))
    assert pipe.n_points == 2
    # 5. exact-feature claim: feature 2 of view 0 already belongs to A
    pipe._insert_points(one(9.0, 9.0, 9.0), 0, np.array([2]), 1, np.array([14]))
    assert pipe.n_points == 2
    assert pipe.obs[0, 1] == 14          # view-1 obs updated to 14
    # 6. transitive claim (strengthening): feature 16 of view 1 matches
    #    feature 8 of view 0, which we hand to A -> attach; without
    #    strengthening the point is far from everything and appends
    pipe.feat2point[0, 8] = 0
    pipe._insert_points(one(9.0, 9.0, 9.0), 1, np.array([16]), 2, np.array([17]))
    if strengthen:
        assert pipe.n_points == 2, "transitive claim must attach, not append"
        assert pipe.obs[0, 2] == 17
    else:
        assert pipe.n_points == 3 and pipe.obs[2, 2] == 17


def _random_matches(rng, n_views, n_feat, n_match):
    """Match arrays with repeated right (and a few repeated left) features,
    so the lookup scatters have duplicates to resolve."""
    P = n_views * (n_views - 1) // 2
    left = np.stack([rng.permutation(n_feat)[:n_match] for _ in range(P)])
    left[:, 1] = left[:, 0]                                  # a duplicated left feature
    right = rng.integers(0, n_feat, (P, n_match))
    idx = np.stack([left, right], -1).astype(np.int32)
    valid = rng.uniform(0, 1, (P, n_match)) < 0.8
    idx[~valid] = -1
    dist = rng.integers(0, 60, (P, n_match)).astype(np.float32)
    return idx, valid, dist


def _pair(n_views=4, n_feat=64, n_match=24, seed=0, **kw):
    """A reference pipeline and a port pipeline holding identical state."""
    jcfg = JConfig(max_features=n_feat, max_matches=n_match, console_debug_level=5,
                   point_capacity=16, **kw)       # small capacity: the map must grow
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    imgs = np.zeros((n_views, 32, 32), np.float32)
    jp, tp = JPipeline(imgs, jcfg), SfMPipeline(imgs, cfg, device="cpu")
    rng = np.random.default_rng(seed)
    idx, valid, dist = _random_matches(rng, n_views, n_feat, n_match)
    feat_xy = rng.uniform(0, 32, (n_views, n_feat, 2)).astype(np.float32)
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (n_views, 1, 1))
    poses[:, 0, 3] = 0.3 * np.arange(n_views)
    for p in (jp, tp):
        _set_matches(p, idx, valid, dist)
        p.feat_xy = feat_xy.copy()
        p.poses = poses.copy()
        p.pose_valid[:] = True
    return jp, tp, rng


def _same_graph(jp, tp):
    assert tp.n_points == jp.n_points
    n = jp.n_points
    np.testing.assert_array_equal(tp.xyz[:n], jp.xyz[:n])
    np.testing.assert_array_equal(tp.obs[:n], jp.obs[:n])
    np.testing.assert_array_equal(tp.feat2point, jp.feat2point)


@pytest.mark.parametrize("strengthen,with_xy", [(True, True), (True, False), (False, True)])
def test_insert_points_equals_reference(strengthen, with_xy):
    jp, tp, rng = _pair(cross_view_strengthen=strengthen)
    if not with_xy:                      # hops accepted on descriptor distance alone
        jp.feat_xy = tp.feat_xy = None
    offered = 0
    for _ in range(14):
        k = int(rng.integers(3, 20))
        i, j = (int(v) for v in sorted(rng.choice(jp.V, 2, replace=False)))
        p = jp.pair_of[(i, j)]
        # mostly features that the pair's matches name, so claims and hops hit
        fi = np.where(rng.uniform(0, 1, k) < 0.7, jp.match_idx[p, rng.integers(0, 24, k), 0],
                      rng.integers(0, 64, k)).clip(0).astype(np.int32)
        fj = np.where(rng.uniform(0, 1, k) < 0.7, jp.match_idx[p, rng.integers(0, 24, k), 1],
                      rng.integers(0, 64, k)).clip(0).astype(np.int32)
        xyz = (rng.uniform(-1, 1, (k, 3)) + np.array([0, 0, 6])).astype(np.float32)
        if jp.n_points:                  # some land within the merge distance of the map
            near = rng.integers(0, jp.n_points, k)
            close = rng.uniform(0, 1, k) < 0.5
            xyz[close] = jp.xyz[near[close]] + np.float32(1e-3)
        for p_ in (jp, tp):
            p_._insert_points(xyz.copy(), i, fi.copy(), j, fj.copy())
        _same_graph(jp, tp)
        offered += k
    assert jp.n_points > 16, "the map never outgrew its first capacity"
    assert jp.n_points < offered, "nothing merged or dropped"


def test_match_lookup_equals_reference():
    jp, tp, _ = _pair(seed=3)
    for a, b in zip(tp._match_lookup(), jp._match_lookup()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # checkpoints without match distances: every surviving match confirms
    jp.match_dist = tp.match_dist = None
    jp._lookup = tp._lookup = None
    np.testing.assert_array_equal(tp._match_lookup()[2], jp._match_lookup()[2])


def test_find_2d3d_matches_equals_reference():
    jp, tp, rng = _pair(seed=5)
    f2p = np.where(rng.uniform(0, 1, jp.feat2point.shape) < 0.5,
                   rng.integers(0, 40, jp.feat2point.shape), -1).astype(np.int32)
    for p in (jp, tp):
        p.feat2point = f2p.copy()
        p.good_views = {0, 2}
    hits = 0
    for view in (1, 3):
        (fj_, pj_), (ft_, pt_) = jp.find_2d3d_matches(view), tp.find_2d3d_matches(view)
        np.testing.assert_array_equal(ft_, fj_)
        np.testing.assert_array_equal(pt_, pj_)
        hits += len(ft_)
    assert hits > 5


def test_adaptive_filter_equals_reference():
    jp, tp, rng = _pair()
    cut = []
    for scale in (0.5, 2.0, 4.0, 8.0, 30.0):     # below the keep floor ... above the reject cap
        e1, e2 = (scale * rng.gamma(2.0, 1.5, (2, 200))).astype(np.float32)
        keep = rng.uniform(0, 1, 200) < 0.6
        got, want = tp._adaptive_filter(e1, e2, keep), jp._adaptive_filter(e1, e2, keep)
        np.testing.assert_array_equal(got, want)
        cut.append(200 - int(got.sum()))
    assert cut[0] == 0 and all(c > 0 for c in cut[2:]), cut


def test_nearest_point_equals_dense_search():
    """The merge's blocked nearest-point search against the reference's dense
    expression (tpusfm/pipeline/incremental.py:766-768), bit for bit, over
    several row blocks and with duplicated map points (first index on ties)."""
    rng = np.random.default_rng(9)
    pipe = make_pipe()
    n = 3000
    live = rng.normal(0, 2, (n, 3)).astype(np.float32)
    live[1500:1600] = live[100:200]                       # exact duplicates: argmin ties
    pipe.xyz[:n] = live
    pipe.n_points = n
    new = rng.normal(0, 2, (1300, 3)).astype(np.float32)
    new[:150] = live[50:200] + np.float32(1e-4)
    ne, d2min = pipe._nearest_point(new)
    d2 = ((new[:, None, :] - live[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(ne, d2.argmin(1))
    np.testing.assert_array_equal(d2min, d2.min(1))
    assert d2min.dtype == np.float32 and (ne[50:150] < 1500).all()
