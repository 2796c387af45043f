"""The port's distribution layer (tpusfm_torch/dist) against tpusfm/dist.

Mirrors tests/test_dist.py. The port's multi-rank results come from gloo
ranks on the CPU, spawned once per world size (2 and 4) by a module-scoped
fixture: each rank runs tests/torch_dist_worker.py, which imports only
torch and tpusfm_torch, on inputs this module writes (made from a seed
with numpy) and writes its outputs back as .npz. tpusfm's come from the
8-device CPU mesh of tests/conftest.py and from its unsharded solvers,
on the same inputs.

Tolerances: matching and the ring are integer selections, equal bit for
bit. The bundle adjusters run to convergence on observations with 0.4 px
of noise (so the optimum's cost is not zero) and are compared there, as
__graft_entry__.py::dryrun_multichip compares them: final cost within 5%,
camera centres within 2e-3 after similarity alignment (a sum over two or
four shards adds in another order than one process, so the trajectories
part in the last bits mid-descent). A world of one rank equals the
unsharded solvers and matchers bit for bit.
"""
import concurrent.futures
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from tests import fixtures
from tpusfm.dist import adjust_bundle_sharded as j_adjust_bundle_sharded
from tpusfm.dist import adjust_bundle_sparse_sharded as j_adjust_bundle_sparse_sharded
from tpusfm.dist import make_mesh as j_make_mesh
from tpusfm.dist import match_all_pairs_ring as j_match_all_pairs_ring
from tpusfm.dist import match_all_pairs_sharded as j_match_all_pairs_sharded
from tpusfm.dist import ring_matches_to_matrix as j_ring_matches_to_matrix
from tpusfm.types import Features as JFeatures
from tpusfm_torch.ba import adjust_bundle
from tpusfm_torch.ba.sparse import adjust_bundle_sparse
from tpusfm_torch.dist import (adjust_bundle_sharded, adjust_bundle_sparse_sharded, make_mesh,
                               match_all_pairs_ring, match_all_pairs_sharded,
                               ring_matches_to_matrix)
from tpusfm_torch.dist.mesh import spawn
from tpusfm_torch.eval import ate_rmse
from tpusfm_torch.features import extract_features
from tpusfm_torch.features.match import match_all_pairs
from tpusfm_torch.types import Matches
from tests.torch_dist_worker import FTOL, ITERS, PIPELINE_WORLD, features

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
WORLDS = (2, 4)
COST_RTOL, POSE_TOL = 0.05, 2e-3


def _inputs():
    """Every input of the multi-rank checks, as numpy arrays."""
    rng = np.random.default_rng(0)
    intr = fixtures.intrinsics()
    K = np.array(intr.K)
    # dense grid: tests/test_dist.py's fixture, plus pixel noise
    pts = np.asarray(fixtures.dense_points(64, seed=3))
    poses = np.stack([np.asarray(fixtures.mock_pose(e, t)) for e, t in (
        ((5.0, 5.0, 5.0), (-1.0, 0.0, 1.0)), ((-5.0, 0.0, 5.0), (1.0, 0.0, 0.8)),
        ((0.0, -6.0, 2.0), (0.0, 0.5, 1.2)), ((2.0, 3.0, -4.0), (-0.5, -0.3, 0.9)))])
    uv = np.stack([np.asarray(fixtures.project(jnp.asarray(p), jnp.asarray(pts), intr))
                   for p in poses], 1)
    out = dict(K=K, dense_uv=(uv + rng.normal(0.0, 0.4, uv.shape)).astype(np.float32),
               dense_Rt=(poses + 0.01 * rng.standard_normal(poses.shape)).astype(np.float32),
               dense_pts=(pts + 0.05 * rng.standard_normal(pts.shape)).astype(np.float32))
    # COO: tests/test_dist.py's V, N = 4, 64, plus pixel noise
    V, N = 4, 64
    cpts = np.stack([rng.uniform(-6, 6, N), rng.uniform(-4, 4, N),
                     rng.uniform(12, 30, N)], 1).astype(np.float32)
    Rt = np.stack([np.asarray(fixtures.mock_pose((2.0 * v, -1.0 * v, 0.5 * v),
                                                 (-0.5 * v, 0.05 * v, 1.0))) for v in range(V)])
    cidx = np.tile(np.arange(V, dtype=np.int32), N)
    pidx = np.repeat(np.arange(N, dtype=np.int32), V)
    pc = np.einsum("oij,oj->oi", Rt[cidx, :, :3], cpts[pidx]) + Rt[cidx, :, 3]
    cuv = pc[:, :2] / pc[:, 2:] * K[0, 0] + K[:2, 2]
    out.update(coo_Rt=(Rt + 0.003 * rng.standard_normal(Rt.shape)).astype(np.float32),
               coo_pts=(cpts + 0.02 * rng.standard_normal(cpts.shape)).astype(np.float32),
               coo_cidx=cidx, coo_pidx=pidx, coo_w=np.ones(len(cidx), np.float32),
               coo_uv=(cuv + rng.normal(0.0, 0.4, cuv.shape)).astype(np.float32))
    # matching: the port's features of four smoothed noise images; 6 pairs
    # padded to 8 (a multiple of 2, 4 and 8)
    imgs = np.stack([ndi.gaussian_filter(im, 1.5) for im in
                     rng.uniform(0, 1, (4, 96, 128)).astype(np.float32)]).astype(np.float32)
    f = extract_features(torch.as_tensor(imgs), max_features=256, pyramid_levels=1)
    out.update(match_xy=f.xy.numpy(), match_desc=f.desc.numpy(), match_valid=f.valid.numpy(),
               match_pairs=np.array([(i, j) for i in range(4) for j in range(i + 1, 4)]
                                    + [(0, 1), (0, 2)], np.int32))
    # the ring: 8 views of random +-1 descriptors, 10% invalid
    Vr, F, D = 8, 64, 128
    out.update(ring_desc=np.sign(rng.standard_normal((Vr, F, D))).astype(np.float32),
               ring_valid=rng.uniform(size=(Vr, F)) > 0.1,
               ring_xy=np.zeros((Vr, F, 2), np.float32))
    return out


def _jax_features(d, prefix):
    V, F = d[prefix + "valid"].shape
    return JFeatures(xy=jnp.asarray(d[prefix + "xy"]), desc=jnp.asarray(d[prefix + "desc"]),
                     score=jnp.zeros((V, F)), angle=jnp.zeros((V, F)),
                     valid=jnp.asarray(d[prefix + "valid"]))


def _tpusfm(d):
    """tpusfm's results on the inputs, on its 8-device mesh."""
    mesh = j_make_mesh(8)
    V, N = d["dense_uv"].shape[1], d["dense_uv"].shape[0]
    dense = (jnp.asarray(d["dense_Rt"]), jnp.ones((V,), bool), jnp.asarray(d["dense_pts"]),
             jnp.ones((N,), bool), jnp.asarray(d["dense_uv"]), jnp.ones((N, V), bool),
             jnp.asarray(d["K"]))
    Vc = d["coo_Rt"].shape[0]
    coo = (jnp.asarray(d["coo_Rt"]), jnp.ones((Vc,), bool), jnp.asarray(d["coo_pts"]),
           d["coo_cidx"], d["coo_pidx"], d["coo_uv"], d["coo_w"], jnp.asarray(d["K"]))
    kw = dict(max_iterations=ITERS, function_tolerance=FTOL)
    ring, gid = j_match_all_pairs_ring(mesh, _jax_features(d, "ring_"), ratio=0.95, max_matches=32)
    m = j_match_all_pairs_sharded(mesh, _jax_features(d, "match_"),
                                  jnp.asarray(d["match_pairs"]), max_matches=128)
    return dict(
        dense_8=j_adjust_bundle_sharded(mesh, *dense, **kw),
        coo_8=j_adjust_bundle_sparse_sharded(mesh, *coo, **kw),
        match_8=(np.asarray(m.idx), np.asarray(m.dist), np.asarray(m.valid)),
        ring_8=j_ring_matches_to_matrix(ring, gid, d["ring_valid"].shape[0]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    """(inputs, {world: [rank outputs]}, tpusfm's results): the port's worlds
    of 2 and 4 gloo ranks run while tpusfm computes its own."""
    d = _inputs()
    tmp = tmp_path_factory.mktemp("torch_dist")
    np.savez(tmp / "inputs.npz", **d)
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex:
        jobs = {w: ex.submit(spawn, [sys.executable, WORKER, str(tmp / "inputs.npz"), str(tmp)],
                             w, timeout=600, cwd=REPO) for w in WORLDS}
        ref = _tpusfm(d)
        for job in jobs.values():
            job.result()
    port = {w: [dict(np.load(tmp / f"w{w}_r{r}.npz")) for r in range(w)] for w in WORLDS}
    return d, port, ref


@pytest.fixture(scope="module")
def world_one():
    """A mesh of one gloo rank in this process."""
    import torch.distributed as dist

    mesh = make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def _port_single(d, kind):
    """The port's unsharded solve of the dense or the COO problem."""
    T = torch.as_tensor
    K = T(d["K"])
    if kind == "dense":
        N, V = d["dense_uv"].shape[:2]
        return adjust_bundle(T(d["dense_Rt"]), torch.ones(V, dtype=torch.bool), T(d["dense_pts"]),
                             torch.ones(N, dtype=torch.bool), T(d["dense_uv"]),
                             torch.ones(N, V, dtype=torch.bool), K, max_iterations=ITERS,
                             function_tolerance=FTOL)
    V = d["coo_Rt"].shape[0]
    return adjust_bundle_sparse(T(d["coo_Rt"]), torch.ones(V, dtype=torch.bool), T(d["coo_pts"]),
                                T(d["coo_cidx"]).long(), T(d["coo_pidx"]).long(), T(d["coo_uv"]),
                                T(d["coo_w"]), K, max_iterations=ITERS, function_tolerance=FTOL)


def _same_optimum(Rt, cost, Rt_ref, cost_ref):
    assert cost > 0.0 and cost_ref > 0.0, "noise-free optimum: a sign error could hide"
    assert abs(cost - cost_ref) / cost_ref < COST_RTOL, (cost, cost_ref)
    assert ate_rmse(np.asarray(Rt), np.asarray(Rt_ref)) < POSE_TOL


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_return_identical_results(runs, world):
    """Every rank holds the same replicated result, bit for bit."""
    _, port, _ = runs
    for other in port[world][1:]:
        assert other.keys() == port[world][0].keys()
        for k, v in port[world][0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ba_matches_single_device(runs, world):
    d, port, ref = runs
    out = port[world][0]
    single = _port_single(d, "dense")
    assert int(out["dense_iters"]) < ITERS and int(single[3].iterations) < ITERS
    _same_optimum(out["dense_Rt"], float(out["dense_cost"]), single[0],
                  float(single[3].final_cost))
    j8 = ref["dense_8"]
    _same_optimum(out["dense_Rt"], float(out["dense_cost"]), j8[0], float(j8[3].final_cost))
    np.testing.assert_allclose(out["dense_K"][0, 0], float(single[2][0, 0]), rtol=1e-4)
    np.testing.assert_allclose(out["dense_K"][0, 0], float(j8[2][0, 0]), rtol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matching_matches_single_device(runs, world):
    d, port, ref = runs
    out = port[world][0]
    want = match_all_pairs(features(d, "match_"),
                           torch.as_tensor(d["match_pairs"]).long(), max_matches=128)
    assert out["match_valid"].sum() > 0
    np.testing.assert_array_equal(out["match_idx"], want.idx.numpy())
    np.testing.assert_array_equal(out["match_valid"], want.valid.numpy())
    np.testing.assert_array_equal(out["match_dist"], want.dist.numpy())
    for got, j in zip((out["match_idx"], out["match_dist"], out["match_valid"]), ref["match_8"]):
        np.testing.assert_array_equal(got, j)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ba_deterministic(runs, world):
    _, port, _ = runs
    out = port[world][0]
    np.testing.assert_array_equal(out["det1_Rt"], out["det2_Rt"])
    np.testing.assert_array_equal(out["det1_pts"], out["det2_pts"])


@pytest.mark.parametrize("world", WORLDS)
def test_sparse_ba_sharded_matches_single(runs, world):
    d, port, ref = runs
    out = port[world][0]
    single = _port_single(d, "coo")
    assert int(out["coo_iters"]) < ITERS and int(single[3].iterations) < ITERS
    _same_optimum(out["coo_Rt"], float(out["coo_cost"]), single[0], float(single[3].final_cost))
    j8 = ref["coo_8"]
    _same_optimum(out["coo_Rt"], float(out["coo_cost"]), j8[0], float(j8[3].final_cost))


@pytest.mark.parametrize("world", WORLDS)
def test_ring_matching_equals_replicated(runs, world):
    d, port, ref = runs
    out = port[world][0]
    V = d["ring_valid"].shape[0]
    pairs = torch.tensor([(i, j) for i in range(V) for j in range(i + 1, V)])
    want = match_all_pairs(features(d, "ring_"), pairs, ratio=0.95, max_matches=32)
    assert len(out["ring_gid"]) == world * world * (V // world) ** 2
    idx, dist, ok = ring_matches_to_matrix(_ring_matches(out), out["ring_gid"], V)
    np.testing.assert_array_equal(ok, want.valid.numpy())
    np.testing.assert_array_equal(np.where(ok[..., None], idx, -1),
                                  np.where(want.valid.numpy()[..., None], want.idx.numpy(), -1))
    j_idx, _, j_ok = ref["ring_8"]
    np.testing.assert_array_equal(ok, j_ok)
    np.testing.assert_array_equal(np.where(ok[..., None], idx, -1),
                                  np.where(j_ok[..., None], j_idx, -1))


def _ring_matches(out):
    return Matches(idx=torch.as_tensor(out["ring_idx"]), dist=torch.as_tensor(out["ring_dist"]),
                   valid=torch.as_tensor(out["ring_valid"]))


def test_collection_end_to_end_sharded(runs):
    """tests/test_collection.py::test_collection_end_to_end_sharded on a mesh
    of two gloo ranks (the port's dot fixture, 12 views): sharded windowed
    matching and sharded global COO BA, with tpusfm's gates."""
    out = runs[1][PIPELINE_WORLD][0]
    V = len(out["pipe_pose_valid"])
    assert V == 12
    assert int(out["pipe_pose_valid"].sum()) >= V - 2
    assert float(out["pipe_reproj"]) < 1.5
    assert int(out["pipe_points"]) > 150
    assert int(out["pipe_ba_iters"]) > 0


@pytest.mark.parametrize("what", ["dense", "sparse", "matching", "ring"])
def test_world_of_one_equals_unsharded(world_one, what):
    """A mesh of one rank: the sharded entry points equal the unsharded ones
    bit for bit (the all_reduce of one rank is the identity)."""
    d = _inputs()
    T = torch.as_tensor
    if what in ("dense", "sparse"):
        want = _port_single(d, "dense" if what == "dense" else "coo")
        if what == "dense":
            N, V = d["dense_uv"].shape[:2]
            got = adjust_bundle_sharded(
                world_one, T(d["dense_Rt"]), torch.ones(V, dtype=torch.bool), T(d["dense_pts"]),
                torch.ones(N, dtype=torch.bool), T(d["dense_uv"]),
                torch.ones(N, V, dtype=torch.bool), T(d["K"]), max_iterations=ITERS,
                function_tolerance=FTOL)
        else:
            V = d["coo_Rt"].shape[0]
            got = adjust_bundle_sparse_sharded(
                world_one, T(d["coo_Rt"]), torch.ones(V, dtype=torch.bool), d["coo_pts"],
                d["coo_cidx"], d["coo_pidx"], d["coo_uv"], d["coo_w"], T(d["K"]),
                max_iterations=ITERS, function_tolerance=FTOL)
        for g, w in zip((*got[:3], *got[3]), (*want[:3], *want[3])):
            assert torch.equal(g, w)
        return
    prefix, kw = ("match_", dict(max_matches=128)) if what == "matching" else \
        ("ring_", dict(ratio=0.95, max_matches=32))
    feats = features(d, prefix)
    V = feats.num_views
    pairs = (T(d["match_pairs"]).long() if what == "matching"
             else torch.tensor([(i, j) for i in range(V) for j in range(i + 1, V)]))
    want = match_all_pairs(feats, pairs, **kw)
    if what == "matching":
        got = match_all_pairs_sharded(world_one, feats, pairs, **kw)
        for g, w in ((got.idx, want.idx), (got.dist, want.dist), (got.valid, want.valid)):
            assert torch.equal(g, w)
        return
    ring, gid = match_all_pairs_ring(world_one, feats, **kw)
    idx, dist, ok = ring_matches_to_matrix(ring, gid, V)
    np.testing.assert_array_equal(ok, want.valid.numpy())
    np.testing.assert_array_equal(idx, want.idx.numpy())
    np.testing.assert_array_equal(dist, want.dist.numpy())
