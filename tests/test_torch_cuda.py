"""The hand-written CUDA matcher (K1) against its plain PyTorch version,
on the card, and the pipelines that reach it. These tests skip without an NVIDIA GPU; on a machine with
one (and without JAX) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Distances are exact integers on both sides, so outputs must be equal bit
for bit.
"""
import pytest
import torch

from tpusfm_torch.features import pallas_match as pm
from tpusfm_torch.tools.bench_match import make_case

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.device("cuda")


@pytest.mark.parametrize("P,F1,F2,invalid,kind", [
    (21, 5120, 5120, 0.05, "random"),
    (1, 1536, 1536, 0.0, "random"),
    (1, 1792, 1792, 0.0, "random"),
    (2, 512, 768, 0.1, "ties_none_valid"),
    (2, 512, 768, 0.1, "random"),           # F1 != F2
    (2, 512, 768, 0.1, "cross"),            # ties across key tiles and quad threads
    (1, 256, 256, 0.0, "extremes"),
    (210, 2048, 2048, 0.05, "random"),      # many pairs, short sweeps
    (256, 1024, 1024, 0.05, "random"),      # the collection pipeline's full chunk
    (208, 1024, 1024, 0.05, "random"),      # and short last chunks: 720 pairs = 2 x 256 + 208,
    (192, 1024, 1024, 0.05, "random"),      # 960 pairs = 3 x 256 + 192
])
def test_kernel_matches_plain(cuda, P, F1, F2, invalid, kind):
    fn = pm.match_topk2
    d1, d2, v2 = make_case(P, F1, F2, invalid, seed=F1 + P, kind=kind, device=cuda)
    before = fn.launches
    got = fn(d1, d2, v2)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = pm.match_topk2_plain(d1, d2, v2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.is_cuda
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if kind == "ties_none_valid":
        assert (got[0][0] == 1e9).all() and (got[2][0] == 0).all()


def test_kernel_rejects_bad_input(cuda):
    d = torch.ones(1, 300, 256, dtype=torch.int8, device=cuda)
    v = torch.ones(1, 300, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        pm.match_topk2(d, d, v)
    with pytest.raises(TypeError):
        pm.match_topk2(d[:, :256].float(), d[:, :256].float(), v[:, :256])


def test_host_loop_on_card(cuda):
    """The host-driven loop keeps its tensors on the card and reaches the
    CUDA matcher through the same dispatch as the fused path."""
    import numpy as np

    from tpusfm_torch import SfMConfig
    from tpusfm_torch.pipeline import SfMPipeline
    from tpusfm_torch.tools.synthetic import make_scene
    from tpusfm_torch.types import Intrinsics

    imgs, _, K = make_scene(n_views=3, h=240, w=320, seed=0)
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]), device=cuda)
    pipe = SfMPipeline(imgs, SfMConfig(max_features=1024, max_matches=512, fused=False,
                                       console_debug_level=5), intrinsics=intr, device=cuda)
    before = pm.match_topk2.launches
    pipe.extract()
    pipe.match()
    assert pm.match_topk2.launches == before + 1          # 3 pairs, one unpadded launch
    assert pipe.features.desc.is_cuda and pipe.intr.K.is_cuda
    assert pipe.match_idx.shape == (3, 512, 2) and pipe.match_valid.sum() > 100
    assert pipe.find_baseline_triangulation()
    assert pipe.n_points >= 16 and np.isfinite(pipe.xyz[: pipe.n_points]).all()


def test_collection_pipeline_on_card(cuda, tmp_path):
    """The collection pipeline on the card: 24 consecutive views of a 192-view
    ring (a 45 degree arc; at wider steps the outcome hangs on which baseline
    pair the ranking's RANSAC draws first, in tpusfm as in the port), at the
    widths of the 500-image configuration. The matcher goes through the CUDA
    kernel in chunks, the descriptors are freed, the solvers' tensors stay on
    the card, and the reconstruction meets the gates of chip_smoke's
    collection phase. PnP's graphs are dropped first, so that the spy on
    ``_pnp`` runs in this pipeline's captures."""
    import math

    import numpy as np

    from tpusfm_torch import SfMConfig
    from tpusfm_torch.eval import ate_rmse, camera_centers
    from tpusfm_torch.pipeline import CollectionPipeline, collection
    from tpusfm_torch.tools.collection_run import BENCH_CONFIG
    from tpusfm_torch.tools.synthetic import make_collection_scene
    from tpusfm_torch.types import Intrinsics

    collection._PNP_GRAPHS.graphs.clear()
    V = 24
    imgs, gt, K = make_collection_scene(n_views=192, seed=0)
    imgs, gt = imgs[:V], gt[:V]
    cfg = SfMConfig(**dict(BENCH_CONFIG, collection_wraparound=False, collection_match_chunk=64),
                    console_debug_level=5)
    pipe = CollectionPipeline(imgs, cfg, intrinsics=Intrinsics.create(
        float(K[0, 0]), float(K[0, 2]), float(K[1, 2])))
    assert pipe.device.type == "cuda" and pipe.intr.K.is_cuda and pipe._streaming
    seen = set()
    for name in ("_match_chunk", "_epi_prune", "_two_view", "_pnp", "_tri_multi", "_local_ba",
                 "_final_ba"):
        def spy(*a, _fn=getattr(pipe, name), _name=name, **k):
            out = _fn(*a, **k)
            first = out[0] if isinstance(out, tuple) else getattr(out, "idx", out)
            seen.add((_name, first.device.type))
            return out
        setattr(pipe, name, spy)
    P = len(pipe.pairs)
    before = pm.match_topk2.launches
    pipe.extract()
    held = torch.cuda.memory_allocated()
    pipe.match()
    assert pm.match_topk2.launches == before + math.ceil(P / 64)
    assert pipe.features is None and pipe._extracted
    assert torch.cuda.memory_allocated() < held - V * 1024 * 256 * 4 // 2    # descriptors gone
    rec = pipe.run()
    assert {d for _, d in seen} == {"cuda"} and len(seen) == 7, seen
    n_cam = int(rec.pose_valid.sum())
    assert n_cam >= math.ceil(0.95 * V)
    assert rec.mean_reprojection_error < 1.0
    centres = camera_centers(gt[rec.pose_valid])
    spread = float(np.linalg.norm(centres.max(0) - centres.min(0)))
    assert ate_rmse(rec.poses[rec.pose_valid], gt[rec.pose_valid]) < 0.05 * spread
    assert rec.stats["ba_iters"] > 0 and np.isfinite(rec.xyz).all()
    rec.save_ply(str(tmp_path / "rec"))
    with open(tmp_path / "rec_points.ply") as fh:
        assert f"element vertex {rec.num_points}\n" in fh.read(2000)


def test_fixture_view_on_card_equals_cpu(cuda):
    """One view of the Strecha-format fixture (radial distortion, 512x384)
    rendered on the card against the CPU's render: the same float64
    operations, tanh may round differently, so <= 1 LSB."""
    import numpy as np

    from tpusfm_torch.tools.synthetic import fixture_poses, render_fixture_view

    poses, K = fixture_poses()
    dist = (-0.20, 0.05, 0.0)
    got = render_fixture_view(poses[0], K, dist, 384, 512, device=cuda)
    assert got.is_cuda and got.dtype == torch.uint8 and got.shape == (384, 512)
    want = render_fixture_view(poses[0], K, dist, 384, 512, device="cpu")
    diff = (got.cpu().to(torch.int16) - want.to(torch.int16)).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).double().mean()) >= 0.999
    assert float(np.std(want.numpy())) > 20


def _tiny_fused_run(monkeypatch, cuda, graphed, seed=0, dcx=0.0, **over):
    """One fused reconstruction at the benchmark's tiny sizes
    (``portbench/configs/crazyhorse7.json``: 512 features, 256 matches, a
    map of 1024) of a 5-view 256x192 scene, with the add-view steps
    replayed from their CUDA graph or, ``graphed=False``, run by the eager
    ``_step``. Returns the engine state after each step and, per step, the
    graph that replayed it."""
    from tpusfm_torch import SfMConfig
    from tpusfm_torch.pipeline import SfMPipeline
    from tpusfm_torch.pipeline import engine as fused
    from tpusfm_torch.tools.synthetic import make_scene
    from tpusfm_torch.types import Intrinsics
    from tpusfm_torch.utils import cuda_graph

    imgs, _, K = make_scene(n_views=5, h=192, w=256, seed=0)
    states, graphs = [], []
    replay, step = cuda_graph.Graph.replay, fused.FusedEngine._step

    def replay_kept(self, s):
        st = replay(self, s)
        states.append([x.clone() for x in st])
        graphs.append(self)
        return st

    def step_kept(self, *a):
        st = step(self, *a)
        states.append([x.clone() for x in st])
        return st

    with monkeypatch.context() as m:
        if graphed:
            m.setattr(cuda_graph.Graph, "replay", replay_kept)
        else:
            m.setattr(fused.FusedEngine, "_step_graph", lambda *a: None)
            m.setattr(fused.FusedEngine, "_step", step_kept)
        cfg = SfMConfig(max_features=512, max_matches=256, engine_point_capacity=1024,
                        console_debug_level=5, **over)
        intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]) + dcx, float(K[1, 2]),
                                 device=cuda)
        SfMPipeline(imgs, cfg, intrinsics=intr, seed=seed, device=cuda).run()
    assert len(states) == 3
    return states, graphs


def _assert_same_states(got, want):
    """Every field of each step's state equal bit for bit, but for the write
    trash: row CAP of ``xyz`` and ``obs`` and column F of ``feat2point``
    take the writes of many slots at once, so on the card they hold
    whichever write lands last, in the eager step as in the graph; nothing
    reads them (``pipeline/engine.py``)."""
    from tpusfm_torch.pipeline.engine import EngineState

    defined = {"xyz": (slice(0, -1),), "obs": (slice(0, -1),),
               "feat2point": (slice(None), slice(0, -1))}
    for g_st, w_st in zip(got, want):
        for name, g, w in zip(EngineState._fields, g_st, w_st):
            part = defined.get(name, ())
            torch.testing.assert_close(g[part], w[part], rtol=0, atol=0, equal_nan=True,
                                       msg=lambda m: f"{name}: {m}")
    assert any(float(st[-1][1 + k, 3]) > 0 for k, st in enumerate(want))   # a view registered


@pytest.mark.parametrize("seed,card", [(0, 0), (1, 0), (0, 1)], ids=["0", "1", "card1"])
def test_step_graph_equals_the_eager_step(cuda, monkeypatch, seed, card):
    """Each replay of the add-view step's graph leaves the state the eager
    step leaves, bit for bit, the PnP sampler's draws included. The engine
    is on card ``card`` while card 0 is current: the graph is captured and
    replayed on the engine's card all the same."""
    from tpusfm_torch.pipeline import engine as fused

    if card >= torch.cuda.device_count():
        pytest.skip(f"needs {card + 1} cards")
    dev = torch.device("cuda", card)
    fused._STEP_GRAPHS.graphs.clear()
    with torch.cuda.device(0):
        want, _ = _tiny_fused_run(monkeypatch, dev, graphed=False, seed=seed)
        got, graphs = _tiny_fused_run(monkeypatch, dev, graphed=True, seed=seed)
    assert len(fused._STEP_GRAPHS.graphs) == 1 and len({id(g) for g in graphs}) == 1
    assert [key[0] for key in fused._STEP_GRAPHS.graphs] == [str(dev)]
    _assert_same_states(got, want)


def test_a_second_pipeline_reuses_the_capture(cuda, monkeypatch):
    from tpusfm_torch.pipeline import engine as fused

    fused._STEP_GRAPHS.graphs.clear()
    captures = []
    capture = fused.FusedEngine._capture_step

    def counted(self, *a):
        captures.append(capture(self, *a))
        return captures[-1]

    monkeypatch.setattr(fused.FusedEngine, "_capture_step", counted)
    _, first = _tiny_fused_run(monkeypatch, cuda, graphed=True, seed=0)
    _, second = _tiny_fused_run(monkeypatch, cuda, graphed=True, seed=1)
    assert len(captures) == 1 and {id(g) for g in first + second} == {id(captures[0])}


def test_a_dropped_engine_leaves_its_capture_sound(cuda, monkeypatch):
    """The step graph reads its capturing engine's constant tensors (pair
    table, pair rows, principal point). Once that engine's pipeline is
    dropped and blocks of their sizes are taken and filled with other
    values, a second engine's replays still equal its eager steps."""
    import gc

    from tpusfm_torch.pipeline import engine as fused

    fused._STEP_GRAPHS.graphs.clear()
    consts = []
    capture = fused.FusedEngine._capture_step

    def counted(self, *a):
        consts.append([(t.shape, t.dtype) for t in (self._pairs, self._pair_row, self._pp)])
        return capture(self, *a)

    monkeypatch.setattr(fused.FusedEngine, "_capture_step", counted)
    _tiny_fused_run(monkeypatch, cuda, graphed=True, seed=0)
    gc.collect()
    junk = [torch.full(shape, 12345 if dtype.is_floating_point else 0, dtype=dtype, device=cuda)
            for shape, dtype in consts[0] for _ in range(64)]
    got, _ = _tiny_fused_run(monkeypatch, cuda, graphed=True, seed=1)
    want, _ = _tiny_fused_run(monkeypatch, cuda, graphed=False, seed=1)
    assert len(consts) == 1 and len(junk) == 192
    _assert_same_states(got, want)


@pytest.mark.parametrize("change", [dict(dcx=2.0), dict(pnp_threshold_px=8.0),
                                    dict(min_reprojection_error=8.0)])
def test_another_key_captures_its_own_graph(cuda, monkeypatch, change):
    """An engine with another principal point or another gate threshold
    replays a graph of its own, and that graph equals its eager step."""
    from tpusfm_torch.pipeline import engine as fused

    fused._STEP_GRAPHS.graphs.clear()
    _, first = _tiny_fused_run(monkeypatch, cuda, graphed=True)
    want, _ = _tiny_fused_run(monkeypatch, cuda, graphed=False, **change)
    got, third = _tiny_fused_run(monkeypatch, cuda, graphed=True, **change)
    assert len(fused._STEP_GRAPHS.graphs) == 2 and not {id(g) for g in third} & {id(first[0])}
    _assert_same_states(got, want)


def _pnp_pipeline(cuda, seed=3, sizes=(300, 700)):
    """``test_torch_pnp_graph._pipeline`` on the card: view v sees ``sizes[v]``
    tracks of its own, a quarter of them outliers."""
    from test_torch_pnp_graph import _pipeline     # tests/ is on the path

    return _pipeline(seed, sizes, device=cuda)


@pytest.mark.parametrize("card", [0, 1])
def test_pnp_graph_equals_the_eager_call(cuda, card):
    """Two registrations in two row buckets (512 and 1024), replayed from
    their graphs, against the eager call on the real rows: the same inliers,
    the pose within 1e-5, the generator where the eager draws leave it. The
    pipelines are on card ``card`` while card 0 is current: the graphs are
    captured and replayed on the pipeline's card all the same, as a rank of
    a mesh on another card than the first needs."""
    import numpy as np

    from tpusfm_torch.pipeline import collection

    if card >= torch.cuda.device_count():
        pytest.skip(f"needs {card + 1} cards")
    dev = torch.device("cuda", card)
    collection._PNP_GRAPHS.graphs.clear()
    with torch.cuda.device(0):
        graphed, eager = _pnp_pipeline(dev), _pnp_pipeline(dev)
        eager._pnp_replay = eager._pnp_eager
        for v in (0, 1):
            assert graphed._pnp_view(v) and eager._pnp_view(v)
            np.testing.assert_allclose(graphed.poses[v], eager.poses[v], rtol=0, atol=1e-5)
            assert (graphed.obs_alive == eager.obs_alive).all()
            assert torch.equal(graphed._gen.get_state(), eager._gen.get_state())
    assert not eager.obs_alive.all()                 # outliers were cut
    assert graphed._timings["pnp_graph_replays"] == graphed._timings["pnp_graph_captures"] == 2
    assert eager._timings["pnp_graph_replays"] == 0
    assert [key[0] for key in collection._PNP_GRAPHS.graphs] == [str(dev)] * 2


def test_a_second_collection_pipeline_reuses_the_pnp_graph(cuda):
    from tpusfm_torch.pipeline import collection

    collection._PNP_GRAPHS.graphs.clear()
    first = _pnp_pipeline(cuda, sizes=(300,))
    assert first._pnp_view(0)
    graph = next(iter(collection._PNP_GRAPHS.graphs.values()))
    second = _pnp_pipeline(cuda, seed=4, sizes=(400,))
    assert second._pnp_view(0) and second._pnp_view(0)
    assert first._timings["pnp_graph_captures"] == 1
    assert second._timings["pnp_graph_captures"] == 0
    assert second._timings["pnp_graph_replays"] == 2
    assert list(collection._PNP_GRAPHS.graphs.values()) == [graph]


def test_tiny_ring_job_registers_the_same_views_on_both_paths(cuda):
    """A ring job at the benchmark's tiny sizes (``portbench/configs/
    ring500.json``: 10 views of a 160-view ring, 512 features, 256 matches)
    registers the same views in the same order with PnP replayed from its
    graphs as with the eager call."""
    from tpusfm_torch import SfMConfig
    from tpusfm_torch.pipeline import CollectionPipeline, collection
    from tpusfm_torch.tools.synthetic import make_collection_scene
    from tpusfm_torch.types import Intrinsics

    imgs, _, K = make_collection_scene(n_views=160, seed=0)
    cfg = SfMConfig(max_features=512, max_matches=256, collection_window=6,
                    collection_wraparound=False, collection_local_ba_cams=8,
                    collection_global_ba_interval=50, ba_incremental_iterations=10,
                    ba_max_iterations=75, ba_share_focal=False,
                    min_point_count_for_homography=60, console_debug_level=5)
    collection._PNP_GRAPHS.graphs.clear()
    recs = {}
    for graphed in (True, False):
        pipe = CollectionPipeline(imgs[:10], cfg, seed=1, device=cuda, intrinsics=Intrinsics.create(
            float(K[0, 0]), float(K[0, 2]), float(K[1, 2]), device=cuda))
        if not graphed:
            pipe._pnp_replay = pipe._pnp_eager
        recs[graphed] = (pipe.run(), list(pipe.reg_order))
    (rec_g, order_g), (rec_e, order_e) = recs[True], recs[False]
    assert order_g == order_e and len(order_g) >= 9
    assert rec_g.stats["pnp_graph_replays"] >= len(order_g) - 2
    assert rec_g.stats["pnp_graph_captures"] >= 1 and rec_e.stats["pnp_graph_replays"] == 0
    assert rec_g.mean_reprojection_error == pytest.approx(rec_e.mean_reprojection_error,
                                                          rel=0.01)


@pytest.mark.parametrize("settings,card", [("local", 0), ("global", 0), ("local", 1)],
                         ids=["local", "global", "card1"])
def test_replayed_solve_equals_the_eager_padded_solve(cuda, settings, card):
    """A COO LM solve on the card, each iteration a replay of its bucket's
    graph, ends where the eager solve of the same padded problem ends, bit
    for bit: cameras, points, focal and summary. The problem is on card
    ``card`` while card 0 is current: the graph is captured and replayed on
    the problem's card all the same."""
    from sparse_problems import GLOBAL, LOCAL, padded_solve, sized_problem

    from tpusfm_torch.ba import sparse as tsp

    if card >= torch.cuda.device_count():
        pytest.skip(f"needs {card + 1} cards")
    dev = torch.device("cuda", card)
    kw = LOCAL if settings == "local" else GLOBAL
    tsp._LM_GRAPHS.graphs.clear()
    with torch.cuda.device(0):
        prob = sized_problem(257, 1025, 9, device=dev)
        got, got_sum = tsp.lm_solve_sparse(prob, **kw)
        *_, want, want_sum = padded_solve(prob, kw)
    assert [key[0] for key in tsp._LM_GRAPHS.graphs] == [str(dev)]
    assert got.points.shape == prob.points.shape and got.points.device == dev
    assert torch.equal(got.cams, want.cams) and torch.equal(got.focal, want.focal)
    assert torch.equal(got.points, want.points[:257])
    assert all(torch.equal(g, w) for g, w in zip(got_sum, want_sum))
    assert int(got_sum.iterations) > 2


def test_two_problems_of_one_bucket_share_a_graph(cuda, monkeypatch):
    """Two problems of one bucket go through one captured graph. The first
    problem is dropped and its blocks refilled before the second solve: the
    graph reads only its own buffers, so each solve gives its own eager
    result, and the first result, a tensor of its own, is left as it was."""
    import gc

    from sparse_problems import LOCAL, padded_solve, sized_problem

    from tpusfm_torch.ba import sparse as tsp

    tsp._LM_GRAPHS.graphs.clear()
    graphs, capture = [], tsp.Graph

    def counted(*a, **k):
        graphs.append(capture(*a, **k))
        return graphs[-1]

    monkeypatch.setattr(tsp, "Graph", counted)
    first = sized_problem(250, 1000, 8, seed=1, device=cuda)
    got1, sum1 = tsp.lm_solve_sparse(first, **LOCAL)
    *_, want1, want_sum1 = padded_solve(first, LOCAL)
    shapes = [(t.shape, t.dtype) for t in first]
    del first
    gc.collect()
    junk = [torch.full(shape, 7, dtype=dtype, device=cuda)
            for shape, dtype in shapes for _ in range(16)]
    second = sized_problem(240, 990, 7, seed=2, device=cuda)
    got2, sum2 = tsp.lm_solve_sparse(second, **LOCAL)
    *_, want2, want_sum2 = padded_solve(second, LOCAL)
    assert len(graphs) == 1 and len(tsp._LM_GRAPHS.graphs) == 1 and len(junk) == 128
    for got, s, want, w in ((got1, sum1, want1, want_sum1), (got2, sum2, want2, want_sum2)):
        n = got.points.shape[0]
        assert torch.equal(got.cams, want.cams) and torch.equal(got.points, want.points[:n])
        assert all(torch.equal(a, b) for a, b in zip(s, w))
    assert not torch.equal(got1.cams, got2.cams)
