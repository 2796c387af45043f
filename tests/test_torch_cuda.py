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
    collection phase."""
    import math

    import numpy as np

    from tpusfm_torch import SfMConfig
    from tpusfm_torch.eval import ate_rmse, camera_centers
    from tpusfm_torch.pipeline import CollectionPipeline
    from tpusfm_torch.tools.collection_run import BENCH_CONFIG
    from tpusfm_torch.tools.synthetic import make_collection_scene
    from tpusfm_torch.types import Intrinsics

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
