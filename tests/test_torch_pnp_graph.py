"""The collection pipeline's PnP on padded rows (``pipeline/collection.py``):
on CUDA a registration's correspondences are padded to a power-of-two
bucket, its minimal samples drawn over the real rows before the call, and
the call replayed from a CUDA graph. On the CPU the graph cannot run, so
these tests hold what it replays, ``pnp_packed`` on ``pnp_rows``' rows,
against the eager call on the real rows."""
import numpy as np
import pytest
import torch

from tpusfm_torch import SfMConfig, camera
from tpusfm_torch.pipeline import CollectionPipeline
from tpusfm_torch.pipeline.collection import pnp_out, pnp_packed, pnp_rows
from tpusfm_torch.ransac import sample_indices
from tpusfm_torch.utils.cuda_graph import pow2

torch.set_num_threads(1)
_K = np.array([[300.0, 0, 128], [0, 300, 96], [0, 0, 1]], np.float32)


def _correspondences(n: int, seed: int, outliers: float = 0.25):
    """n 2D-3D correspondences of a 256x192 camera (f = 300 px) seeing
    points 4-8 units ahead, pixels with 0.3 px of noise, and a share of
    them replaced by pixels drawn anywhere in the image."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 8, n)], 1)
    R = camera.rodrigues_to_matrix(torch.tensor([0.05, -0.1, 0.02], dtype=torch.float64))
    Rt = camera.make_pose(R, torch.tensor([0.1, -0.2, 0.3], dtype=torch.float64))
    uv = camera.project_points(Rt, torch.as_tensor(_K, dtype=torch.float64),
                               torch.as_tensor(X)).numpy()
    uv = uv + rng.normal(0, 0.3, uv.shape)
    bad = rng.permutation(n)[:int(outliers * n)]
    uv[bad] = rng.uniform([0, 0], [256, 192], (len(bad), 2))
    return X.astype(np.float32), uv.astype(np.float32)


def _pipeline(seed: int, sizes=(), device="cpu") -> CollectionPipeline:
    """A collection pipeline whose track graph holds one view per entry of
    ``sizes``, view v seeing that many tracks of its own
    (``_correspondences`` of seed v)."""
    from tpusfm_torch.types import Intrinsics

    pipe = CollectionPipeline(np.zeros((max(len(sizes), 2), 16, 16), np.float32),
                              SfMConfig(console_debug_level=5), seed=seed, device=device,
                              intrinsics=Intrinsics.create(300.0, 128.0, 96.0, device=device))
    parts = [_correspondences(n, seed=v) for v, n in enumerate(sizes)]
    pipe.T = sum(sizes)
    pipe.obs_view = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    pipe.obs_track = np.arange(pipe.T)
    pipe.obs_alive, pipe.track_ok = np.ones(pipe.T, bool), np.ones(pipe.T, bool)
    if parts:
        pipe.track_xyz = np.concatenate([p[0] for p in parts])
        pipe.obs_uv = np.concatenate([p[1] for p in parts])
    return pipe


@pytest.mark.parametrize("n", [8, 255, 256, 257, 700, 1024])
def test_padded_rows_give_the_eager_result(n):
    """The padded call with the same minimal samples registers what the
    call on the real rows registers: the same inliers among the real rows,
    no pad row an inlier, the same ratio and gate, the pose within 1e-5.
    A full bucket has no pad row, and its packed row is the eager call's
    result packed by ``pnp_out``, to the bit."""
    X, uv = _correspondences(n, seed=n)
    pipe = _pipeline(0)
    idx = sample_indices(torch.Generator().manual_seed(n), torch.ones(n, dtype=torch.bool),
                         pipe.cfg.pnp_hypotheses, 6)
    K_t, Kinv = pipe.intr.K, pipe.intr.Kinv
    want = pipe._pnp(None, torch.from_numpy(X), torch.from_numpy(uv),
                     torch.ones(n, dtype=torch.bool), K_t, Kinv, sample_idx=idx)
    cap = pow2(n, 256)
    rows = pnp_rows(X, uv, cap)
    assert rows.shape == (cap, 6) and rows[:, 5].sum() == n
    assert (rows[n:, :5] == rows[0, :5]).all()
    got = pnp_packed(pipe._pnp, torch.from_numpy(rows), K_t, Kinv, idx).numpy()
    assert got.shape == (12 + cap + 2,)
    inl = got[12:12 + cap] > 0
    assert (inl[:n] == want.inliers.numpy()).all()
    assert not inl[n:].any()
    assert 0 < inl.sum() < n
    assert got[-2] == float(want.inlier_ratio) and (got[-1] > 0) == bool(want.ok)
    np.testing.assert_allclose(got[:12], want.Rt.reshape(12).numpy(), rtol=0, atol=1e-5)
    if n == cap:
        assert np.array_equal(got, pnp_out(want).numpy())


def test_samples_drawn_before_the_call_are_the_eager_draws():
    """``_pnp_samples`` makes the draw the eager ``_pnp_view`` makes inside
    ``ransac``: the generator ends in the same state, and the padded call
    on those samples registers the same pose and cuts the same
    observations."""
    n = 300
    eager, padded = _pipeline(3, (n,)), _pipeline(3, (n,))
    X, uv = padded.track_xyz, padded.obs_uv
    assert eager._pnp_view(0)
    idx = padded._pnp_samples(n)
    assert torch.equal(eager._gen.get_state(), padded._gen.get_state())
    out = pnp_packed(padded._pnp, torch.from_numpy(pnp_rows(X, uv, pow2(n, 256))),
                     padded.intr.K, padded.intr.Kinv, idx).numpy()
    np.testing.assert_allclose(out[:12].reshape(3, 4), eager.poses[0], rtol=0, atol=1e-5)
    assert ((out[12:12 + n] > 0) == eager.obs_alive).all()

