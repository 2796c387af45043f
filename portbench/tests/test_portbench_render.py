"""The harness's torch renderers against the port's numpy renderers, on the CPU."""
import numpy as np
import pytest

from portbench import render


@pytest.mark.parametrize("seed", [0, 123457])
def test_corner_scene_equals_make_scene(seed):
    from tpusfm_torch.tools.synthetic import make_scene

    imgs, poses, K = render.corner_scene(3, 48, 64, None, seed, "cpu")
    ref_imgs, ref_poses, ref_K = make_scene(n_views=3, h=48, w=64, seed=seed)
    np.testing.assert_array_equal(poses, ref_poses)
    np.testing.assert_array_equal(K, ref_K)
    assert imgs.dtype == np.float32 and imgs.shape == ref_imgs.shape
    # the products numpy hands to BLAS are written out here: last-bit differences only
    np.testing.assert_allclose(imgs, ref_imgs, rtol=0, atol=1e-6)
    assert np.mean(imgs == ref_imgs) > 0.95


@pytest.mark.parametrize("start", [0, 45])
def test_ring_sector_equals_make_collection_scene(start):
    from tpusfm_torch.tools.synthetic import make_collection_scene

    ring, n = 60, 5
    imgs, poses, K = render.ring_sector(ring, start, n, 24, 32, 40.0, 11, "cpu")
    ref_imgs, ref_poses, ref_K = make_collection_scene(n_views=ring, h=24, w=32, focal=40.0,
                                                       seed=11)
    sel = (start + np.arange(n)) % ring
    np.testing.assert_array_equal(poses, ref_poses[sel])
    np.testing.assert_array_equal(K, ref_K)
    np.testing.assert_allclose(imgs, ref_imgs[sel], rtol=0, atol=1e-6)


def test_scene_pools_follow_the_seed():
    from portbench.run import load_module

    corner = load_module("scenes", "corner")
    cfg = {"views": 3, "height": 32, "width": 48, "focal": None}
    a = corner.make(cfg, 2**33 + 5, 1, 4, "cpu")
    b = corner.make(cfg, 2**33 + 5, 1, 4, "cpu")
    c = corner.make(cfg, 2**33 + 6, 1, 4, "cpu")
    np.testing.assert_array_equal(a["images"], b["images"])
    assert not np.array_equal(a["images"], c["images"])
    ring = load_module("scenes", "ring_sector")
    rcfg = {"ring_views": 40, "views": 4, "height": 16, "width": 24, "focal": 30.0}
    s0 = ring.make(rcfg, 7, 0, 2, "cpu")
    s1 = ring.make(rcfg, 7, 1, 2, "cpu")
    c0 = -np.einsum("vji,vj->vi", s0["gt_poses"][:, :, :3], s0["gt_poses"][:, :, 3])
    c1 = -np.einsum("vji,vj->vi", s1["gt_poses"][:, :, :3], s1["gt_poses"][:, :, 3])
    # the two sectors of a pool lie half a ring apart
    assert np.linalg.norm(c0.mean(0) + c1.mean(0)) < 1.0
