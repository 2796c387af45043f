"""Parity of the PyTorch port's RANSAC-driven geometry with tpusfm.

JAX's threefry streams cannot be reproduced in PyTorch, so the port's
solvers take the reference's own minimal samples: each test draws
``tpusfm.ransac._sample_indices`` with the key it hands the JAX function
and feeds the same indices to the port as ``sample_idx``.

Tolerances: singular vectors are compared up to sign; poses to 1e-3
(rotation entries) — float32 SVD/eigh round-off differs between LAPACK
paths and moves the LO refits by ~1e-5, and inlier masks may differ only
on points whose residual sits within round-off of the gate.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests import fixtures
from tpusfm import camera as jcam
from tpusfm.geometry import essential as jess
from tpusfm.geometry import homography as jhom
from tpusfm.geometry import pnp as jpnp
from tpusfm.ransac import _sample_indices
from tpusfm_torch import ransac as tran
from tpusfm_torch.geometry import essential as tess
from tpusfm_torch.geometry import homography as thom
from tpusfm_torch.geometry import pnp as tpnp

torch.set_num_threads(1)


def T(x):
    return torch.as_tensor(np.array(x))


def _stereo(n=200, noise=0.5, outliers=40, seed=0):
    intr = fixtures.intrinsics()
    pts = fixtures.dense_points(n, seed)
    p1, p2 = fixtures.stereo_poses()
    rng = np.random.default_rng(seed + 1)
    uv1 = np.array(fixtures.project(p1, pts)) + rng.normal(0, noise, (n, 2))
    uv2 = np.array(fixtures.project(p2, pts)) + rng.normal(0, noise, (n, 2))
    uv2[:outliers] = rng.uniform(0, 1000, (outliers, 2))
    return intr, np.asarray(jcam.relative_pose(p1, p2)), uv1.astype(np.float32), \
        uv2.astype(np.float32)


def J(fn, **static):
    """The reference function compiled once (eager JAX runs op by op)."""
    return jax.jit(functools.partial(fn, **static))


def _assert_masks_close(a, b, max_diff=2):
    assert int((np.asarray(a) != np.asarray(b)).sum()) <= max_diff


def test_sample_indices_valid_and_distinct():
    mask = np.zeros(50, bool)
    mask[::3] = True
    g = torch.Generator().manual_seed(0)
    idx = tran.sample_indices(g, T(mask), 64, 8).numpy()
    assert idx.shape == (64, 8)
    assert mask[idx].all()
    assert all(len(set(row)) == 8 for row in idx)


def test_homography_ransac_parity():
    rng = np.random.default_rng(0)
    H_true = np.array([[1.05, 0.02, 5.0], [-0.03, 0.97, -3.0], [1e-4, -1e-4, 1.0]], np.float32)
    x1 = rng.uniform(0, 1000, (120, 2)).astype(np.float32)
    xh = np.concatenate([x1, np.ones((120, 1), np.float32)], 1) @ H_true.T
    x2 = (xh[:, :2] / xh[:, 2:3] + rng.normal(0, 0.5, (120, 2))).astype(np.float32)
    x2[:30] = rng.uniform(0, 1000, (30, 2))
    w = np.ones(120, np.float32)
    w[:30] = 0
    np.testing.assert_allclose(thom.homography_dlt(T(x1), T(x2), T(w)).numpy(),
                               np.asarray(jhom.homography_dlt(x1, x2, w)), rtol=1e-3, atol=1e-4)
    mask = np.ones(120, bool)
    mask[-5:] = False
    key = jax.random.PRNGKey(3)
    idx = _sample_indices(key, jnp.asarray(mask), 128, 4)
    cj, Hj, inl_j = J(jhom.find_homography_inliers, threshold_px=10.0, hypotheses=128)(
        key, x1, x2, jnp.asarray(mask))
    ct, Ht, inl_t = thom.find_homography_inliers(None, T(x1), T(x2), T(mask), 10.0, 128,
                                                 sample_idx=T(idx).long())
    assert abs(int(ct) - int(cj)) <= 1
    _assert_masks_close(inl_t.numpy(), inl_j, 1)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-3, atol=1e-3)


def test_essential_solvers_parity():
    intr, rel, uv1, uv2 = _stereo(100, noise=0.0, outliers=0)
    Kinv = np.asarray(intr.Kinv)
    x1 = np.asarray(jcam.normalize_points(Kinv, uv1))
    x2 = np.asarray(jcam.normalize_points(Kinv, uv2))
    Ej = np.asarray(J(jess.essential_8pt)(x1, x2))
    Et = tess.essential_8pt(T(x1), T(x2)).numpy()
    Et = Et * np.sign((Et * Ej).sum())        # E is defined up to sign
    np.testing.assert_allclose(Et, Ej, atol=1e-4)
    np.testing.assert_allclose(tess.sampson_error(T(Ej), T(x1), T(x2)).numpy(),
                               np.asarray(J(jess.sampson_error)(Ej, x1, x2)), atol=1e-7)
    mask = np.ones(100, bool)
    for dt, dj in ((tess.decompose_essential_hz, jess.decompose_essential_hz),
                   (tess.decompose_essential_horn90, jess.decompose_essential_horn90)):
        Rt_t, fr_t, frac_t, _ = tess.pick_pose_by_cheirality(dt(T(Ej)), T(x1), T(x2), T(mask))
        Rt_j, fr_j, frac_j, _ = J(lambda E: jess.pick_pose_by_cheirality(dj(E), x1, x2, mask))(Ej)
        # compare the chosen pose, not the order of the candidates
        np.testing.assert_allclose(Rt_t.numpy(), np.asarray(Rt_j), atol=1e-4)
        np.testing.assert_array_equal(fr_t.numpy(), np.asarray(fr_j))
    w = np.ones(100, np.float32)
    np.testing.assert_allclose(
        tess.refine_essential(T(Ej), T(x1), T(x2), T(w)).numpy(),
        np.asarray(J(jess.refine_essential)(Ej, x1, x2, w)), atol=1e-4)
    Rt2 = np.asarray(fixtures.stereo_poses()[1])
    Rt1 = np.asarray(fixtures.stereo_poses()[0])
    np.testing.assert_allclose(tess.essential_from_poses(T(Rt1), T(Rt2)).numpy(),
                               np.asarray(jess.essential_from_poses(Rt1, Rt2)), atol=1e-6)


def test_find_camera_from_match_parity():
    intr, rel, uv1, uv2 = _stereo()
    K, Kinv = np.asarray(intr.K), np.asarray(intr.Kinv)
    mask = np.ones(200, bool)
    key = jax.random.PRNGKey(0)
    idx = _sample_indices(key, jnp.asarray(mask), 512, 8)
    rj = J(jess.find_camera_from_match, threshold_px=2.0, hypotheses=512,
           min_front_frac=0.75, max_front_reproj_px=100.0)(
        key, uv1, uv2, jnp.asarray(mask), K, Kinv)
    rt = tess.find_camera_from_match(None, T(uv1), T(uv2), T(mask), T(K), T(Kinv),
                                     threshold_px=2.0, hypotheses=512,
                                     min_front_frac=0.75, max_front_reproj_px=100.0,
                                     sample_idx=T(idx).long())
    assert bool(rt.ok) and bool(rj.ok)
    np.testing.assert_allclose(rt.Rt.numpy(), np.asarray(rj.Rt), atol=1e-3)
    np.testing.assert_allclose(rt.Rt[:, :3].numpy(), rel[:, :3], atol=5e-2)
    _assert_masks_close(rt.inliers.numpy(), rj.inliers)
    assert abs(float(rt.inlier_ratio) - float(rj.inlier_ratio)) <= 0.01
    inl = rt.inliers.numpy()
    assert inl[40:].mean() > 0.9 and inl[:40].mean() < 0.1


def test_epipolar_inliers_parity():
    intr, _, uv1, uv2 = _stereo(seed=4)
    K, Kinv = np.asarray(intr.K), np.asarray(intr.Kinv)
    mask = np.ones(200, bool)
    mask[-10:] = False
    key = jax.random.PRNGKey(2)
    idx = _sample_indices(key, jnp.asarray(mask), 128, 8)
    ij = J(jess.epipolar_inliers, threshold_px=3.0, hypotheses=128)(
        key, uv1, uv2, jnp.asarray(mask), K, Kinv)
    it = tess.epipolar_inliers(None, T(uv1), T(uv2), T(mask), T(K), T(Kinv),
                               threshold_px=3.0, hypotheses=128, sample_idx=T(idx).long())
    _assert_masks_close(it.numpy(), ij)
    # batched over two pairs, with the same samples, gives the same masks
    it2 = tess.epipolar_inliers(None, T(np.stack([uv1, uv1])), T(np.stack([uv2, uv2])),
                                T(np.stack([mask, mask])), T(K), T(Kinv), threshold_px=3.0,
                                hypotheses=128, sample_idx=T(np.stack([idx, idx])).long())
    np.testing.assert_array_equal(it2[1].numpy(), it.numpy())


def test_pnp_parity():
    intr = fixtures.intrinsics()
    K, Kinv = np.asarray(intr.K), np.asarray(intr.Kinv)
    pts = np.asarray(fixtures.dense_points(120))
    Rt_true = np.asarray(fixtures.mock_pose((5.0, 5.0, 5.0), (-1.0, 0.0, 1.0)))
    uv = np.array(fixtures.project(jnp.asarray(Rt_true), jnp.asarray(pts)))
    x = np.asarray(jcam.normalize_points(Kinv, uv))
    Rt_t, ok_t = tpnp.pnp_dlt(T(pts[:60]), T(x[:60]))
    Rt_j, ok_j = J(jpnp.pnp_dlt)(pts[:60], x[:60])
    assert bool(ok_t) and bool(ok_j)
    np.testing.assert_allclose(Rt_t.numpy(), np.asarray(Rt_j), atol=1e-3)
    Rp = np.asarray(jcam.rodrigues_to_matrix(jnp.array([0.02, -0.01, 0.015])))
    Rt0 = np.concatenate([Rp @ Rt_true[:, :3], Rt_true[:, 3:] + 0.1], 1).astype(np.float32)
    w = np.ones(120, np.float32)
    np.testing.assert_allclose(tpnp.refine_pose_gn(T(Rt0), T(pts), T(x), T(w)).numpy(),
                               np.asarray(J(jpnp.refine_pose_gn)(Rt0, pts, x, w)), atol=1e-4)
    rng = np.random.default_rng(3)
    uv[:30] = rng.uniform(0, 1200, (30, 2))
    uv = uv.astype(np.float32)
    mask = np.ones(120, bool)
    key = jax.random.PRNGKey(1)
    idx = _sample_indices(key, jnp.asarray(mask), 256, 6)
    rj = J(jpnp.find_camera_pose_2d3d, threshold_px=10.0, hypotheses=256)(
        key, pts, uv, jnp.asarray(mask), K, Kinv)
    rt = tpnp.find_camera_pose_2d3d(None, T(pts), T(uv), T(mask), T(K), T(Kinv),
                                    threshold_px=10.0, hypotheses=256,
                                    sample_idx=T(idx).long())
    assert bool(rt.ok) and bool(rj.ok)
    np.testing.assert_allclose(rt.Rt.numpy(), np.asarray(rj.Rt), atol=1e-3)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
