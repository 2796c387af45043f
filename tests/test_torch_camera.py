"""Parity of the PyTorch port's camera, linalg and triangulation helpers
with the JAX reference, on random inputs made with numpy from a seed.

Tolerances: both sides run float32 on the CPU, but XLA and PyTorch use
different sin/cos/sqrt kernels and different summation orders, so values
agree to a few ulps of float32 (~1e-6 relative); 1e-5 leaves room for
error growth through a handful of chained products.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import fixtures
from tpusfm import camera as jcam
from tpusfm.geometry import linalg as jlin
from tpusfm.geometry import triangulation as jtri
from tpusfm_torch import camera as tcam
from tpusfm_torch.geometry import linalg as tlin
from tpusfm_torch.geometry import triangulation as ttri

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def T(x):
    return torch.as_tensor(np.array(x))


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **{**TOL, **kw})


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


def test_rodrigues_roundtrip_and_rotate(rng):
    rv = rng.normal(0, 1.0, (16, 3)).astype(np.float32)
    rv[0] = 0.0
    rv[1] = 1e-9
    R_j = jax.vmap(jcam.rodrigues_to_matrix)(jnp.asarray(rv))
    R_t = tcam.rodrigues_to_matrix(T(rv))
    close(R_t, R_j)
    close(tcam.matrix_to_rodrigues(R_t), jax.vmap(jcam.matrix_to_rodrigues)(R_j), atol=2e-5)
    close(tcam.matrix_to_quaternion(R_t), jax.vmap(jcam.matrix_to_quaternion)(R_j))
    close(tcam.exp_so3(T(rv)), jax.vmap(jcam.exp_so3)(jnp.asarray(rv)))
    p = rng.normal(0, 5.0, (16, 3)).astype(np.float32)
    close(tcam.rotate_angle_axis(T(rv), T(p)),
          jax.vmap(jcam.rotate_angle_axis)(jnp.asarray(rv), jnp.asarray(p)), atol=5e-5)


def test_projection_normalization_distortion(rng):
    intr = fixtures.intrinsics()
    K, Kinv = np.asarray(intr.K), np.asarray(intr.Kinv)
    pts = np.asarray(fixtures.dense_points(50))
    p1, p2 = (np.asarray(p) for p in fixtures.stereo_poses())
    uv_j = jcam.project_points(jnp.asarray(p1), jnp.asarray(K), jnp.asarray(pts))
    uv_t = tcam.project_points(T(p1), T(K), T(pts))
    close(uv_t, uv_j, atol=1e-3)
    close(tcam.normalize_points(T(Kinv), uv_t),
          jcam.normalize_points(jnp.asarray(Kinv), uv_j))
    dist = np.array([0.08, -0.02, 1e-3, -5e-4, 0.004], np.float32)
    xn = np.asarray(jcam.normalize_points(jnp.asarray(Kinv), uv_j))
    close(tcam.distort_normalized(T(dist), T(xn)),
          jcam.distort_normalized(jnp.asarray(dist), jnp.asarray(xn)))
    uv = np.asarray(uv_j)
    close(tcam.undistort_points(T(K), T(Kinv), T(dist), T(uv)),
          jcam.undistort_points(jnp.asarray(K), jnp.asarray(Kinv), jnp.asarray(dist),
                                jnp.asarray(uv)), atol=1e-3)
    close(tcam.relative_pose(T(p1), T(p2)), jcam.relative_pose(jnp.asarray(p1), jnp.asarray(p2)))
    close(tcam.camera_center(T(p1)), jcam.camera_center(jnp.asarray(p1)))


def test_project_points_h(rng):
    """Projection with a full 3x4 P = K [R|t], one P and a batch of them."""
    intr = fixtures.intrinsics()
    K = np.asarray(intr.K)
    pts = np.asarray(fixtures.dense_points(50))
    p1, p2 = (np.asarray(p) for p in fixtures.stereo_poses())
    P = np.stack([K @ p1, K @ p2]).astype(np.float32)
    want = np.stack([np.asarray(jcam.project_points_h(jnp.asarray(Pi), jnp.asarray(pts)))
                     for Pi in P])
    close(tcam.project_points_h(T(P[0]), T(pts)), want[0], atol=1e-3)
    close(tcam.project_points_h(T(P), T(pts)), want, atol=1e-3)
    close(tcam.project_points_h(T(P[0]), T(pts)), tcam.project_points(T(p1), T(K), T(pts)),
          atol=1e-3)


def test_batched_aliases(rng):
    """tpusfm's vmapped names: the Rodrigues maps over a batch, and
    project_points_b over poses only (in_axes=(0, None, None))."""
    rv = rng.normal(0, 1.0, (8, 3)).astype(np.float32)
    R_j = jcam.rodrigues_to_matrix_b(jnp.asarray(rv))
    close(tcam.rodrigues_to_matrix_b(T(rv)), R_j)
    close(tcam.matrix_to_rodrigues_b(tcam.rodrigues_to_matrix_b(T(rv))),
          jcam.matrix_to_rodrigues_b(R_j), atol=2e-5)
    intr = fixtures.intrinsics()
    K = np.asarray(intr.K)
    pts = np.asarray(fixtures.dense_points(20))
    poses = np.stack([np.asarray(p) for p in fixtures.stereo_poses()])
    got = tcam.project_points_b(T(poses), T(K), T(pts))
    assert tuple(got.shape) == (2, 20, 2)
    close(got, jcam.project_points_b(jnp.asarray(poses), jnp.asarray(K), jnp.asarray(pts)),
          atol=1e-3)


def test_poses_set():
    """Poses.set returns a copy with one view's pose set and registered."""
    from tpusfm.types import Poses as JPoses
    from tpusfm_torch.types import Poses

    Rt = np.asarray(fixtures.mock_pose())
    want = JPoses.empty(4).set(2, jnp.asarray(Rt))
    empty = Poses.empty(4)
    got = empty.set(2, T(Rt))
    np.testing.assert_array_equal(got.Rt.numpy(), np.asarray(want.Rt))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert not empty.valid.any() and not empty.Rt.any()


def test_linalg_helpers(rng):
    A = rng.normal(0, 1.0, (40, 9)).astype(np.float32)
    w = (rng.uniform(0, 1, 40) > 0.2).astype(np.float32)
    for fn_t, fn_j in ((tlin.smallest_singular_vector, jlin.smallest_singular_vector),
                       (tlin.smallest_singular_vector_direct,
                        jlin.smallest_singular_vector_direct)):
        v_t = fn_t(T(A), T(w)).numpy()
        v_j = np.asarray(fn_j(jnp.asarray(A), jnp.asarray(w)))
        # singular vectors are defined up to sign
        v_t = v_t * np.sign(v_t @ v_j)
        close(v_t, v_j, atol=1e-4)
    # wide system (n < d) pads with zero rows
    Aw = rng.normal(0, 1.0, (7, 9)).astype(np.float32)
    v_t = tlin.smallest_singular_vector_direct(T(Aw)).numpy()
    assert np.abs(Aw @ v_t).max() < 1e-4
    pts2 = rng.uniform(0, 1000, (30, 2)).astype(np.float32)
    pts3 = rng.uniform(-5, 5, (30, 3)).astype(np.float32)
    for fn_t, fn_j, pts in ((tlin.hartley_normalize_2d, jlin.hartley_normalize_2d, pts2),
                            (tlin.hartley_normalize_3d, jlin.hartley_normalize_3d, pts3)):
        n_t, T_t = fn_t(T(pts), T(w[:30]))
        n_j, T_j = fn_j(jnp.asarray(pts), jnp.asarray(w[:30]))
        close(n_t, n_j, atol=1e-4)
        close(T_t, T_j, atol=1e-4)


def test_sync_free_small_solvers():
    """The solvers that stand in for eigh/SVD in the PnP DLT (which read an
    error flag back on CUDA) against torch.linalg in float64. The eigenvector
    must be within 1e-4 of float64 eigh, or no further from it than twice
    float32 eigh (the solver it replaces) is, where a small eigen-gap leaves
    float32 unable to resolve the vector; the polar factor within 1e-4."""
    from tpusfm_torch.geometry import pnp as tpnp

    rng = np.random.default_rng(7)
    # consistent 11 x 12 DLT-like systems (one null vector) and noisy 40 x 9 ones
    for n, d, noise in ((11, 12, 0.0), (40, 9, 1e-3)):
        base = rng.normal(0, 1.0, (64, n, d))
        null = rng.normal(0, 1.0, (64, d))
        A = base - (base @ null[..., None]) * null[:, None, :] / (null ** 2).sum(-1)[:, None, None]
        A = (A + noise * rng.normal(0, 1.0, A.shape)).astype(np.float32)
        G = torch.as_tensor(A).transpose(-1, -2) @ torch.as_tensor(A)
        ref = torch.linalg.eigh(G.double())[1][..., 0].numpy()

        def err(v):
            return np.abs(v * np.sign((v * ref).sum(-1, keepdims=True)) - ref).max(-1)

        e_new = err(tlin.smallest_eigenvector_psd(G).numpy())
        e_f32 = err(torch.linalg.eigh(G)[1][..., 0].numpy())
        assert (e_new <= np.maximum(1e-4, 2 * e_f32)).all(), (e_new.max(), e_f32.max())
    M = rng.normal(0, 1.0, (32, 3, 3)).astype(np.float32) + 2 * np.eye(3, dtype=np.float32)
    U, _, Vt = torch.linalg.svd(torch.as_tensor(M).double())
    close(tpnp._orthogonal_polar_factor(T(M)), U @ Vt, atol=1e-4)
    close(tpnp._det3(T(M)), np.linalg.det(M), rtol=1e-4, atol=1e-4)


def test_batched_jacobian_matches_jacfwd(rng):
    X = rng.normal(0, 2.0, (20, 3)).astype(np.float32) + np.array([0, 0, 10], np.float32)
    params = rng.normal(0, 0.1, (6,)).astype(np.float32)

    def f_j(p):
        pc = jax.vmap(lambda q: jcam.rotate_angle_axis(p[:3], q))(jnp.asarray(X)) + p[3:]
        return (pc[:, :2] / pc[:, 2:3]).reshape(-1)

    def f_t(p):
        pc = tcam.rotate_angle_axis(p[..., None, :3], T(X)) + p[..., None, 3:]
        return (pc[..., :2] / pc[..., 2:3]).reshape(*pc.shape[:-2], -1)

    J_j = jax.jacfwd(f_j)(jnp.asarray(params))
    J_t = tlin.batched_jacobian(f_t, T(params))
    close(J_t, J_j, atol=1e-5)
    # batch elements stay independent
    J_b = tlin.batched_jacobian(f_t, T(np.stack([params, params * 0.5])))
    close(J_b[0], J_j, atol=1e-5)


def test_triangulation_parity():
    intr = fixtures.intrinsics()
    K, Kinv = np.asarray(intr.K), np.asarray(intr.Kinv)
    pts = np.asarray(fixtures.dense_points(100))
    p1, p2 = (np.asarray(p) for p in fixtures.stereo_poses())
    rng = np.random.default_rng(5)
    uv1 = np.asarray(fixtures.project(jnp.asarray(p1), jnp.asarray(pts)))
    uv2 = np.asarray(fixtures.project(jnp.asarray(p2), jnp.asarray(pts)))
    uv1 = (uv1 + rng.normal(0, 0.5, uv1.shape)).astype(np.float32)
    uv2 = (uv2 + rng.normal(0, 0.5, uv2.shape)).astype(np.float32)
    uv2[:5] += 50.0
    x1 = np.asarray(jcam.normalize_points(jnp.asarray(Kinv), jnp.asarray(uv1)))
    x2 = np.asarray(jcam.normalize_points(jnp.asarray(Kinv), jnp.asarray(uv2)))
    for fn_t, fn_j in ((ttri.triangulate_dlt, jtri.triangulate_dlt),
                       (ttri.triangulate_hartley_sturm, jtri.triangulate_hartley_sturm)):
        # points sit ~10-20 units away; f32 normal equations agree to ~1e-4
        close(fn_t(T(p1), T(p2), T(x1), T(x2)),
              fn_j(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(x1), jnp.asarray(x2)),
              rtol=1e-4, atol=1e-4)
    mask = np.ones(100, bool)
    mask[7] = False
    out_t = ttri.triangulate_views(T(p1), T(p2), T(K), T(Kinv), T(uv1), T(uv2), T(mask))
    out_j = jtri.triangulate_views(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(K),
                                   jnp.asarray(Kinv), jnp.asarray(uv1), jnp.asarray(uv2),
                                   jnp.asarray(mask))
    close(out_t[0], out_j[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    close(out_t[2], out_j[2], atol=1e-3)
    # batched over view pairs: the leading axis is independent
    xyz_b = ttri.triangulate_hartley_sturm(T(np.stack([p1, p1])), T(np.stack([p2, p2])),
                                           T(np.stack([x1, x1])), T(np.stack([x2, x2])))
    close(xyz_b[1], out_t[0], atol=1e-6)
