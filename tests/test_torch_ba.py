"""Parity of the PyTorch port's LM bundle adjuster with tpusfm/ba/lm.py
on the mock-camera fixtures (same problem, numpy noise from a seed).

Tolerances: residuals and Jacobians agree to float32 round-off; the LM
trajectories then drift apart by round-off in the CG solves, so the
final costs are compared relative to the initial cost (both solvers must
cut it by >= 1e3 and land within 1e-3 of the initial cost of each other).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests import fixtures
from tpusfm import camera as jcam
from tpusfm.ba import BAProblem as JProblem
from tpusfm.ba import adjust_bundle as j_adjust
from tpusfm.ba import lm_solve as j_lm
from tpusfm.ba.lm import _residuals_and_jacobians as j_rj
from tpusfm_torch.ba import BAProblem, adjust_bundle, lm_solve, reprojection_rms
from tpusfm_torch.ba.lm import _residuals_and_jacobians as t_rj

torch.set_num_threads(1)


def _problem(noise_cam=0.0, noise_pt=0.0, noise_f=0.0, n_pts=60):
    intr = fixtures.intrinsics()
    pts = fixtures.dense_points(n_pts, seed=3)
    poses = jnp.stack([
        fixtures.mock_pose((5.0, 5.0, 5.0), (-1.0, 0.0, 1.0)),
        fixtures.mock_pose((-5.0, 0.0, 5.0), (1.0, 0.0, 0.8)),
        fixtures.mock_pose((0.0, -6.0, 2.0), (0.0, 0.5, 1.2)),
    ])
    V = poses.shape[0]
    uv = jnp.stack([fixtures.project(p, pts, intr) for p in poses], axis=1)
    rng = np.random.default_rng(0)
    cams = jnp.concatenate([jcam.matrix_to_rodrigues_b(poses[:, :, :3]), poses[:, :, 3]], 1)
    cams = cams + noise_cam * jnp.asarray(rng.standard_normal(cams.shape), jnp.float32)
    pts_in = pts + noise_pt * jnp.asarray(rng.standard_normal(pts.shape), jnp.float32)
    mask = np.ones((n_pts, V), bool)
    mask[::7, 1] = False
    jp = JProblem(cams=cams, points=pts_in, focal=intr.focal + noise_f,
                  uv=uv - intr.pp[None, None, :], mask=jnp.asarray(mask),
                  cam_valid=jnp.ones((V,), bool), pt_valid=jnp.ones((n_pts,), bool))
    tp = BAProblem(*(torch.as_tensor(np.array(x)) for x in jp[:7]))
    return jp, tp, poses, intr


def test_residuals_and_jacobians_match():
    jp, tp, _, _ = _problem(noise_cam=0.01, noise_pt=0.05)
    jp = jp._replace(pp_delta=jnp.zeros((2,), jnp.float32))
    tp = tp._replace(pp_delta=torch.zeros(2))
    for a, b in zip(t_rj(tp), jax.jit(j_rj)(jp)):
        scale = max(1.0, float(np.abs(np.asarray(b)).max()))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5 * scale)


def test_lm_solve_final_cost_parity():
    jp, tp, _, _ = _problem(noise_cam=0.01, noise_pt=0.05, noise_f=10.0)
    js, jsum = jax.jit(lambda p: j_lm(p, max_iterations=50))(jp)
    ts, tsum = lm_solve(tp, max_iterations=50)
    c0 = float(jsum.initial_cost)
    np.testing.assert_allclose(float(tsum.initial_cost), c0, rtol=1e-5)
    assert float(tsum.final_cost) < c0 * 1e-3
    assert abs(float(tsum.final_cost) - float(jsum.final_cost)) < 1e-3 * c0
    # both stop on the stall/tolerance exit near the f32 noise floor, where
    # the iteration count depends on round-off; only the budget is shared
    assert 0 < int(tsum.iterations) <= 50 and bool(tsum.converged)
    assert abs(float(ts.focal) - float(js.focal)) < 0.5
    assert float(reprojection_rms(ts)) < 0.1


def test_lm_host_exit_and_frozen_loop_agree():
    """The sync-free loop (frozen once done) gives the early-exit result."""
    _, tp, _, _ = _problem(noise_cam=0.01, noise_pt=0.05)
    a, sa = lm_solve(tp, max_iterations=30, host_exit=True)
    b, sb = lm_solve(tp, max_iterations=30, host_exit=False)
    assert int(sa.iterations) == int(sb.iterations)
    torch.testing.assert_close(a.cams, b.cams, rtol=0, atol=0)
    torch.testing.assert_close(sa.final_cost, sb.final_cost, rtol=0, atol=0)


def test_adjust_bundle_parity_and_masks():
    jp, tp, poses, intr = _problem(noise_cam=0.005, noise_pt=0.02)
    uv_raw = np.array(jp.uv + intr.pp[None, None, :])
    R = jcam.rodrigues_to_matrix_b(jp.cams[:, :3])
    Rt_in = np.array(jnp.concatenate([R, jp.cams[:, 3:, None]], axis=2))
    cam_valid = np.array([True, True, False])
    args = (Rt_in, cam_valid, np.array(jp.points), np.ones(60, bool), uv_raw,
            np.array(jp.mask), np.array(intr.K))
    jR, jX, jK, _ = jax.jit(lambda *a: j_adjust(*a, max_iterations=40))(
        *(jnp.asarray(a) for a in args))
    tR, tX, tK, tsum = adjust_bundle(*(torch.as_tensor(a) for a in args), max_iterations=40)
    # frozen camera stays exactly where it was
    np.testing.assert_allclose(tR[2].numpy(), Rt_in[2], atol=1e-6)
    # two free cameras leave the similarity gauge free, so the two solvers
    # may settle at different points of it: compare the fit, not the state
    for R_, X_, K_ in ((tR.numpy(), tX.numpy(), tK.numpy()),
                       (np.asarray(jR), np.asarray(jX), np.asarray(jK))):
        for v in (0, 1):
            proj = np.asarray(jcam.project_points(jnp.asarray(R_[v]), jnp.asarray(K_),
                                                  jnp.asarray(X_)))
            err = np.linalg.norm(proj - uv_raw[:, v], axis=1)[args[5][:, v]]
            assert err.mean() < 0.1
    # refine_pp moves the principal point, the default keeps it
    _, _, K_pp, _ = adjust_bundle(*(torch.as_tensor(a) for a in args), max_iterations=5,
                                  refine_pp=True)
    assert K_pp[0, 0] > 0 and torch.isfinite(K_pp).all()
    np.testing.assert_array_equal(tK[:2, 2].numpy(), np.array(intr.K)[:2, 2])
