"""The plain reference agrees with the port where both are exact, and its
numbers read what they should on known answers."""
import numpy as np
import pytest
import torch

from portbench import check, render
from portbench.reference import geometry
from portbench.reference import match as ref_match


@pytest.fixture(scope="module")
def images():
    imgs, _, _ = render.corner_scene(2, 96, 128, None, 3, "cpu")
    return imgs


def test_detector_agrees_with_the_port(images):
    from tpusfm_torch.features.detect import extract_features

    f = extract_features(torch.as_tensor(images), max_features=512)
    ref = check.reference_features(images, _Cfg(), "cpu")
    kp, desc = check.compare_features((f.xy, f.desc, f.valid), ref)
    assert kp < 0.01 and desc < 0.001
    low = check.reference_features(images, _Cfg(), "cpu", dtype=torch.bfloat16)
    kp_low, _ = check.compare_features(low, ref)
    assert kp_low > 0.2               # the control reads far above the program


class _Cfg:
    max_features, desc_bits, pyramid_levels, pyramid_scale, fast_threshold = 512, 256, 4, 1.2, 20.0
    match_ratio, max_matches = 0.8, 256


def test_matcher_equals_the_ports(images):
    from tpusfm_torch.features.detect import extract_features
    from tpusfm_torch.features.pallas_match import match_pairs

    f = extract_features(torch.as_tensor(images), max_features=512)
    pairs = torch.tensor([[0, 1], [1, 0]])
    m = match_pairs(f.desc, f.valid, pairs, ratio=0.8, max_matches=256)
    assert check.compare_matches(f, pairs, m, _Cfg()) [0] == 0
    # an altered match is counted twice (one side each)
    idx = m.idx.clone()
    first = int(torch.nonzero(m.valid[0])[0, 0])
    idx[0, first, 1] = (idx[0, first, 1] + 1) % 512
    bad, total = check.compare_matches(f, pairs, type(m)(idx=idx, dist=m.dist, valid=m.valid),
                                       _Cfg())
    assert bad == 2 and total > 0


def test_match_pair_breaks_ties_by_the_lowest_index():
    d1 = torch.tensor([[1.0, 1, 1, 1]])
    d2 = torch.tensor([[1.0, 1, 1, -1], [1.0, 1, 1, 1], [1.0, 1, 1, 1], [-1.0, -1, -1, -1]])
    left, right, dist = ref_match.match_pair(d1, torch.tensor([True]), d2,
                                             torch.tensor([True, True, True, True]), ratio=0.8,
                                             max_matches=4)
    assert left.tolist() == [] and right.tolist() == []   # best 0 ties with second 0: no match
    left, right, dist = ref_match.match_pair(d1, torch.tensor([True]), d2,
                                             torch.tensor([True, True, False, True]),
                                             ratio=0.8, max_matches=4)
    assert right.tolist() == [1] and dist.tolist() == [0.0]


def _synthetic(n_points=200, seed=0):
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    poses = []
    for v in range(4):
        a = 0.1 * v
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        poses.append(np.concatenate([R, np.array([[-v * 0.5], [0], [0]])], 1))
    poses = np.stack(poses)
    X = rng.uniform([-2, -2, 6], [2, 2, 10], (n_points, 3))
    op, ov = np.meshgrid(np.arange(n_points), np.arange(4), indexing="ij")
    op, ov = op.ravel(), ov.ravel()
    pc = np.einsum("oij,oj->oi", poses[ov][:, :, :3], X[op]) + poses[ov][:, :, 3]
    uv = pc[:, :2] / pc[:, 2:] * 500.0 + [320, 240]
    return poses, K, X, op, ov, uv + rng.normal(0, 0.3, uv.shape)


def test_point_gap_is_zero_at_the_optimum_and_large_off_it():
    poses, K, X, op, ov, uv = _synthetic()
    Xopt, _, _ = geometry.refine_points(poses, K, X, op, ov, uv, iterations=20)
    assert geometry.point_gap(poses, K, Xopt.numpy(), op, ov, uv) < 1e-9
    assert geometry.point_gap(poses, K, Xopt.numpy() + 0.01, op, ov, uv) > 0.5
    low, _, _ = geometry.refine_points(poses, K, Xopt.numpy(), op, ov, uv,
                                       dtype=torch.bfloat16)
    assert geometry.point_gap(poses, K, low.double().numpy(), op, ov, uv) > 0.1
    err = geometry.reprojection(poses, K, Xopt.numpy(), op, ov, uv)
    assert 0.2 < err.mean() < 0.5


def test_camera_gap_is_zero_at_the_optimum_and_large_off_it():
    poses, K, X, op, ov, uv = _synthetic(seed=2)
    Popt, _, _ = geometry.refine_cameras(poses, K, X, op, ov, uv, iterations=20)
    Popt = Popt.numpy()
    assert geometry.camera_gap(Popt, K, X, op, ov, uv) < 1e-9
    moved = Popt.copy()
    moved[1:, 0, 3] += 0.01                           # every camera but the first shifted
    assert geometry.camera_gap(moved, K, X, op, ov, uv) > 0.5
    assert geometry.camera_gap(poses, K, X, op, ov, uv) > 0.01    # noise moved the optimum
    low, _, _ = geometry.refine_cameras(Popt, K, X, op, ov, uv, dtype=torch.bfloat16)
    assert geometry.camera_gap(low.double().numpy(), K, X, op, ov, uv) > 0.1


def test_huber_point_gap_uses_the_robust_loss():
    poses, K, X, op, ov, uv = _synthetic(seed=1)
    uv = uv.copy()
    uv[::37] += 40.0                                  # outliers
    Xh, _, _ = geometry.refine_points(poses, K, X, op, ov, uv, huber=3.0, iterations=30)
    assert geometry.point_gap(poses, K, Xh.numpy(), op, ov, uv, huber=3.0) < 1e-8
    assert geometry.point_gap(poses, K, Xh.numpy(), op, ov, uv) > 1e-4


def test_ate_recovers_a_similarity():
    poses, *_ = _synthetic()
    c = geometry.centres(poses)
    s, R = 2.5, np.array([[0, -1.0, 0], [1, 0, 0], [0, 0, 1]])
    moved = poses.copy()
    # world -> s R world + t: centres move the same way; rotations by R^T
    moved[:, :, :3] = poses[:, :, :3] @ R.T
    moved[:, :, 3] = -np.einsum("vij,vj->vi", moved[:, :, :3], s * c @ R.T + 1.0)
    ate, spread = geometry.ate(moved, poses)
    assert ate < 1e-9 and spread == pytest.approx(np.linalg.norm(c.max(0) - c.min(0)))
