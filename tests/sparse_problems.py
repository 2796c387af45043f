"""COO bundle-adjustment problems of chosen sizes, for the tests of the
bucketed solve (``tpusfm_torch/ba/sparse.py::_bucketed``) on the CPU
(``test_torch_sparse_ba.py``) and of its replay on the card
(``test_torch_cuda.py``), where JAX is absent."""
import numpy as np

from tpusfm_torch.ba import sparse as tsp
from tpusfm_torch.convert import sparse_problem_from_numpy


def sized_problem(n_pts, n_obs, longest_pt, seed=0, device="cpu"):
    """A problem of exactly ``n_pts`` points and ``n_obs`` observations: eight
    cameras on a 60-degree arc of radius 10 around the points (cameras 0 and
    4 frozen), whose longest point segment is point 0's ``longest_pt``
    observations. Observation t, in point-major order, is seen by camera
    t % 8, so each camera's segment holds n_obs // 8 or one more; the rows
    are then shuffled. Made on the CPU, then moved to ``device``."""
    rng = np.random.default_rng(seed)
    V, f = 8, 500.0
    per = np.full(n_pts, 2, np.int64)
    per[0] = longest_pt
    rest = n_obs - per.sum()
    per[1:] += rest // (n_pts - 1)
    per[1:1 + rest % (n_pts - 1)] += 1
    assert per.sum() == n_obs and per[1:].max() <= longest_pt
    pidx = np.repeat(np.arange(n_pts), per)
    cidx = np.arange(n_obs) % V
    cams = np.zeros((V, 6), np.float32)
    cams[:, 1] = np.radians(np.linspace(-30.0, 30.0, V))   # looking at the origin
    cams[:, 5] = 10.0
    pts = rng.uniform(-4, 4, (n_pts, 3)).astype(np.float32)
    clean = sparse_problem_from_numpy(cams, pts, f, cidx, pidx, np.zeros((n_obs, 2)),
                                      np.ones(n_obs), np.ones(V))
    uv = tsp._all_residuals(clean.cams, clean.points, clean.focal, clean).numpy()
    uv = uv + rng.normal(0.0, 0.05, uv.shape)
    perm = rng.permutation(n_obs)
    free = np.ones(V, np.float32)
    free[[0, 4]] = 0.0
    return sparse_problem_from_numpy(
        cams + 0.02 * rng.standard_normal(cams.shape).astype(np.float32) * free[:, None],
        pts + 0.3 * rng.standard_normal(pts.shape).astype(np.float32), f, cidx[perm],
        pidx[perm], uv[perm], np.ones(n_obs), free, device=device)


# The settings of ring500's local window and of a chunk of its global Huber
# rounds (``portbench/configs/ring500.json``: the focal fixed). Past a chunk
# the global solve stalls at float32's floor, where rounding decides which
# steps are accepted.
LOCAL = dict(max_iterations=10, function_tolerance=1e-4, share_focal=False, cg_iterations=32)
GLOBAL = dict(max_iterations=5, function_tolerance=1e-6, share_focal=False, cg_iterations=56,
              huber_delta=3.0)


def settings_of(kw):
    return tsp._Settings(kw["share_focal"], kw["cg_iterations"], kw.get("huber_delta", 0.0),
                         kw["function_tolerance"])


def padded_solve(prob, kw):
    """The eager solve of ``prob`` padded to its buckets: (padded problem,
    segments, buckets, solution with the pad points, summary)."""
    padded, segments, buckets = tsp._bucketed(prob)
    sol, summary = tsp._solve_eager(padded, segments, settings_of(kw),
                                    max_iterations=kw["max_iterations"],
                                    initial_lambda=1e-3, host_exit=True)
    return padded, segments, buckets, sol, summary
