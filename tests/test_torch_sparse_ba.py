"""Parity of the port's sparse (COO) bundle adjuster with tpusfm/ba/sparse.py.

The problems of tests/test_ba_sparse.py, made from a seed with numpy, go
through both packages (``convert.sparse_problem_from_numpy``), on the CPU in
float32.

Tolerances. Residuals, Jacobians and the Schur right-hand side agree to
float32 round-off. The step itself comes from a fixed count of CG iterations
on a system with a free gauge (nothing pins the global similarity), so it is
ill-conditioned: at ``cg_iterations=8`` the two float32 solvers agree to
2e-3 of the step's largest entry; at 32 iterations (more than the 19
unknowns, so CG iterates on round-off) they drift to 2e-2 of it, and the
port's own float64 run is as far from either (measured: 3e-3..6e-3 for
both). The predicted decrease, which the LM loop consumes, is insensitive to
that (1e-4). Full solves are compared by what they reach: final cost relative
to the initial cost, and the points to 1e-3 of the scene scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ba_sparse import _build_sparse
from tpusfm.ba import sparse as jsp
from tpusfm_torch.ba import SparseBAProblem, adjust_bundle, adjust_bundle_sparse, lm_solve_sparse
from tpusfm_torch.ba import sparse as tsp
from tpusfm_torch import camera as tcam
from tpusfm_torch.convert import sparse_problem_from_numpy
from sparse_problems import GLOBAL, LOCAL, padded_solve, sized_problem

torch.set_num_threads(1)

SCENE_SCALE = 10.0      # the fixture's points span about +-5 units


def _both(**kw):
    jp, pts, Rt, intr, grid = _build_sparse(**kw)
    tp = sparse_problem_from_numpy(*(np.asarray(x) for x in jp))
    return jp, tp, np.array(pts), np.array(Rt), intr, grid


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def test_convert_and_jacobians_match():
    jp, tp, *_ = _both(drop=0.2)
    assert isinstance(tp, SparseBAProblem) and tp.cam_idx.dtype == torch.int64
    got = tsp._obs_jacobians(tp)
    want = jax.jit(jsp._obs_jacobians)(jp)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), w) < 1e-4
    np.testing.assert_allclose(float(tsp._cost(tp.cams, tp.points, tp.focal, tp)),
                               float(jsp._cost(jp.cams, jp.points, jp.focal, jp)), rtol=1e-5)
    np.testing.assert_allclose(float(tsp._cost(tp.cams, tp.points, tp.focal, tp, 3.0)),
                               float(jsp._cost(jp.cams, jp.points, jp.focal, jp, 3.0)), rtol=1e-5)


@pytest.mark.parametrize("cg,huber,tol", [(8, 0.0, 2e-3), (32, 0.0, 2e-2),
                                          (8, 3.0, 2e-3), (32, 3.0, 2e-2)])
def test_lm_step_matches(cg, huber, tol):
    jp, tp, *_ = _both(drop=0.2)
    want = jax.jit(lambda p: jsp._lm_step_sparse(p, jnp.float32(1e-3), True, cg, None, huber))(jp)
    got = tsp._lm_step_sparse(tp, torch.tensor(1e-3), True, cg, huber)
    for g, w, name in zip(got, want, ("d_c", "d_p", "d_f", "pred")):
        assert g.dtype == torch.float32, name
        assert _rel(g.numpy(), w) < (1e-4 if name == "pred" else tol), name
    # the float64 port is no nearer to either float32 solver than they are
    # to each other: the difference is round-off, not the algorithm
    tp64 = sparse_problem_from_numpy(*(np.asarray(x) for x in jp), dtype=torch.float64)
    ref = tsp._lm_step_sparse(tp64, torch.tensor(1e-3, dtype=torch.float64), True, cg, huber)
    assert ref[0].dtype == torch.float64
    assert _rel(got[0].numpy(), ref[0].numpy()) < tol
    assert _rel(np.asarray(want[0]), ref[0].numpy()) < tol


def test_sparse_ba_recovers_perturbation():
    jp, tp, pts, Rt, intr, _ = _both()
    jsol, jsum = jax.jit(lambda p: jsp.lm_solve_sparse(p, max_iterations=50))(jp)
    sol, summary = lm_solve_sparse(tp, max_iterations=50)
    c0 = float(jsum.initial_cost)
    np.testing.assert_allclose(float(summary.initial_cost), c0, rtol=1e-5)
    assert float(summary.final_cost) < c0 * 1e-3
    assert abs(float(summary.final_cost) - float(jsum.final_cost)) < 1e-3 * c0
    # both stop on the tolerance exit near the float32 noise floor, where the
    # iteration count depends on round-off; only the budget is shared
    assert 0 < int(summary.iterations) <= 50 and bool(summary.converged)
    assert int(jsum.iterations) <= 50 and bool(jsum.converged)
    # measured 1e-4 apart on this fixture
    assert np.abs(sol.points.numpy() - np.asarray(jsol.points)).max() < 1e-3 * SCENE_SCALE
    assert _fit_px(sol, tp, pts, Rt, intr) < 0.1


def _fit_px(sol, prob, pts, Rt, intr, skip=None):
    """Mean distance (px) between the solution's projections and the
    noiseless ground-truth projections, over the problem's observations."""
    K = torch.as_tensor(np.array(intr.K))
    R = tcam.rodrigues_to_matrix(sol.cams[:, :3].float())
    est = torch.cat([R, sol.cams[:, 3:, None].float()], 2)
    Kf = K.clone()
    Kf[0, 0] = Kf[1, 1] = sol.focal.float()
    ci, pi = prob.cam_idx, prob.pt_idx
    proj = tcam.project_points(est, Kf, sol.points.float()[None].expand(len(est), -1, -1))
    gt = tcam.project_points(torch.as_tensor(Rt), K,
                             torch.as_tensor(pts)[None].expand(len(est), -1, -1))
    err = torch.linalg.vector_norm(proj[ci, pi] - gt[ci, pi], dim=-1)
    if skip is not None:
        err = err[~torch.as_tensor(skip)]
    return float(err.mean())


def test_sparse_matches_dense_solution():
    """The port's COO solver and its dense-grid solver converge to the same
    optimum on the identical (partially observed) problem, as the two
    tpusfm solvers do."""
    jp, tp, pts, Rt, intr, (uv_grid, keep) = _both(drop=0.3, seed=2)
    V, N = Rt.shape[0], pts.shape[0]
    K = torch.as_tensor(np.array(intr.K))
    Rt_in = torch.cat([tcam.rodrigues_to_matrix(tp.cams[:, :3]), tp.cams[:, 3:, None]], 2)
    dense = adjust_bundle(Rt_in, torch.ones(V, dtype=torch.bool), tp.points,
                          torch.ones(N, dtype=torch.bool), torch.as_tensor(np.asarray(uv_grid)),
                          torch.as_tensor(keep), K, max_iterations=60)
    sparse = adjust_bundle_sparse(Rt_in, torch.ones(V, dtype=torch.bool), tp.points,
                                  tp.cam_idx.to(torch.int32), tp.pt_idx.to(torch.int32),
                                  tp.uv + K[:2, 2], tp.w, K, max_iterations=60)
    # both reach (near-)zero cost on this noiseless-observation problem; the
    # optima can differ by the BA gauge (a global similarity), so poses are
    # compared loosely and the shared focal by ratio (tests/test_ba_sparse.py)
    assert float(dense[3].final_cost) < 1e-2
    assert float(sparse[3].final_cost) < 1e-2
    np.testing.assert_allclose(sparse[0].numpy(), dense[0].numpy(), atol=2e-2)
    np.testing.assert_allclose(float(sparse[2][0, 0]), float(dense[2][0, 0]), rtol=1e-2)
    # and tpusfm's sparse solver lands on the same fit
    jout = jax.jit(lambda *a: jsp.adjust_bundle_sparse(*a, max_iterations=60))(
        jnp.asarray(Rt_in.numpy()), jnp.ones((V,), bool), jp.points, jp.cam_idx, jp.pt_idx,
        jp.uv + intr.pp[None, :], jp.w, intr.K)
    assert float(jout[3].final_cost) < 1e-2
    np.testing.assert_allclose(sparse[0].numpy(), np.asarray(jout[0]), atol=2e-2)


def test_sparse_frozen_camera_stays_fixed():
    jp, tp, *_ = _both()
    free = tp.cam_free.clone()
    free[1] = 0.0
    sol, _ = lm_solve_sparse(tp._replace(cam_free=free), max_iterations=20)
    assert torch.equal(sol.cams[1], tp.cams[1])               # bit-identical
    assert not torch.equal(sol.cams[0], tp.cams[0])
    # through the high-level entry too: the frozen pose comes back as given
    K = torch.tensor([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    Rt_in = torch.cat([tcam.rodrigues_to_matrix(tp.cams[:, :3]), tp.cams[:, 3:, None]], 2)
    valid = torch.tensor([True, False, True])
    out = adjust_bundle_sparse(Rt_in, valid, tp.points, tp.cam_idx, tp.pt_idx,
                               tp.uv + K[:2, 2], tp.w, K, max_iterations=5, share_focal=False)
    assert torch.equal(out[0][1], Rt_in[1]) and torch.equal(out[2], K)


def test_sparse_ba_scale_smoke():
    """Matrix-free path at a scale the dense grid could not touch: 64
    cameras x 20k points x 120k observations, three LM iterations; the
    port's cost trajectory follows tpusfm's."""
    rng = np.random.default_rng(0)
    V, N = 64, 20000
    f, pp = 800.0, np.array([320.0, 240.0])
    pts = np.stack([rng.uniform(-8, 8, N), rng.uniform(-6, 6, N),
                    rng.uniform(15, 40, N)], 1).astype(np.float32)
    cams = np.zeros((V, 6), np.float32)
    cams[:, 1] = 0.01 * np.arange(V)                         # small yaw
    cams[:, 3] = -0.05 * np.arange(V)
    cams[:, 5] = 1.0
    cidx = rng.integers(0, V, size=N * 6).astype(np.int32)
    pidx = np.repeat(np.arange(N, dtype=np.int32), 6)
    clean = sparse_problem_from_numpy(cams, pts, f, cidx, pidx, np.zeros((N * 6, 2)),
                                      np.ones(N * 6), np.ones(V))
    uv = tsp._all_residuals(clean.cams, clean.points, clean.focal, clean).numpy()
    fields = (cams + 0.002 * rng.standard_normal(cams.shape).astype(np.float32),
              pts + 0.01 * rng.standard_normal(pts.shape).astype(np.float32),
              np.float32(f), cidx, pidx, uv.astype(np.float32),
              np.ones(N * 6, np.float32), np.ones(V, np.float32))
    tp = sparse_problem_from_numpy(*fields)
    jp = jsp.SparseBAProblem(*(jnp.asarray(x) for x in fields))
    sol, summary = lm_solve_sparse(tp, max_iterations=3, cg_iterations=16)
    _, jsum = jax.jit(lambda p: jsp.lm_solve_sparse(p, max_iterations=3, cg_iterations=16))(jp)
    assert float(summary.final_cost) < float(summary.initial_cost)
    np.testing.assert_allclose(float(summary.initial_cost), float(jsum.initial_cost), rtol=1e-4)
    # three accepted steps from the same start: the costs agree to 1e-3 of
    # the initial cost
    assert abs(float(summary.final_cost) - float(jsum.final_cost)) \
        < 1e-3 * float(jsum.initial_cost)
    assert int(summary.iterations) == int(jsum.iterations) == 3


def test_sparse_huber_resists_gross_outliers():
    """A Huber (IRLS) solve lands near the clean optimum when a slice of the
    observations carries gross error, in the port as in tpusfm."""
    jp, tp, pts, Rt, intr, _ = _both(noise_cam=0.005, noise_pt=0.02)
    rng = np.random.default_rng(7)
    uv = tp.uv.numpy()
    n = len(uv)
    bad = rng.uniform(size=n) < 0.15
    uv_bad = (uv + np.where(bad[:, None], 40.0 + 20.0 * rng.standard_normal((n, 2)), 0.0)
              ).astype(np.float32)
    tp_bad = tp._replace(uv=torch.as_tensor(uv_bad))
    jp_bad = jp._replace(uv=jnp.asarray(uv_bad))

    sol_q, _ = lm_solve_sparse(tp_bad, max_iterations=60)
    sol_h, sum_h = lm_solve_sparse(tp_bad, max_iterations=60, huber_delta=3.0)
    e_huber = _fit_px(sol_h, tp, pts, Rt, intr, skip=bad)
    e_quad = _fit_px(sol_q, tp, pts, Rt, intr, skip=bad)
    # the bars of tests/test_ba_sparse.py (measured there ~5.5 vs ~27.5 px)
    assert e_huber < 8.0, e_huber
    assert e_huber < e_quad * 0.33, (e_huber, e_quad)
    # tpusfm's robust solve reaches the same robust cost (1e-3 of the initial)
    _, jsum = jax.jit(lambda p: jsp.lm_solve_sparse(p, max_iterations=60, huber_delta=3.0))(jp_bad)
    np.testing.assert_allclose(float(sum_h.initial_cost), float(jsum.initial_cost), rtol=1e-5)
    assert abs(float(sum_h.final_cost) - float(jsum.final_cost)) \
        < 1e-3 * float(jsum.initial_cost)

    # solve -> prune(> gate) -> re-solve, the pipeline's cycle: trimming at
    # the robust optimum and re-solving lands at the clean optimum
    sol_t, w_trim = sol_h, tp_bad.w.clone()
    for thr in (9.0, 4.5):
        r = tsp._all_residuals(sol_t.cams, sol_t.points, sol_t.focal, tp_bad)
        w_trim = w_trim * (torch.linalg.vector_norm(r, dim=1) < thr)
        sol_t, _ = lm_solve_sparse(tp_bad._replace(w=w_trim), max_iterations=60, huber_delta=3.0)
    assert (w_trim.numpy()[bad] == 0).mean() > 0.8
    e_trim = _fit_px(sol_t, tp, pts, Rt, intr, skip=bad)
    assert e_trim < 2.0, e_trim
    assert e_trim < e_huber, (e_trim, e_huber)


def test_huber_weights_from_reused_residual():
    """The LM step hands ``_huber_w`` the residual it already has; the
    weights equal the recomputed ones exactly, and tpusfm's to round-off."""
    jp, tp, *_ = _both(noise_cam=0.02, noise_pt=0.2)
    r = tsp._obs_jacobians(tp)[0]
    reused = tsp._huber_w(tp, 3.0, r)
    recomputed = tsp._huber_w(tp, 3.0)
    assert torch.equal(reused, recomputed)
    assert (reused < tp.w).any() and (reused == tp.w).any()
    assert tsp._huber_w(tp, 0.0, r) is tp.w
    np.testing.assert_allclose(reused.numpy(), np.asarray(jsp._huber_w(jp, 3.0)), rtol=1e-4)


def test_host_exit_and_frozen_loop_agree():
    """The sync-free LM loop (frozen once done) gives the early-exit result."""
    _, tp, *_ = _both()
    a, sa = lm_solve_sparse(tp, max_iterations=30, host_exit=True)
    b, sb = lm_solve_sparse(tp, max_iterations=30, host_exit=False)
    assert int(sa.iterations) == int(sb.iterations) < 30
    assert torch.equal(a.cams, b.cams) and torch.equal(a.points, b.points)
    assert torch.equal(sa.final_cost, sb.final_cost)


def test_segment_sums_equal_index_add():
    """The fixed-order segment sum equals ``index_add_`` (exactly in float64,
    to round-off in float32), lists each segment's rows in ascending order,
    and gives zero for a segment with no row."""
    rng = np.random.default_rng(5)
    size, O = 40, 3000
    index = torch.as_tensor(rng.integers(0, size - 3, O))          # segments 37..39 stay empty
    index[index == 11] = 12                                        # and one in the middle
    vals = torch.as_tensor(rng.standard_normal((O, 2, 3)))
    seg = tsp._Segments.build(index, size, torch.float64)
    want = torch.zeros(size, 2, 3, dtype=torch.float64).index_add_(0, index, vals)
    torch.testing.assert_close(seg.sum(vals), want, rtol=1e-12, atol=1e-12)
    assert (seg.sum(vals)[[11, 37, 38, 39]] == 0).all()
    rows = seg.idx[5][seg.mask[5, :, 0] > 0]
    assert (index[rows] == 5).all() and (rows[1:] > rows[:-1]).all()
    assert int(seg.mask.sum()) == O
    seg32 = tsp._Segments.build(index, size, torch.float32)
    torch.testing.assert_close(seg32.sum(vals.float()), want.float(), rtol=1e-5, atol=1e-5)
    assert torch.equal(seg32.sum(vals.float()), seg32.sum(vals.float()))


def _recorded(monkeypatch, solve):
    """``solve()``'s result and, per LM iteration, whether it accepted and
    whether the solve was done after it."""
    from tpusfm_torch.ba import lm as tlm

    seen, iteration = [], tlm.lm_iteration

    def recording(*a, **k):
        s = iteration(*a, **k)
        seen.append((bool(s.rejects == 0), bool(s.done)))
        return s

    monkeypatch.setattr(tlm, "lm_iteration", recording)
    out = solve()
    monkeypatch.setattr(tlm, "lm_iteration", iteration)
    return out, seen


@pytest.mark.parametrize("settings", ["local", "global"])
@pytest.mark.parametrize("n_pts,n_obs,longest_pt", [
    (255, 1023, 8), (256, 1024, 9), (257, 1025, 8), (257, 1023, 16), (256, 1025, 17)])
def test_padded_solve_takes_the_unpadded_path(monkeypatch, n_pts, n_obs, longest_pt, settings):
    """Sizes on both sides of the bucket edges (points 256, observations
    1024, the longest camera segment 128, the longest point segment at and
    past a power of two): the problem padded to its buckets and solved
    eagerly accepts and rejects as the unpadded solve does, iteration by
    iteration, and ends within float32 rounding of it. No pad row enters a
    segment, and the pad points come back as they went in."""
    kw = LOCAL if settings == "local" else GLOBAL
    prob = sized_problem(n_pts, n_obs, longest_pt)
    (want, want_sum), want_seq = _recorded(monkeypatch, lambda: lm_solve_sparse(prob, **kw))
    (padded, segments, buckets, got, got_sum), got_seq = _recorded(
        monkeypatch, lambda: padded_solve(prob, kw))
    n_b, o_b = buckets[1], buckets[2]
    lc = -(-n_obs // 8)
    assert buckets == (8, 256 if n_pts <= 256 else 512, 1024 if n_obs <= 1024 else 2048,
                       128 if lc <= 128 else 256, 8 if longest_pt <= 8 else
                       16 if longest_pt <= 16 else 32)
    assert padded.points.shape[0] == n_b and padded.cam_idx.shape[0] == o_b
    assert (padded.w[n_obs:] == 0).all()
    for seg in segments:
        real = seg.mask[..., 0] > 0
        assert (seg.idx[real] < n_obs).all() and int(real.sum()) == n_obs
    assert not (segments[1].mask[n_pts:] > 0).any()

    assert len(want_seq) == int(want_sum.iterations) > 2
    assert got_seq == want_seq and int(got_sum.iterations) == int(want_sum.iterations)
    assert bool(got_sum.converged) == bool(want_sum.converged)
    assert float(want_sum.final_cost) < 0.5 * float(want_sum.initial_cost)
    for g, w in ((got_sum.initial_cost, want_sum.initial_cost),
                 (got_sum.final_cost, want_sum.final_cost)):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    torch.testing.assert_close(got.cams, want.cams, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.points[:n_pts], want.points, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.focal, want.focal, rtol=0, atol=1e-4)
    assert torch.equal(got.points[n_pts:], padded.points[n_pts:])


@pytest.mark.parametrize("settings", ["local", "global"])
def test_a_problem_that_fills_its_buckets_solves_bit_for_bit(settings):
    """At 256 points, 1024 observations, 128 observations a camera and 8 for
    the longest point nothing is padded: the bucketed solve is the plain one."""
    kw = LOCAL if settings == "local" else GLOBAL
    prob = sized_problem(256, 1024, 8)
    padded, segments, buckets, got, got_sum = padded_solve(prob, kw)
    want, want_sum = lm_solve_sparse(prob, **kw)
    assert buckets == (8, 256, 1024, 128, 8)
    assert all(torch.equal(a, b) for a, b in zip(padded, prob))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got_sum, want_sum))


def test_nothing_is_captured_off_cuda_or_with_a_group(monkeypatch):
    """The solve replays only on CUDA and outside a process group: on the
    CPU, alone and as the one shard of a gloo world of one, it runs eagerly
    on the problem as given and reaches neither the graph cache nor the
    bucketing."""
    import torch.distributed as dist

    from tpusfm_torch.dist import make_mesh

    assert tsp._replays(torch.device("cuda"), None)
    assert not tsp._replays(torch.device("cuda", 1), object())
    assert not tsp._replays(torch.device("cpu"), None)
    reached = []
    for name in ("_bucketed", "_solve_replayed"):
        monkeypatch.setattr(tsp, name, lambda *a, _n=name, **k: reached.append(_n))
    monkeypatch.setattr(tsp._LM_GRAPHS, "get", lambda *a: reached.append("get"))
    prob = sized_problem(255, 1023, 8)
    alone = lm_solve_sparse(prob, **LOCAL)
    mesh = make_mesh(device="cpu")
    try:
        shard = lm_solve_sparse(prob, group=mesh.group, **LOCAL)
    finally:
        dist.destroy_process_group()
    assert reached == []
    assert all(torch.equal(a, b) for a, b in zip(alone[0], shard[0]))
    assert int(alone[1].iterations) == int(shard[1].iterations) > 0


class _EagerGraph:
    """``utils/cuda_graph.Graph``'s protocol without a card: one eager run of
    the body over its buffers at construction (as before a capture), then
    one eager run per replay."""

    built = 0

    def __init__(self, body, buffers, span, generator=None):
        _EagerGraph.built += 1
        self.body, self.buffers = body, tuple(buffers)
        body(*self.buffers)

    def load(self, *values):
        for buf, x in zip(self.buffers, values):
            buf.copy_(x)

    def replay(self, seed=None):
        return self.body(*self.buffers)


@pytest.mark.parametrize("settings", ["local", "global"])
def test_the_replayed_solve_chains_its_buffers(monkeypatch, settings):
    """``_solve_replayed`` on the CPU with the graph's body run eagerly at
    each replay: two problems of one bucket through one cached body each
    give the eager solve of their padded problem bit for bit, the first
    result untouched by the second solve."""
    kw = LOCAL if settings == "local" else GLOBAL
    monkeypatch.setattr(tsp, "Graph", _EagerGraph)
    monkeypatch.setattr(tsp, "_LM_GRAPHS", tsp.GraphCache(2))
    _EagerGraph.built = 0
    st = tsp._Settings(kw["share_focal"], kw["cg_iterations"], kw.get("huber_delta", 0.0),
                       kw["function_tolerance"])
    run = dict(max_iterations=kw["max_iterations"], initial_lambda=1e-3, host_exit=True)
    probs = [sized_problem(250, 1000, 8, seed=1), sized_problem(240, 990, 7, seed=2)]
    got = [tsp._solve_replayed(p, st, **run) for p in probs]
    for p, (sol, summary) in zip(probs, got):
        *_, want, want_sum = padded_solve(p, kw)
        assert torch.equal(sol.cams, want.cams) and torch.equal(sol.focal, want.focal)
        assert torch.equal(sol.points, want.points[:p.points.shape[0]])
        assert all(torch.equal(a, b) for a, b in zip(summary, want_sum))
    assert _EagerGraph.built == 1 and len(tsp._LM_GRAPHS.graphs) == 1
    assert not torch.equal(got[0][0].points[:240], got[1][0].points)
