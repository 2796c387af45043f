"""Sparse (observation-list) Levenberg-Marquardt bundle adjustment.

Counterpart of ``tpusfm/ba/sparse.py``. The dense-grid solver
(``ba/lm.py``) mirrors the (N, V) track table and suits the incremental
pipeline's sizes; its (V,6,V,6) Schur cross-term and (N,V)-grid Jacobians
are dead weight at collection scale. Here

  observations are a COO list (cam_idx, pt_idx, uv) of length O;
  per-observation residuals and Jacobians come from one batched call
  (``torch.func.jvp`` over the 10 parameter directions of an observation:
  6 camera, 3 point, 1 focal — what ``jax.jacfwd`` under ``vmap`` computes);
  all block sums are segment reductions, as padded gathers summed in a
  fixed order (see ``_Segments``: ``index_add_`` adds with atomics in no
  fixed order on CUDA, and two runs of one solve then end apart);
  the reduced camera system S = U - W C^-1 W^T is never materialised: a
  matrix-free preconditioned CG solves it with implicit matvecs that are
  two gathers and two segment sums per application, so cost scales with O.

The CG loop runs a fixed count of iterations with every decision kept on
the device (``torch.where``), so it never syncs with the host whatever
``cg_iterations`` is; the block-Jacobi preconditioner inverts its (V,6,6)
blocks with ``inv_ex``, which reads no error flag back. The LM loop is
``ba/lm.py``'s loop (``lm_run``): it reads ``done`` once per iteration
(``host_exit=True``) or not at all; under a profiler each iteration that
runs is one ``sfm.sparse.lm_iter`` span, opened after that read so the sync
falls in the caller's span.

Building the segment tables reads two counts back, once per solve (and
``bincount`` on CUDA reads its input's range back); the replayed path below
reads one pair of counts back and nothing else.

On CUDA, without ``group``, each LM iteration is one replay of a CUDA graph
(``_solve_replayed``) through the port's graph runner
(``utils/cuda_graph.py``). Shapes change with every solve, so the problem
is padded to power-of-two buckets of points and observations
(``_bucketed``, tpusfm's buckets for its collection solves) and the segment
tables to power-of-two widths; one graph per bucket and settings is
captured on its first use in the process and kept in ``_LM_GRAPHS``. An
eager iteration launches about 1,900 kernels (at 32 CG iterations), each
one costing the host more than the card. The replayed solve equals the
eager solve of the padded problem bit for bit; the padding changes the
length of the plain sums over the observations, so against the unpadded
solve it agrees to float32 round-off.

``group`` (a ``torch.distributed`` process group; tpusfm's ``axis_name``)
makes the solve one shard of a distributed one (``dist/sparse_ba.py``):
each point and all of its observations live on one rank, the cameras are
replicated. The sums into the camera blocks and the focal are summed over
the ranks by ``all_reduce``, packed into one buffer per site (one per CG
matvec); the point-side sums stay local, and so do the fixed-order segment
sums within each shard.

Reference parity: the residual model and the writeback semantics match
``ba/lm.py`` (SfMBundleAdjustmentUtils.cpp:99-222), whose LM loop this is;
only the linear-algebra layout differs.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpusfm_torch import camera
from tpusfm_torch.ba.lm import (_EPS, BASummary, LMState, all_reduce_sum, lm_iteration, lm_loop,
                                lm_run, lm_start)
from tpusfm_torch.geometry.triangulation import inv3x3
from tpusfm_torch.utils.cuda_graph import Graph, GraphCache, graph_key, pow2


class _Segments(NamedTuple):
    """A segment sum with a fixed order of addition: row s of ``idx`` lists
    the observations of segment s (a camera, or a point) in ascending order,
    padded to the longest segment; ``mask`` (S, L, 1) is 1.0 on real slots.

    ``zeros.index_add_(0, index, vals)`` computes the same sums, but on CUDA
    with atomic adds in whatever order the threads arrive: two runs of one
    200-iteration solve then differ (cost in the sixth digit, a weakly
    constrained point by units), and the reconstruction after it with them."""

    idx: torch.Tensor
    mask: torch.Tensor

    @staticmethod
    def build(index: torch.Tensor, size: int, dtype, longest: int | None = None,
              counts: torch.Tensor | None = None) -> "_Segments":
        """The table of ``size`` segments of ``index``, ``longest`` slots wide
        (at least the longest segment; by default exactly that, read back).
        ``counts``, if given, are the segments' lengths."""
        order = torch.argsort(index, stable=True)
        if counts is None:
            counts = torch.bincount(index, minlength=size)
        if longest is None:
            longest = max(int(counts.max()), 1)              # one read-back
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(longest, device=index.device)
        real = slot < counts[:, None]                        # (S, L)
        idx = order[torch.where(real, starts[:, None] + slot, 0)]
        return _Segments(idx=idx, mask=real[:, :, None].to(dtype))

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        """vals (O, ...) -> (S, ...): the sum of each segment's rows."""
        S, L = self.idx.shape
        g = vals[self.idx].reshape(S, L, -1)
        return (g * self.mask).sum(1).reshape(S, *vals.shape[1:])


class SparseBAProblem(NamedTuple):
    cams: torch.Tensor      # (V, 6) angle-axis + translation
    points: torch.Tensor    # (N, 3)
    focal: torch.Tensor     # () shared focal
    cam_idx: torch.Tensor   # (O,) int64
    pt_idx: torch.Tensor    # (O,) int64
    uv: torch.Tensor        # (O, 2) pixel coords, principal point subtracted
    w: torch.Tensor         # (O,) observation weights (0 = padding)
    cam_free: torch.Tensor  # (V,) 1.0 for optimizable cameras


def _residual_obs(cam, X, focal, uv) -> torch.Tensor:
    """Reference BA residual of each observation
    (SfMBundleAdjustmentUtils.cpp:58-97). cam (O, 6), X (O, 3), focal () or
    (1,), uv (O, 2) -> (O, 2)."""
    p = camera.rotate_angle_axis(cam[:, :3], X) + cam[:, 3:]
    z = p[:, 2:3]
    zsafe = torch.where(z.abs() < 1e-8, torch.where(z < 0, -1e-8, 1e-8), z)
    return p[:, :2] / zsafe * focal - uv


def _all_residuals(cams, points, focal, prob: SparseBAProblem) -> torch.Tensor:
    return _residual_obs(cams[prob.cam_idx], points[prob.pt_idx], focal, prob.uv)


def _cost(cams, points, focal, prob: SparseBAProblem, huber_delta: float = 0.0,
          group=None) -> torch.Tensor:
    r = _all_residuals(cams, points, focal, prob)
    if huber_delta <= 0.0:
        return all_reduce_sum(group, 0.5 * (prob.w[:, None] * r * r).sum())[0]
    # robust cost over the 2D residual norm: rho(e) = e^2/2 for e <= d,
    # d*(e - d/2) beyond — large residuals (e.g. loop-closure observations
    # under drifted poses) keep pulling linearly instead of dominating
    # quadratically or being discarded
    e2 = (r * r).sum(1)
    e = torch.sqrt(e2 + _EPS)
    rho = torch.where(e <= huber_delta, 0.5 * e2, huber_delta * (e - 0.5 * huber_delta))
    return all_reduce_sum(group, (prob.w * rho).sum())[0]


def _huber_w(prob: SparseBAProblem, huber_delta: float, r: torch.Tensor | None = None):
    """IRLS weights at the current state: w * min(1, delta/||r||). ``r`` is
    the residual at that state when the caller already has it (the weights
    are then bit for bit those of the recomputed residual)."""
    if huber_delta <= 0.0:
        return prob.w
    if r is None:
        r = _all_residuals(prob.cams, prob.points, prob.focal, prob)
    e = torch.sqrt((r * r).sum(1) + _EPS)
    return prob.w * torch.clamp(huber_delta / e, max=1.0)


def _obs_jacobians(prob: SparseBAProblem):
    """Per-observation residual + Jacobians: r (O,2), Jc (O,2,6),
    Jp (O,2,3), Jf (O,2)."""
    cam = prob.cams[prob.cam_idx]
    X = prob.points[prob.pt_idx]
    # a 0-d dual under vmap promotes float32 to float64 on ops with Python
    # scalars; the focal goes in as one element
    focal = prob.focal.reshape(1)
    f = lambda c, x, fo: _residual_obs(c, x, fo, prob.uv)
    r = f(cam, X, focal)
    basis = torch.eye(10, dtype=r.dtype, device=r.device)
    O = cam.shape[0]

    def jvp_k(e):
        return torch.func.jvp(f, (cam, X, focal),
                              (e[:6].expand(O, 6), e[6:9].expand(O, 3), e[9:10]))[1]

    J = torch.func.vmap(jvp_k)(basis).movedim(0, -1)        # (O, 2, 10)
    # contiguous blocks: the CG loop reads them once per matvec
    return r, J[..., :6].contiguous(), J[..., 6:9].contiguous(), J[..., 9].contiguous()


def _pcg(matvec, precond, b_c, b_f, iters: int, with_focal: bool = True):
    """Preconditioned CG on the (camera blocks, focal) pair, ``iters`` fixed
    iterations, no host sync. Without ``with_focal`` the focal entry is a
    constant zero (its right-hand side is) and its arithmetic is left out."""

    def dot(a, b):
        d = torch.dot(a[0].reshape(-1), b[0].reshape(-1))
        return d + a[1] * b[1] if with_focal else d

    def axpy(y, a, x, sign=1.0):
        """(y[0] + sign * a * x[0], y[1] + sign * a * x[1])"""
        return (torch.addcmul(y[0], a, x[0], value=sign),
                torch.addcmul(y[1], a, x[1], value=sign) if with_focal else y[1])

    x = (torch.zeros_like(b_c), torch.zeros_like(b_f))
    r = (b_c, b_f)
    z = precond(r)
    p = z
    rz = dot(r, z)
    for _ in range(iters):
        Ap = matvec(p)
        denom = dot(p, Ap)
        alpha = torch.where(denom.abs() > 1e-30, rz / denom, 0.0)
        x = axpy(x, alpha, p)
        r = axpy(r, alpha, Ap, -1.0)
        z = precond(r)
        rz_new = dot(r, z)
        beta = torch.where(rz.abs() > 1e-30, rz_new / rz, 0.0)
        p = axpy(z, beta, p)
        rz = rz_new
    return x


def _lm_step_sparse(prob: SparseBAProblem, lam, share_focal: bool, cg_iterations: int,
                    huber_delta: float = 0.0, segments=None, group=None):
    """One damped Schur solve with implicit (matrix-free) camera system.
    ``segments`` is the (camera, point) pair of ``_Segments`` of the problem's
    index lists, built here when the caller has none. With ``group`` the sums
    into the cameras and the focal span the shards (module docstring).
    Returns (d_cams, d_points, d_focal, predicted decrease)."""
    if segments is None:
        segments = _problem_segments(prob)
    seg_cam, seg_pt = segments[0].sum, segments[1].sum
    r, Jc, Jp, Jf = _obs_jacobians(prob)
    # IRLS: the robust loss enters as per-observation reweighting of the
    # Gauss-Newton system, recomputed at every LM step [Triggs'00 §3.3]
    w = _huber_w(prob, huber_delta, r)
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    wJf = Jf * w[:, None]
    ci, pi = prob.cam_idx, prob.pt_idx

    def JT(J, t):
        """sum_i J[o, i, a] t[o, i] -> (O, a)"""
        return (J * t[:, :, None]).sum(1)

    def Jx(J, x):
        """sum_a J[o, i, a] x[o, a] -> (O, i); also a batched matrix-vector product"""
        return (J * x[:, None, :]).sum(2)

    def outer(A, B):
        """sum_i A[o, i, a] B[o, i, b] -> (O, a, b)"""
        return (A[:, :, :, None] * B[:, :, None, :]).sum(1)

    # diagonal blocks + gradients
    U, b_c, Uff, b_f = all_reduce_sum(group, seg_cam(outer(wJc, Jc)),   # (V,6,6)
                                      seg_cam(JT(wJc, r)),                # (V,6)
                                      (wJf * Jf).sum(), (wJf * r).sum())
    Udiag = U.diagonal(dim1=1, dim2=2)                          # (V,6)
    C = seg_pt(outer(wJp, Jp))                                  # (N,3,3)
    b_p = seg_pt(JT(wJp, r))                                    # (N,3)

    eye3 = torch.eye(3, dtype=C.dtype, device=C.device)
    Cd = C + lam * (C * eye3) + 1e-8 * eye3
    Cinv = inv3x3(Cd, _EPS)

    free = prob.cam_free[:, None]                               # (V,1)
    is_free = free > 0
    not_free = 1.0 - free
    f_free = 1.0 if share_focal else 0.0
    damp_c = lam * Udiag + 1e-8
    damp_f = lam * Uff + 1e-8

    # With the focal fixed its entry of every CG vector is exactly zero (the
    # right-hand side's is, and a frozen row acts as identity), so the focal
    # terms are left out of the matvec instead of being multiplied by zero.
    def matvec(x):
        xc = x[0] * free
        t = Jx(Jc, xc[ci])                                      # (O,2)
        if share_focal:
            t = t + Jf * x[1]
        # subtract W C^-1 W^T x (the Schur correction)
        y = seg_pt(JT(wJp, t))                                  # (N,3)
        t = t - Jx(Jp, Jx(Cinv, y)[pi])                         # (O,2)
        # one all_reduce per matvec: the camera blocks and the focal together
        sums = all_reduce_sum(group, seg_cam(JT(wJc, t)),
                              *([(wJf * t).sum()] if share_focal else []))
        a_c = torch.addcmul(sums[0], damp_c, xc)
        # frozen rows act as identity so CG stays SPD
        a_c = torch.where(is_free, a_c, x[0])
        return a_c, (sums[1] + damp_f * x[1] if share_focal else x[1])

    # block-Jacobi preconditioner on the damped camera blocks
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    Ud = U + lam * (U * eye6) + 1e-6 * eye6
    Pc = torch.linalg.inv_ex(Ud)[0]                             # (V,6,6)
    Pf = 1.0 / torch.clamp(lam * Uff + Uff + 1e-8, min=1e-8)

    def precond(rr):
        rc, rf = rr
        return (torch.addcmul(Jx(Pc, rc) * free, rc, not_free),
                rf * Pf if share_focal else rf)

    # Schur RHS
    z0 = Jx(Cinv, b_p)
    s0 = Jx(Jp, z0[pi])
    s0_c, s0_f = all_reduce_sum(group, seg_cam(JT(wJc, s0)), (wJf * s0).sum())
    rhs_c = (b_c - s0_c) * free
    rhs_f = (b_f - s0_f) * f_free

    d_c, d_f = _pcg(matvec, precond, rhs_c, rhs_f, cg_iterations, with_focal=share_focal)
    d_c = d_c * free
    d_f = d_f * f_free

    # point back-substitution
    t = Jx(Jc, d_c[ci]) + Jf * d_f
    y = seg_pt(JT(wJp, t))
    d_p = Jx(Cinv, b_p - y)
    d_c = torch.where(torch.isfinite(d_c), d_c, 0.0)
    d_p = torch.where(torch.isfinite(d_p), d_p, 0.0)
    d_f = torch.where(torch.isfinite(d_f), d_f, 0.0)

    # predicted decrease for the LM gain ratio (x <- x - delta):
    # 0.5 * delta^T (lam D delta + g)
    Cdiag = C.diagonal(dim1=1, dim2=2)
    pred_cam = 0.5 * ((d_c * (lam * Udiag * d_c + b_c)).sum() + d_f * (lam * Uff * d_f + b_f))
    pred_pt = all_reduce_sum(group, 0.5 * (d_p * (lam * Cdiag * d_p + b_p)).sum())[0]
    return d_c, d_p, d_f, pred_cam + pred_pt


def _problem_segments(prob: SparseBAProblem):
    dt = prob.cams.dtype
    return (_Segments.build(prob.cam_idx.long(), prob.cams.shape[0], dt),
            _Segments.build(prob.pt_idx.long(), prob.points.shape[0], dt))


_FIELDS = ("cams", "points", "focal")
_SPAN = "sfm.sparse.lm_iter"


class _Settings(NamedTuple):
    """What a solve's iterations bake in beside its shapes."""
    share_focal: bool
    cg_iterations: int
    huber_delta: float
    function_tolerance: float


def _step_and_cost(segments, st: _Settings, group=None):
    """The (step, cost) pair of ``lm_loop`` over a problem with ``segments``."""
    return (lambda p, lam: _lm_step_sparse(p, lam, st.share_focal, st.cg_iterations,
                                           st.huber_delta, segments, group),
            lambda p: _cost(p.cams, p.points, p.focal, p, st.huber_delta, group))


def _solve_eager(prob: SparseBAProblem, segments, st: _Settings, *, max_iterations: int,
                 initial_lambda: float, host_exit: bool, group=None):
    """``lm_loop`` over ``prob`` with ``segments``: the solve off CUDA or
    with ``group``, and the reference of the replayed one."""
    return lm_loop(prob, *_step_and_cost(segments, st, group), _FIELDS, span=_SPAN,
                   max_iterations=max_iterations, function_tolerance=st.function_tolerance,
                   initial_lambda=initial_lambda, host_exit=host_exit)


def _bucketed(prob: SparseBAProblem):
    """``prob`` padded to its buckets: the points to ``pow2(N, 256)`` (zero
    points with no observation), the observations to ``pow2(O, 1024)`` (pad
    rows repeat observation 0 at weight 0, so their residuals and Jacobians
    are finite and every plain sum over the rows adds an exact 0). The
    segment tables hold the real rows only, the longest camera and point
    segments each widened to a power of two: a pad point's segment is
    empty, so its update is exactly 0. Returns (padded problem, segments,
    (V, N, O, camera slots, point slots) of the buckets)."""
    V, N, O = prob.cams.shape[0], prob.points.shape[0], prob.cam_idx.shape[0]
    n_b, o_b = pow2(N, 256), pow2(O, 1024)
    # exact integer counts; ``bincount`` on CUDA reads its input's range back
    counts = [torch.zeros(size, dtype=torch.int64, device=index.device)
              .index_add_(0, index, torch.ones_like(index))
              for index, size in ((prob.cam_idx, V), (prob.pt_idx, n_b))]
    longest = torch.stack([c.max() for c in counts]).tolist()   # one read-back per solve
    lc, lp = (pow2(max(x, 1), 1) for x in longest)
    rows = lambda x: torch.cat([x, x[:1].expand(o_b - O, *x.shape[1:])])
    padded = prob._replace(
        points=torch.cat([prob.points, prob.points.new_zeros(n_b - N, 3)]),
        cam_idx=rows(prob.cam_idx), pt_idx=rows(prob.pt_idx), uv=rows(prob.uv),
        w=torch.cat([prob.w, prob.w.new_zeros(o_b - O)]))
    dt = prob.cams.dtype
    segments = (_Segments.build(prob.cam_idx, V, dt, lc, counts[0]),
                _Segments.build(prob.pt_idx, n_b, dt, lp, counts[1]))
    return padded, segments, (V, n_b, o_b, lc, lp)


# The replayed LM iterations by bucket and settings (``_solve_replayed``).
# A 56-view ring500 job makes 12-13 keys, three such jobs of two scenes 21
# (on an H100); 32 holds every key of a process's jobs of that size, so no
# key is captured twice.
_LM_GRAPHS = GraphCache(32)


def _state_tensors(s: LMState) -> tuple:
    return (s.p.cams, s.p.points, s.p.focal, *s[1:])


def _replayed_iteration(st: _Settings, *buffers):
    """The body of a COO LM graph: one ``lm_iteration`` over the buffers
    (the state's nine tensors, then the padded problem's index lists, uv,
    weights, free cameras and both segment tables), its next state written
    back into the state's buffers, so that replays chain."""
    (cams, points, focal, lam, nu, done, rejects, cost, it,
     cam_idx, pt_idx, uv, w, cam_free, c_idx, c_mask, p_idx, p_mask) = buffers
    prob = SparseBAProblem(cams, points, focal, cam_idx, pt_idx, uv, w, cam_free)
    step, cost_of = _step_and_cost((_Segments(c_idx, c_mask), _Segments(p_idx, p_mask)), st)
    nxt = lm_iteration(LMState(prob, lam, nu, done, rejects, cost, it), step, cost_of, _FIELDS,
                       st.function_tolerance)
    for buf, x in zip(buffers, _state_tensors(nxt)):
        buf.copy_(x)


def _solve_replayed(prob: SparseBAProblem, st: _Settings, *, max_iterations: int,
                    initial_lambda: float, host_exit: bool):
    """The solve on CUDA: ``prob`` padded to its buckets (``_bucketed``),
    each iteration one replay of the bucket's graph of
    ``_replayed_iteration``, captured on its first use in the process inside
    a span ``sfm.sparse.lm_capture``. The loop, its host-exit read and its
    spans are ``lm_run``'s, as in the eager solve. Returns the solution and
    summary as tensors of their own, the points cut back to N."""
    padded, segments, buckets = _bucketed(prob)
    s0 = lm_start(padded, _step_and_cost(segments, st)[1], initial_lambda)
    inputs = (*_state_tensors(s0), padded.cam_idx, padded.pt_idx, padded.uv, padded.w,
              padded.cam_free, *segments[0], *segments[1])
    key = graph_key(prob.cams.device, "sparse_lm", *buckets, *st, prob.cams.dtype)
    graph = _LM_GRAPHS.get(key, lambda: Graph(
        functools.partial(_replayed_iteration, st), [x.clone() for x in inputs],
        "sfm.sparse.lm_capture"))
    graph.load(*inputs)          # the capture's eager run moved the buffers
    b = graph.buffers
    s = LMState(padded._replace(cams=b[0], points=b[1], focal=b[2]), *b[3:9])

    def advance(s):
        graph.replay()
        return s

    s = lm_run(s, advance, span=_SPAN, max_iterations=max_iterations, host_exit=host_exit)
    sol = prob._replace(cams=s.p.cams.clone(), points=s.p.points[:prob.points.shape[0]].clone(),
                        focal=s.p.focal.clone())
    return sol, BASummary(initial_cost=s0.cost, final_cost=s.cost.clone(),
                          iterations=s.it.clone(), converged=s.done.clone())


def lm_solve_sparse(prob: SparseBAProblem, *, max_iterations: int = 50,
                    function_tolerance: float = 1e-6, initial_lambda: float = 1e-3,
                    share_focal: bool = True, cg_iterations: int = 32,
                    huber_delta: float = 0.0, host_exit: bool = True, group=None):
    """LM loop over the sparse problem — ``ba/lm.py``'s loop, the
    accept/reject and termination semantics of ``lm_solve``. huber_delta > 0
    turns on a Huber robust loss (IRLS reweighting) at that pixel scale.
    ``host_exit`` reads ``done`` once per iteration to stop early; without it
    a finished solve is frozen by ``torch.where`` and the loop never syncs.
    ``group``: this rank's points and observations are one shard of the
    problem (module docstring). On CUDA without ``group`` each iteration is
    a replay of a CUDA graph (``_solve_replayed``); otherwise the solve runs
    eagerly on the problem as given."""
    prob = prob._replace(cam_idx=prob.cam_idx.long(), pt_idx=prob.pt_idx.long())
    st = _Settings(share_focal, cg_iterations, huber_delta, function_tolerance)
    kw = dict(max_iterations=max_iterations, initial_lambda=initial_lambda, host_exit=host_exit)
    if _replays(prob.cams.device, group):
        return _solve_replayed(prob, st, **kw)
    return _solve_eager(prob, _problem_segments(prob), st, group=group, **kw)


def _replays(device: torch.device, group) -> bool:
    """Whether ``lm_solve_sparse`` replays the iterations: on CUDA, and not
    as a shard, whose step sums over the ranks inside the iteration."""
    return group is None and device.type == "cuda"


def adjust_bundle_sparse(poses_Rt, cam_valid, points, cam_idx, pt_idx, uv, obs_w, K, *,
                         max_iterations: int = 50, function_tolerance: float = 1e-6,
                         initial_lambda: float = 1e-3, share_focal: bool = True,
                         cg_iterations: int = 32, huber_delta: float = 0.0):
    """High-level sparse BA with the adjustBundle API shape
    (SfMBundleAdjustmentUtils.h:35-50) over a COO observation list:
    poses (V,3,4), cam_valid (V,) bool, points (N,3), cam_idx/pt_idx (O,),
    raw pixel uv (O,2), weights (O,) (0 = padding), K (3,3) ->
    (poses, points, K, summary)."""
    rvecs = camera.matrix_to_rodrigues(poses_Rt[..., :3])
    cams = torch.cat([rvecs, poses_Rt[..., 3]], 1)
    prob = SparseBAProblem(
        cams=cams, points=points, focal=K[0, 0], cam_idx=cam_idx, pt_idx=pt_idx,
        uv=uv - K[:2, 2], w=obs_w.to(points.dtype), cam_free=cam_valid.to(points.dtype))
    sol, summary = lm_solve_sparse(
        prob, max_iterations=max_iterations, function_tolerance=function_tolerance,
        initial_lambda=initial_lambda, share_focal=share_focal,
        cg_iterations=cg_iterations, huber_delta=huber_delta)
    R = camera.rodrigues_to_matrix(sol.cams[:, :3])
    out_Rt = torch.cat([R, sol.cams[:, 3:, None]], 2)
    out_Rt = torch.where(cam_valid[:, None, None], out_Rt, poses_Rt)
    newK = K.clone()
    newK[0, 0] = sol.focal
    newK[1, 1] = sol.focal
    return out_Rt, sol.points, newK, summary
