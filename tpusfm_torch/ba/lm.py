"""Levenberg-Marquardt bundle adjustment with dense Schur complement.

Counterpart of ``tpusfm/ba/lm.py``. Layout: cameras
(V, 6) angle-axis + translation, points (N, 3), one shared focal, and a
dense (N, V) observation grid — the engine's track-graph layout. The 3x3
point blocks are eliminated in closed form and the reduced (6V+3)
camera+intrinsics system is Jacobi-rescaled and solved by CG.

Jacobians are forward-mode (``torch.func.jvp`` over the 10 parameter
directions of one observation: 6 camera, 3 point, 1 focal), which is
what ``jax.jacfwd`` under ``vmap`` computes.

The LM loop (``lm_loop``, shared with ``ba/sparse.py``'s COO solver) keeps
every decision on the device: a finished solve freezes its state with
``torch.where``. ``host_exit=True`` additionally reads the ``done`` flag
once per iteration to stop early (one host sync per LM iteration); with
``host_exit=False`` the loop runs ``max_iterations`` frozen-or-live
iterations and never syncs. An iteration is one function of the loop's
state (``lm_iteration`` over an ``LMState``), and ``lm_run`` runs the
loop over any way of advancing it: here it is called eagerly, and
``ba/sparse.py`` on CUDA replays it from a CUDA graph.

``group`` (a ``torch.distributed`` process group; tpusfm's ``axis_name``)
makes the solve one shard of a distributed one (``dist/ba.py``): the point
axis is split over the ranks, the cameras are replicated, and what tpusfm
``psum``s is summed by ``all_reduce`` — the cost, the reduced camera system
and its Schur terms (one buffer each) and the points' share of the
predicted decrease. Every rank then holds bit-identical sums, so the
``done`` flag that ``host_exit`` reads agrees on every rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from tpusfm_torch import camera
from tpusfm_torch.geometry.triangulation import inv3x3
from tpusfm_torch.utils.profiling import stage

_EPS = 1e-12


class BAProblem(NamedTuple):
    cams: torch.Tensor       # (V, 6)
    points: torch.Tensor     # (N, 3)
    focal: torch.Tensor      # ()
    uv: torch.Tensor         # (N, V, 2) pixel coords, principal point subtracted
    mask: torch.Tensor       # (N, V) bool
    cam_valid: torch.Tensor  # (V,) bool
    pt_valid: torch.Tensor   # (N,) bool
    pp_delta: torch.Tensor | None = None


class BASummary(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor


def all_reduce_sum(group, *tensors) -> list:
    """The sums of ``tensors`` over the ranks of ``group``, packed into one
    buffer for a single ``all_reduce``; the tensors as they are when ``group``
    is None."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [part.reshape(t.shape)
            for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def _residuals(cams, points, focal, uv, pp_delta) -> torch.Tensor:
    """Reference residual over the (N, V) grid: angle-axis rotate, translate,
    perspective divide, scale by the shared focal, minus uv."""
    p = camera.rotate_angle_axis(cams[None, :, :3], points[:, None, :]) + cams[None, :, 3:]
    z = p[..., 2:3]
    zsafe = torch.where(z.abs() < 1e-8, torch.where(z < 0, -1e-8, 1e-8), z)
    proj = p[..., :2] / zsafe * focal
    if pp_delta is not None:
        proj = proj + pp_delta
    return proj - uv


def _weights(prob: BAProblem, dtype) -> torch.Tensor:
    return (prob.mask & prob.pt_valid[:, None] & prob.cam_valid[None, :]).to(dtype)


def _residuals_and_jacobians(prob: BAProblem):
    """r (N,V,2), Jc (N,V,2,6), Jp (N,V,2,3), Jg (N,V,2,3), w (N,V)."""
    f = lambda c, x, fo: _residuals(c, x, fo, prob.uv, prob.pp_delta)
    r = f(prob.cams, prob.points, prob.focal)
    basis = torch.eye(10, dtype=r.dtype, device=r.device)
    V, N = prob.cams.shape[0], prob.points.shape[0]

    def jvp_k(e):
        tc = e[:6].expand(V, 6)
        tp = e[6:9].expand(N, 3)
        return torch.func.jvp(f, (prob.cams, prob.points, prob.focal), (tc, tp, e[9]))[1]

    J = torch.func.vmap(jvp_k)(basis).movedim(0, -1)        # (N, V, 2, 10)
    Jc, Jp, Jf = J[..., :6], J[..., 6:9], J[..., 9:]
    Jpp = torch.eye(2, dtype=r.dtype, device=r.device).expand(*r.shape[:2], 2, 2)
    Jg = torch.cat([Jf, Jpp], -1)
    return r, Jc, Jp, Jg, _weights(prob, r.dtype)


def _cost_only(cams, points, focal, prob: BAProblem, pp_delta=None, group=None) -> torch.Tensor:
    r = _residuals(cams, points, focal, prob.uv, pp_delta)
    return all_reduce_sum(group, 0.5 * (_weights(prob, r.dtype) * (r * r).sum(-1)).sum())[0]


def _cg_solve(A: torch.Tensor, b: torch.Tensor, extra_iters: int = 8,
              max_iters: int = 32) -> torch.Tensor:
    """Conjugate gradients, min(n + extra, max_iters) fixed iterations."""
    x = torch.zeros_like(b)
    r, p = b, b
    rs = b @ b
    for _ in range(min(b.shape[0] + extra_iters, max_iters)):
        Ap = A @ p
        denom = p @ Ap
        alpha = torch.where(denom.abs() > 1e-30, rs / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = r @ r
        beta = torch.where(rs > 1e-30, rs_new / rs, 0.0)
        p = r + beta * p
        rs = rs_new
    return x


def _lm_step(prob: BAProblem, lam: torch.Tensor, share_focal: bool, refine_pp: bool = False,
             group=None):
    """One damped normal-equation solve -> (d_cams, d_points, d_focal, d_pp, pred).
    With ``group`` the camera-side sums span the shards; the point blocks are
    local, since each point lives wholly on one shard."""
    r, Jc, Jp, Jg, w = _residuals_and_jacobians(prob)
    V = prob.cams.shape[0]
    G = 3
    dev, dt = r.device, r.dtype
    ww = w[..., None, None]
    wJc, wJp, wJg = Jc * ww, Jp * ww, Jg * ww

    U = torch.einsum("nvia,nvib->vab", wJc, Jc)
    U_cg = torch.einsum("nvia,nvig->vag", wJc, Jg)
    U_gg = torch.einsum("nvig,nvih->gh", wJg, Jg)
    b_c = torch.einsum("nvia,nvi->va", wJc, r)
    b_g = torch.einsum("nvig,nvi->g", wJg, r)
    C = torch.einsum("nvia,nvib->nab", wJp, Jp)
    b_p = torch.einsum("nvia,nvi->na", wJp, r)
    Kb = torch.einsum("nvia,nvib->nvab", wJc, Jp)
    Wg = torch.einsum("nvig,nvia->nag", wJg, Jp)
    U, U_cg, U_gg, b_c, b_g = all_reduce_sum(group, U, U_cg, U_gg, b_c, b_g)

    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eyeG = torch.eye(G, dtype=dt, device=dev)
    Ud = U + lam * (U * eye6) + 1e-8 * eye6
    Cd = C + lam * (C * eye3) + 1e-8 * eye3
    Uggd = U_gg + lam * (U_gg * eyeG) + 1e-8 * eyeG
    Cinv = inv3x3(Cd, _EPS)

    KC = torch.einsum("nvab,nbc->nvac", Kb, Cinv)
    X_cc = torch.einsum("nvac,nwbc->vawb", KC, Kb)
    X_cg = torch.einsum("nvac,ncg->vag", KC, Wg)
    WgC = torch.einsum("nag,nab->nbg", Wg, Cinv)
    X_gg = torch.einsum("nbg,nbh->gh", WgC, Wg)
    X_c = torch.einsum("nvac,nc->va", KC, b_p)
    X_g = torch.einsum("nbg,nb->g", WgC, b_p)
    X_cc, X_cg, X_gg, X_c, X_g = all_reduce_sum(group, X_cc, X_cg, X_gg, X_c, X_g)
    eyeV = torch.eye(V, dtype=dt, device=dev)
    S_cc = (torch.einsum("vw,vab->vawb", eyeV, Ud) - X_cc).reshape(6 * V, 6 * V)
    S_cg = (U_cg - X_cg).reshape(6 * V, G)
    S = torch.cat([torch.cat([S_cc, S_cg], 1),
                   torch.cat([S_cg.T, Uggd - X_gg], 1)], 0)
    rhs = torch.cat([(b_c - X_c).reshape(-1), b_g - X_g])

    free = torch.cat([prob.cam_valid.repeat_interleave(6).to(dt),
                      torch.full((1,), float(share_focal), dtype=dt, device=dev),
                      torch.full((2,), float(refine_pp), dtype=dt, device=dev)])
    S = S * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    rhs = rhs * free

    damp_c = lam * U.diagonal(dim1=-2, dim2=-1)
    damp_p = lam * C.diagonal(dim1=-2, dim2=-1)
    damp_g = lam * U_gg.diagonal()

    dscale = 1.0 / torch.sqrt(torch.clamp(S.diagonal(), min=1e-12))
    ys = _cg_solve(S * dscale[:, None] * dscale[None, :], rhs * dscale)
    delta = ys * dscale
    delta = torch.where(torch.isfinite(delta), delta, 0.0)
    d_cams = delta[:6 * V].reshape(V, 6)
    d_g = delta[6 * V:]

    Kd = torch.einsum("nvab,va->nb", Kb, d_cams)
    d_points = torch.einsum("nab,nb->na", Cinv,
                            b_p - Kd - torch.einsum("nag,g->na", Wg, d_g))
    d_points = torch.where(prob.pt_valid[:, None], d_points, 0.0)
    d_points = torch.where(torch.isfinite(d_points), d_points, 0.0)

    pred_cam = 0.5 * ((d_cams * (damp_c * d_cams + b_c)).sum()
                      + (d_g * (damp_g * d_g + b_g)).sum())
    pred_pt = all_reduce_sum(group, 0.5 * (d_points * (damp_p * d_points + b_p)).sum())[0]
    return d_cams, d_points, d_g[0], d_g[1:], pred_cam + pred_pt


class LMState(NamedTuple):
    """The LM loop's state between two iterations: the problem at the
    current estimate, the damping ``lam`` and its growth factor ``nu``, the
    stop flag, the count of consecutive rejections, the cost at ``p`` and
    the count of iterations that ran live."""
    p: NamedTuple
    lam: torch.Tensor
    nu: torch.Tensor
    done: torch.Tensor
    rejects: torch.Tensor
    cost: torch.Tensor
    it: torch.Tensor


def lm_start(prob, cost_of, initial_lambda: float) -> LMState:
    """The state before the first iteration, ``cost_of(prob)`` its cost."""
    dev, dt = prob.cams.device, prob.cams.dtype
    cost = cost_of(prob)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    lam = torch.full((), initial_lambda, dtype=dt, device=dev)
    nu = torch.full((), 2.0, dtype=dt, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    rejects = torch.zeros((), dtype=torch.int64, device=dev)
    return LMState(prob, lam, nu, done, rejects, cost, it)


def lm_iteration(s: LMState, step, cost_of, fields, function_tolerance: float) -> LMState:
    """One LM iteration from ``s``, every decision on the device: a state
    that is ``done`` comes back unchanged. ``step(p, lam)`` returns the
    update of each of ``fields`` (the state moves by minus it), then the
    predicted decrease; ``cost_of(p)`` is the cost at ``p``."""
    p, lam, nu, done, rejects, cost, it = s
    live = ~done
    *deltas, pred = step(p, lam)
    new = p._replace(**{f: getattr(p, f) - d for f, d in zip(fields, deltas)})
    new_cost = cost_of(new)
    accept = (new_cost < cost) & torch.isfinite(new_cost)
    take_new = accept & live
    p = p._replace(**{f: torch.where(take_new, getattr(new, f), getattr(p, f))
                      for f in fields})
    rho = (cost - new_cost) / torch.clamp(pred, min=_EPS)
    shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam2 = torch.where(accept, torch.clamp(lam * shrink, min=1e-10),
                       torch.clamp(lam * nu, max=1e8))
    nu2 = torch.where(accept, 2.0, torch.clamp(nu * 2.0, max=64.0))
    rel = (cost - new_cost).abs() / torch.clamp(cost, min=_EPS)
    rejects2 = torch.where(accept, 0, rejects + 1)
    # the tolerance exit counts only for genuine trust-region steps
    # (rho > 0.5, i.e. lambda shrank): an accepted-but-heavily-damped
    # micro-step has a tiny relative decrease without being converged
    done2 = (accept & (rel < function_tolerance) & (rho > 0.5)) | (rejects2 >= 5)
    cost2 = torch.where(accept, new_cost, cost)
    lam = torch.where(live, lam2, lam)
    nu = torch.where(live, nu2, nu)
    rejects = torch.where(live, rejects2, rejects)
    cost = torch.where(live, cost2, cost)
    it = it + live.to(it.dtype)
    done = done | done2
    return LMState(p, lam, nu, done, rejects, cost, it)


def lm_run(s: LMState, advance, *, span: str, max_iterations: int,
           host_exit: bool) -> LMState:
    """Up to ``max_iterations`` of ``advance(s)``, each one span ``span``,
    opened after the ``host_exit`` read of ``done``."""
    for _ in range(max_iterations):
        if host_exit and bool(s.done):
            break
        with stage(span):
            s = advance(s)
    return s


def lm_loop(prob, step, cost_of, fields, *, span: str, max_iterations: int,
            function_tolerance: float, initial_lambda: float, host_exit: bool):
    """The LM loop of ``lm_solve`` and ``ba/sparse.py::lm_solve_sparse``:
    ``lm_iteration`` run eagerly by ``lm_run`` from ``lm_start``. Returns
    (solved problem, BASummary)."""
    s0 = lm_start(prob, cost_of, initial_lambda)
    s = lm_run(s0, lambda s: lm_iteration(s, step, cost_of, fields, function_tolerance),
               span=span, max_iterations=max_iterations, host_exit=host_exit)
    return s.p, BASummary(initial_cost=s0.cost, final_cost=s.cost, iterations=s.it,
                          converged=s.done)


def lm_solve(prob: BAProblem, *, max_iterations: int = 50,
             function_tolerance: float = 1e-6, initial_lambda: float = 1e-3,
             share_focal: bool = True, refine_pp: bool = False,
             host_exit: bool = True, group=None):
    """Levenberg-Marquardt with Nielsen/Ceres gain-ratio damping, the
    function-tolerance exit on genuine trust-region steps and the
    five-rejections stall exit (``lm_loop``). Returns (solved BAProblem,
    BASummary). ``group``: this rank's points are one shard of the problem
    (module docstring)."""
    if prob.pp_delta is None:
        prob = prob._replace(pp_delta=torch.zeros(2, dtype=prob.cams.dtype,
                                                  device=prob.cams.device))
    return lm_loop(
        prob, lambda p, lam: _lm_step(p, lam, share_focal, refine_pp, group),
        lambda p: _cost_only(p.cams, p.points, p.focal, p, p.pp_delta, group),
        ("cams", "points", "focal", "pp_delta"), span="sfm.ba.lm_iter",
        max_iterations=max_iterations, function_tolerance=function_tolerance,
        initial_lambda=initial_lambda, host_exit=host_exit)


def reprojection_rms(prob: BAProblem) -> torch.Tensor:
    """RMS reprojection error (pixels) over valid observations."""
    r = _residuals(prob.cams, prob.points, prob.focal, prob.uv, prob.pp_delta)
    w = _weights(prob, r.dtype)
    return torch.sqrt((w * (r * r).sum(-1)).sum() / torch.clamp(w.sum(), min=1.0))


def adjust_bundle(poses_Rt, cam_valid, points, pt_valid, uv, obs_mask, K, *,
                  max_iterations: int = 50, function_tolerance: float = 1e-6,
                  initial_lambda: float = 1e-3, share_focal: bool = True,
                  refine_pp: bool = False, dtype: str = "float32"):
    """Reference adjustBundle API: poses (V,3,4) + cloud + (N,V,2) raw pixel
    observations + K -> (poses, points, K, summary)."""
    dt = getattr(torch, dtype)
    rvecs = camera.matrix_to_rodrigues(poses_Rt[..., :3])
    cams = torch.cat([rvecs, poses_Rt[..., 3]], 1)
    pp = K[:2, 2]
    prob = BAProblem(cams=cams.to(dt), points=points.to(dt), focal=K[0, 0].to(dt),
                     uv=(uv - pp).to(dt), mask=obs_mask, cam_valid=cam_valid,
                     pt_valid=pt_valid)
    sol, summary = lm_solve(prob, max_iterations=max_iterations,
                            function_tolerance=function_tolerance,
                            initial_lambda=initial_lambda, share_focal=share_focal,
                            refine_pp=refine_pp)
    f32 = torch.float32
    R = camera.rodrigues_to_matrix(sol.cams[:, :3].to(f32))
    out_Rt = torch.cat([R, sol.cams[:, 3:, None].to(f32)], 2)
    newK = K.clone()
    newK[0, 0] = sol.focal.to(f32)
    newK[1, 1] = sol.focal.to(f32)
    if refine_pp:
        newK[:2, 2] = pp + sol.pp_delta.to(f32)
    return out_Rt, sol.points.to(f32), newK, summary
