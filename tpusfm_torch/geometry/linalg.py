"""Shared linear-algebra helpers for the batched geometry solvers.

Counterpart of ``tpusfm/geometry/linalg.py``; every helper takes leading
batch dimensions. Singular vectors are defined up to sign, as in JAX.
"""
from __future__ import annotations

import math

import torch

from tpusfm_torch.camera import skew  # noqa: F401  (re-exported as in tpusfm)

_EPS = 1e-12
# cuSOLVER's batched symmetric eigensolver refuses a batch of 32768 matrices
# (CUSOLVER_STATUS_INVALID_VALUE at 9x9 float32; 31488 went through), so
# larger batches are solved in pieces
_EIGH_BATCH = 16384


def smallest_singular_vector(A: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """Right singular vector of A (..., N, D) for the smallest singular value,
    via eigh of the D x D Gram matrix. Rows weighted by w (..., N)."""
    if w is not None:
        A = A * w[..., None]
    G = A.transpose(-1, -2) @ A
    flat = G.reshape(-1, *G.shape[-2:])
    if flat.shape[0] <= _EIGH_BATCH:
        _, V = torch.linalg.eigh(G)        # ascending eigenvalues
        return V[..., :, 0]
    v0 = torch.cat([torch.linalg.eigh(part)[1][:, :, 0] for part in flat.split(_EIGH_BATCH)])
    return v0.reshape(*G.shape[:-1])


def smallest_eigenvector_psd(G: torch.Tensor, iterations: int = 6) -> torch.Tensor:
    """Eigenvector (..., D) of the smallest eigenvalue of a symmetric PSD
    G (..., D, D), by shifted inverse iteration from the all-ones vector.

    Unlike ``torch.linalg.eigh``, whose error check reads a flag back from
    the GPU, this never syncs with the host (``inv_ex`` checks nothing).
    The shift, 1e-6 of the mean diagonal, keeps G + shift invertible when G
    is singular; each step shrinks the other eigen-directions by the ratio
    of the smallest eigenvalue to the next (plus the shift)."""
    d = G.shape[-1]
    eye = torch.eye(d, dtype=G.dtype, device=G.device)
    shift = 1e-6 * torch.diagonal(G, dim1=-2, dim2=-1).mean(-1)
    Ginv = torch.linalg.inv_ex(G + torch.clamp(shift, min=_EPS)[..., None, None] * eye)[0]
    v = torch.full((*G.shape[:-1], 1), d ** -0.5, dtype=G.dtype, device=G.device)
    for _ in range(iterations):
        y = Ginv @ v
        v = y / torch.clamp(torch.linalg.vector_norm(y, dim=-2, keepdim=True), min=_EPS)
    return v[..., 0]


def smallest_singular_vector_direct(A: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """Smallest right singular vector via SVD of A itself (does not square
    the condition number — needed in f32 near the noise floor)."""
    if w is not None:
        A = A * w[..., None]
    n, d = A.shape[-2:]
    if n < d:
        # zero rows make Vt square so the nullspace vector is present
        pad = torch.zeros(*A.shape[:-2], d - n, d, dtype=A.dtype, device=A.device)
        A = torch.cat([A, pad], -2)
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    return Vt[..., -1, :]


def batched_jacobian(f, x: torch.Tensor) -> torch.Tensor:
    """Forward-mode Jacobian of f at x (..., n) when batch elements are
    independent: f(x) (..., m) -> J (..., m, n).

    The counterpart of ``jax.jacfwd`` under ``vmap``: one jvp per basis
    direction e_k, applied to every batch element at once, so the cost is
    n batched forward passes and never a cross-batch Jacobian."""
    if x.dim() == 1:
        # a 0-d intermediate with a vmapped tangent promotes float32 to
        # float64 on ops with Python scalars; keep every value >= 1-d
        return batched_jacobian(f, x[None])[0]
    n = x.shape[-1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device)
    tangents = basis.reshape(n, *([1] * (x.dim() - 1)), n).expand(n, *x.shape)
    jv = torch.func.vmap(lambda v: torch.func.jvp(f, (x,), (v,))[1])(tangents)
    return jv.movedim(0, -1)


def _weighted_centroid_scale(pts, w, target):
    if w is None:
        w = torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=_EPS)          # (..., 1)
    centroid = (pts * w[..., None]).sum(-2) / wsum                  # (..., d)
    d = torch.linalg.vector_norm(pts - centroid[..., None, :], dim=-1)
    mean_d = (d * w).sum(-1) / wsum[..., 0]
    s = target / torch.clamp(mean_d, min=_EPS)
    return centroid, s


def hartley_normalize_2d(pts: torch.Tensor, w: torch.Tensor | None = None):
    """Zero centroid, mean distance sqrt(2). pts (..., N, 2) ->
    (normalized (..., N, 2), T (..., 3, 3)) with x_norm_h = T @ x_h."""
    centroid, s = _weighted_centroid_scale(pts, w, math.sqrt(2.0))
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, z, -s * centroid[..., 0]], -1),
        torch.stack([z, s, -s * centroid[..., 1]], -1),
        torch.stack([z, z, o], -1),
    ], -2)
    return (pts - centroid[..., None, :]) * s[..., None, None], T


def hartley_normalize_3d(pts: torch.Tensor, w: torch.Tensor | None = None):
    """Zero centroid, mean distance sqrt(3). pts (..., N, 3) ->
    (normalized (..., N, 3), T (..., 4, 4))."""
    centroid, s = _weighted_centroid_scale(pts, w, math.sqrt(3.0))
    eye = torch.eye(4, dtype=pts.dtype, device=pts.device)
    T = eye.expand(*s.shape, 4, 4).clone()
    T[..., :3, :3] = T[..., :3, :3] * s[..., None, None]
    T[..., :3, 3] = -s[..., None] * centroid
    return (pts - centroid[..., None, :]) * s[..., None, None], T
