"""Large Steps in Inverse Rendering of Geometry (Nicolet et al. 2021;
`tpusky/ad/largesteps.py`).

A mesh's vertices v are optimised through the latent u = (I + λL) v, L
the uniform (combinatorial) Laplacian, so that a gradient step in u is a
smoothed step in v. (I + λL) is symmetric positive definite, so
`from_differential` solves it by matrix-free conjugate gradients: the
Laplacian's product is two `index_add_` segment sums over the unique
edges, with the reference's tolerance and iteration cap. Its backward
solves the same system for the cotangent (the matrix is symmetric), as
`jax.scipy.sparse.linalg.cg`'s implicit transpose does.

Use it with `Adam(uniform=True)` (`ad/optimizers.py`), as the paper does.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["mesh_laplacian_edges", "LargeSteps"]


def mesh_laplacian_edges(faces) -> np.ndarray:
    """The unique undirected edges (E, 2) int32 of a triangle mesh, on the
    host; (L v)_i = deg(i) v_i - sum_{j ~ i} v_j."""
    f = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    e = np.unique(np.sort(e, axis=1), axis=0)
    return e.astype(np.int32)


def _cg(matvec, b, tol: float, maxiter: int):
    """Conjugate gradients on an SPD operator from x = 0 -> (x,
    iterations), stopping at |r| <= tol |b| (`jax.scipy.sparse.linalg.cg`'s
    rule with atol 0)."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = (r * r).sum()
    bound = (tol * tol) * (b * b).sum()
    it = 0
    # one host read a step: the loop ends on the residual
    while it < maxiter and bool(rs > bound):
        ap = matvec(p)
        alpha = rs / (p * ap).sum()
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = (r * r).sum()
        p = r + (rs_new / rs) * p
        rs = rs_new
        it += 1
    return x, it


class _Solve(torch.autograd.Function):
    """v = (I + λL)^-1 u, and the cotangent by the same solve."""

    @staticmethod
    def forward(ctx, ls, u):
        ctx.ls = ls
        v, ls.last_iterations = _cg(ls._matvec, u, ls.cg_tol, ls.cg_maxiter)
        return v

    @staticmethod
    def backward(ctx, g):
        ls = ctx.ls
        return None, _cg(ls._matvec, g.contiguous(), ls.cg_tol,
                         ls.cg_maxiter)[0]


class LargeSteps:
    """Latent reparameterisation u = (I + λL) v of mesh vertices:
    `to_differential(v) -> u`, `from_differential(u) -> v`
    (`largesteps.py:55` of the reference)."""

    def __init__(self, verts, faces, lambda_: float = 19.0,
                 cg_tol: float = 1e-6, cg_maxiter: int = 200, device=None):
        verts = torch.as_tensor(verts, dtype=torch.float32, device=device)
        dev = verts.device
        self.n_verts = int(verts.reshape(-1, 3).shape[0])
        e = mesh_laplacian_edges(faces)
        deg = np.zeros(self.n_verts, np.float32)
        np.add.at(deg, e[:, 0], 1.0)
        np.add.at(deg, e[:, 1], 1.0)
        self.edges = torch.as_tensor(e.astype(np.int64), device=dev)
        self.degree = torch.as_tensor(deg, device=dev)
        self.lambda_ = float(lambda_)
        self.cg_tol = float(cg_tol)
        self.cg_maxiter = int(cg_maxiter)
        self.last_iterations = 0     # CG steps of the last forward solve

    def _matvec(self, v):
        """(I + λL) v: the neighbour sums as two segment sums."""
        i, j = self.edges[:, 0], self.edges[:, 1]
        neigh = torch.zeros_like(v).index_add(0, i, v[j]).index_add(0, j,
                                                                     v[i])
        return v + self.lambda_ * (self.degree[:, None] * v - neigh)

    def to_differential(self, v):
        """v -> u = (I + λL) v (reference :124-137)."""
        return self._matvec(torch.as_tensor(v, dtype=torch.float32,
                                            device=self.degree.device
                                            ).reshape(-1, 3))

    def from_differential(self, u):
        """u -> v: the CG solve of (I + λL) v = u (reference :139-152,
        which back-substitutes a Cholesky factor)."""
        u = torch.as_tensor(u, dtype=torch.float32,
                            device=self.degree.device).reshape(-1, 3)
        return _Solve.apply(self, u)
