"""Arnoldi iteration and Hessenberg utilities (PyTorch port of
:mod:`quantumpropagators.ops.arnoldi`).

Builds the Krylov factorization of ``H·dt`` from a starting state
(reference ``src/arnoldi.jl``), with classical Gram-Schmidt and one
reorthogonalization (CGS2): each orthogonalization is two matrix-vector
products against the whole basis.  The loop stops at Krylov breakdown
and reports the effective dimension ``m_eff``.

The state may be sharded: with an operator that carries a shard-slot
mesh (:func:`~.operators.op_mesh`), ``psi`` is this rank's
``(n_local, N/n)`` slots, the basis keeps that layout, and the
projections and norms sum per-slot partial sums over every slot with
the mesh's ``psum`` (the reductions XLA inserts for a GSPMD-sharded
state in the JAX package), so ``Hess`` is the same on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from .operators import apply, host_np, sharded_dim, sharded_norm

__all__ = ["arnoldi", "diagonalize_hessenberg_matrix"]


def _project(basis, w, mesh):
    """``Σₖ conj(basis[i, k])·w[k]`` for each row ``i`` of the flat basis
    (over every slot when there is a mesh)."""
    if mesh is None:
        return (basis @ w.conj()).conj()
    rows = basis.shape[0]
    part = torch.einsum("isk,sk->si",
                        basis.reshape(rows, mesh.n_local, -1).conj(),
                        w.reshape(mesh.n_local, -1))
    return mesh.psum(part)


def _cgs2(basis, w, mesh):
    """Classical Gram-Schmidt of ``w`` against the rows of the flat
    ``basis``, twice: returns ``w`` orthogonalized and its coordinates
    (the Hessenberg column)."""
    hcol = torch.zeros(basis.shape[0], dtype=w.dtype, device=w.device)
    for _ in range(2):
        proj = _project(basis, w, mesh)
        w = w - proj @ basis
        hcol = hcol + proj
    return w, hcol


def arnoldi(op, psi, m: int, dt: float = 1.0, *, extended: bool = True,
            norm_min: float = 1e-15):
    """Compute the (extended) Arnoldi factorization of ``H·dt`` from
    ``psi`` (which must be normalized).

    Returns ``(Hess, q, m_eff)``: the ``(m+1, m+1)`` Hessenberg matrix
    of ``H·dt`` as a host complex128 array (the extended bottom row
    populated iff ``extended``), the ``(m+1, N)`` orthonormal Krylov
    basis on ``psi``'s device (``(m+1,) + psi.shape`` for a sharded
    state), and the effective Krylov dimension ``m_eff ≤ m`` (reference
    ``src/arnoldi.jl:60-100``).
    """
    m = int(m)
    _N, mesh = sharded_dim(op, psi)
    cdtype = torch.promote_types(psi.dtype, torch.complex64)
    shape = tuple(psi.shape)
    q = torch.zeros((m + 1, psi.numel()), dtype=cdtype, device=psi.device)
    q[0] = psi.reshape(-1)
    Hess = np.zeros((m + 1, m + 1), dtype=np.complex128)
    m_eff = m
    for j in range(m):
        w = apply(op, q[j].view(shape)).to(cdtype).reshape(-1)
        w, hcol = _cgs2(q[: j + 1], w, mesh)
        h = float(sharded_norm(w, mesh))
        Hess[: j + 1, j] = dt * host_np(hcol)
        Hess[j + 1, j] = dt * h
        if h < norm_min:
            m_eff = j + 1
            break
        q[j + 1] = w / h
    if not extended and m >= 1:
        Hess[m, m - 1] = 0.0
    return Hess, q.view((m + 1,) + shape), m_eff


def diagonalize_hessenberg_matrix(Hess, m: int, *, accumulate: bool = False):
    """Eigenvalues of the leading ``m×m`` block of ``Hess`` (host-side).

    With ``accumulate=True``, concatenates the eigenvalues of all
    leading sub-blocks of size 1..m (reference
    ``src/arnoldi.jl:143-170``).
    """
    H = host_np(Hess)[:m, :m]
    js = range(1, m + 1) if accumulate else [m]
    out = []
    for j in js:
        if j == 1:
            out.append(np.array([H[0, 0]]))
        elif j == 2:
            a, b = H[0, 0], H[0, 1]
            c, d = H[1, 0], H[1, 1]
            s = np.sqrt(a ** 2 + 4 * b * c - 2 * a * d + d ** 2 + 0j)
            out.append(np.array([0.5 * (a + d - s), 0.5 * (a + d + s)]))
        else:
            out.append(np.linalg.eigvals(H[:j, :j]))
    return np.concatenate(out).astype(np.complex128)
