"""Krylov ``expv`` (PyTorch port of :mod:`quantumpropagators.ops.expv`):
apply ``exp(-i dt H)`` through a single Arnoldi factorization, without
forming the propagator matrix.

The analogue of the reference's ExponentialUtilities backend
(``ext/QuantumPropagatorsExponentialUtilitiesExt.jl:74-210``): build an
``m``-dimensional Krylov subspace, exponentiate the small Hessenberg
matrix on the host, and combine ``Ψ' = β · Q† exp(-i dt Hess) e₁``.

Modes (mirroring the reference's ``:happy_breakdown`` vs
``:error_estimate``): with ``tol=None`` a fixed Krylov dimension ``m``
is used (stopping early only on happy breakdown); with a tolerance, the
generalized-residual error estimate ``β·|dt·h_{m+1,m}·[exp]_{m,1}|`` is
evaluated and ``m`` is doubled until it passes.

A sharded state under an operator that carries the mesh goes through
unchanged (see :mod:`.newton`).  Inside a propagator's step the Arnoldi
call and the final combine (:func:`_expv_combine`, reading the lent
basis in place) each replay one CUDA graph of its
:func:`.arnoldi.arnoldi_sites` scope; outside every scope both run
their bodies (one call, or one a doubled ``m``, has nothing to
replay).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.linalg

from .arnoldi import _combine, arnoldi, graphed_call
from .operators import sharded_dim, sharded_norm

__all__ = ["expv_apply", "expv_apply_dd"]


def _expv_combine(q, w, m: int):
    """``Σᵢ wᵢ qᵢ`` over the first ``m`` rows of the basis ``q`` (the JAX
    ``_combine_dd``)."""
    return _combine(w, q, m)


#: the combine's site: the lent basis read in place, the weights data
_COMBINE = {"operators": ("q",), "controls": ("w",)}


def _expv_loop(arnoldi_fn, psi, dt, m, func, tol, m_max, N, mesh):
    """One Krylov subspace, ``m`` doubled under ``tol`` (see the module
    docstring), over ``arnoldi_fn(v, m) -> (Hess, q, m_eff)``, for a
    state of global dimension ``N`` (sharded over ``mesh`` unless it is
    ``None``)."""
    if func is None:
        func = lambda M: scipy.linalg.expm(-1j * M)
    beta = float(sharded_norm(psi, mesh))
    if beta == 0.0:
        return psi
    v = psi / beta
    m = min(m, N)
    while True:
        Hess, q, m_eff = arnoldi_fn(v, m)
        E = func(Hess[:m_eff, :m_eff])
        happy = m_eff < m
        if not happy and tol is not None and m_eff >= 1:
            h_next = abs(Hess[m_eff, m_eff - 1]) if m_eff < Hess.shape[0] \
                else 0.0
            err = beta * h_next * abs(E[m_eff - 1, 0])
            if err > tol and m < min(m_max, N):
                m = min(2 * m, m_max, N)
                del q  # before the next call makes its basis
                continue
        weights = beta * np.asarray(E[:, 0], np.complex128)
        # a lent result (the site's next call overwrites it) kept apart;
        # the site captures at a key's second call, once the basis it
        # reads is the Arnoldi site's own
        return graphed_call(_expv_combine, _COMBINE, mesh, q, weights, m_eff,
                            part=(len(q), m_eff)).clone()


def expv_apply(
    op,
    psi,
    dt: float,
    *,
    m: int = 30,
    func=None,
    tol: Optional[float] = None,
    m_max: int = 120,
    norm_min: float = 1e-15,
):
    """Evaluate ``func(H·dt)|psi⟩`` (default ``exp(-i H dt)``) in one
    Krylov subspace, for any operator of the ``apply`` protocol.

    ``m`` is the (initial) Krylov dimension; with ``tol`` given, the
    dimension doubles until the standard Krylov error estimate drops
    below ``tol`` (capped at ``m_max``).  ``func`` maps the host
    ``(m, m)`` Hessenberg of ``H·dt`` to its matrix function.
    """
    from .operators import as_tensor

    def arnoldi_fn(v, m):
        return arnoldi(op, v, m, dt, extended=True, norm_min=norm_min)

    psi = as_tensor(psi)
    return _expv_loop(arnoldi_fn, psi, dt, m, func, tol, m_max,
                      *sharded_dim(op, psi))


def expv_apply_dd(
    op,
    psi,
    dt: float,
    *,
    m: int = 30,
    func=None,
    tol: Optional[float] = None,
    m_max: int = 120,
    norm_min: float = 1e-12,
):
    """:func:`expv_apply` at reference accuracy: the Arnoldi factorization
    over an operator of :mod:`.dd_linalg` (or a host matrix, converted by
    :func:`~.dd_linalg.cdd_op_from_matrix`) with the state in
    complex128.  Returns the complex128 state."""
    from .dd_linalg import arnoldi_dd, dd_operands

    op, psi = dd_operands(op, psi)

    def arnoldi_fn(v, m):
        return arnoldi_dd(op, v, m, dt, norm_min=norm_min)

    return _expv_loop(arnoldi_fn, psi, dt, m, func, tol, m_max,
                      *sharded_dim(op, psi))
