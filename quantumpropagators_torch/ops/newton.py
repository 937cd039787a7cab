"""Newton-with-restarted-Arnoldi propagation kernel (PyTorch port of
:mod:`quantumpropagators.ops.newton`).

Evaluates ``Ψ ← f(H·dt) Ψ`` for an analytic ``f`` (default
``exp(-i z)``; non-Hermitian H and Liouvillians work too) by restarted
Arnoldi with Newton interpolation at Leja-ordered Ritz values — the
algorithm of reference ``src/newton.jl``.

The O(N) work of a restart (the Arnoldi matvecs and Gram-Schmidt of
:func:`.arnoldi.arnoldi`, the rank-(m+1) state updates) runs on the
state's device; the O(m²) bookkeeping (Hessenberg eigenvalues, greedy
Leja ordering, divided differences, the small polynomial recurrences)
stays on the host in complex128, and the host drives the restarts.
Every restart replays two CUDA graphs of the call's own
:func:`.arnoldi.arnoldi_sites` scope, or its propagator's: the Arnoldi
call, and the restart's tail (:func:`_newton_tail`: the update of the
accumulated state, the next start vector and the state's norm, reading
the Arnoldi call's lent basis in place, a site per Krylov dimension).
The host reads the Hessenberg matrix and the norm, as the JAX loop
does.
:func:`newton_apply_dd` is the same loop over a reference-accuracy
operator (:mod:`.dd_linalg`) with the state in complex128.

A sharded state (this rank's ``(n_local, N/n)`` slots, under an operator
that carries the mesh) goes through unchanged: the Arnoldi reductions
and the norms here sum over every slot (:func:`.operators.sharded_norm`),
so the host Leja logic sees the same numbers on every rank, and the
result keeps the state's layout.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .arnoldi import (_combine, arnoldi, arnoldi_sites,
                      diagonalize_hessenberg_matrix, graphed_call)
from .operators import sharded_dim, sharded_norm

__all__ = [
    "newton_apply",
    "newton_apply_dd",
    "extend_leja",
    "extend_newton_coeffs",
    "NewtonInfo",
]


def _default_func(z):
    return np.exp(-1j * z)


def extend_leja(leja: np.ndarray, newpoints: np.ndarray, n_use: int) -> np.ndarray:
    """Append ``n_use`` points from ``newpoints`` to the Leja sequence.

    Greedy max-product selection: each added point maximizes
    ``Πⱼ |z - lejaⱼ|^(1/(n+n_use))`` over the remaining candidates (the
    damped exponent prevents overflow; reference
    ``src/newton.jl:97-148``).  If the sequence is empty it is seeded
    with the candidate of largest magnitude.  Returns the extended
    (copied) sequence.
    """
    leja = np.asarray(leja, dtype=np.complex128)
    pts = np.array(newpoints, dtype=np.complex128)
    n = len(leja)
    out = list(leja)
    take = n_use
    if n == 0:
        i0 = int(np.argmax(np.abs(pts)))
        out.append(pts[i0])
        pts = np.delete(pts, i0)
        take -= 1
    exponent = 1.0 / (n + n_use)
    for _ in range(take):
        # product over existing Leja points, damped to avoid overflow
        dists = np.abs(pts[:, None] - np.asarray(out)[None, :]) ** exponent
        p = np.prod(dists, axis=1)
        i_max = int(np.argmax(p))
        out.append(pts[i_max])
        pts = np.delete(pts, i_max)
    return np.asarray(out, dtype=np.complex128)


def extend_newton_coeffs(
    a: np.ndarray,
    leja: np.ndarray,
    func: Callable,
    n_leja: int,
    radius: float,
) -> np.ndarray:
    """Extend Newton divided-difference coefficients of ``func`` at the
    (radius-normalized) Leja points from ``len(a)`` to ``n_leja``
    (reference ``src/newton.jl:176-214``).

    The divided differences are accumulated with each factor normalized
    by ``radius`` to keep magnitudes bounded; underflow of the product
    (|d| ≤ 1e-200) raises, as in the reference.
    """
    a = list(np.asarray(a, dtype=np.complex128))
    n_a = len(a)
    if radius <= 0:
        raise ValueError("radius must be positive")
    n0 = n_a
    if n_a == 0:
        a.append(np.complex128(func(leja[0])))
        n0 = 1
    for k in range(n0, n_leja):
        d = np.complex128(1.0)
        pn = np.complex128(0.0)
        for n in range(1, k):
            d = d * (leja[k] - leja[n - 1]) / radius
            pn = pn + a[n] * d
        d = d * (leja[k] - leja[k - 1]) / radius
        if abs(d) <= 1e-200:
            raise FloatingPointError("Divided differences too small")
        a.append((np.complex128(func(leja[k])) - a[0] - pn) / d)
    return np.asarray(a, dtype=np.complex128)


class NewtonInfo:
    """Diagnostics from a :func:`newton_apply` call (the inspectable
    fields of the reference's ``NewtonWrk``)."""

    def __init__(self):
        self.restarts = 0
        self.n_leja = 0
        self.n_a = 0
        self.radius = 0.0
        self.matvecs = 0


def _newton_tail(q, P, R, Psi, m: int, mesh):
    """The restart tail (the JAX ``_newton_update_dd``; for the native
    precision ``_accumulate`` and ``_norm``): ``Psi + Σᵢ Pᵢ qᵢ`` over the
    first ``m`` rows of the basis ``q``, the next start vector
    ``Σᵢ Rᵢ qᵢ`` over ``m + 1`` rows (``R`` normalized on the host), and
    the new ``Psi``'s norm (over every slot with a ``mesh``)."""
    Psi = Psi + _combine(P, q, m)
    return Psi, _combine(R, q, m + 1), sharded_norm(Psi, mesh)


#: the tail's site: the lent basis read in place, the coordinates data
_TAIL = {"operators": ("q",), "controls": ("P", "R")}


def _newton_loop(arnoldi_fn, psi, dt, func, m_max, norm_min, relerr,
                 max_restarts, info, N, mesh):
    """The restart loop of :func:`newton_apply` (reference
    ``src/newton.jl:246-385``) over ``arnoldi_fn(v, m) -> (Hess, q,
    m_eff)``, for a state of global dimension ``N`` (sharded over
    ``mesh`` unless it is ``None``)."""
    if func is None:
        func = _default_func
    if info is None:
        info = NewtonInfo()
    if m_max <= 2:
        raise ValueError("Newton propagation requires m_max > 2")
    if m_max >= N:
        m_max = N - 1
        if m_max <= 2:
            raise ValueError("Newton propagation requires state dimension > 2")
    dt = float(dt)
    if dt == 0.0:
        raise ValueError("dt must be nonzero")

    leja = np.zeros((0,), dtype=np.complex128)
    a = np.zeros((0,), dtype=np.complex128)
    radius = 0.0

    beta = float(sharded_norm(psi, mesh))
    v = psi / beta
    Psi = None
    m = m_max
    s = 0
    while True:
        Hess, q, m_eff = arnoldi_fn(v, m)
        info.matvecs += m
        m = m_eff
        if m == 1 and s == 0:
            # v is an eigenvector: f(H)Ψ = f(λ)Ψ
            lam = beta * Hess[0, 0]
            info.restarts = s
            info.radius = radius
            return complex(func(lam)) * psi

        ritz = diagonalize_hessenberg_matrix(Hess, m, accumulate=True)
        if s == 0:
            radius = 1.2 * float(np.max(np.abs(ritz)))

        n_s = len(leja)
        leja = extend_leja(leja, ritz, m)
        n_leja = len(leja)
        a = extend_newton_coeffs(a, leja, func, n_leja, radius)

        # the Newton polynomial in the (m+1)x(m+1) extended Hessenberg
        # matrix (host, small dense)
        Hm = Hess[: m + 1, : m + 1]
        R = np.zeros(m + 1, dtype=np.complex128)
        P = np.zeros(m + 1, dtype=np.complex128)
        R[0] = beta
        P[:] = a[n_s] * R
        for k in range(1, m):
            z = leja[n_s + k - 1]
            R = (Hm @ R - z * R) / radius
            P += a[n_s + k] * R

        # next restart vector: last Newton basis polynomial applied to v
        R = (Hm @ R - leja[n_s + m - 1] * R) / radius
        beta = float(np.linalg.norm(R))

        # the tail, one graph a restart: Psi's update, the next vector and
        # ‖Psi‖ (computed also where the native loop breaks first, unused)
        if Psi is None:  # 0 + x is x: the first update is the expansion
            Psi = torch.zeros(q.shape[1:], dtype=q.dtype, device=q.device)
        Psi, v, norm = graphed_call(
            _newton_tail, _TAIL, mesh, q, P[:m], R / beta if beta > 0 else R,
            Psi, m, mesh, part=(len(q), m))
        del q  # a lent basis: the next restart's call overwrites it
        if beta <= norm_min:
            break  # residual vanished: expansion is exact

        psi_relerr = beta * abs(a[n_leja - 1]) / (1.0 + float(norm))
        if psi_relerr < relerr:
            break
        s += 1
        if s > max_restarts:
            raise RuntimeError(
                f"Newton propagation did not converge within {max_restarts} restarts"
            )

    info.restarts = s
    info.n_leja = len(leja)
    info.n_a = len(a)
    info.radius = radius
    return Psi.clone()  # the tail lends it: its next call overwrites it


def newton_apply(
    op,
    psi,
    dt: float,
    *,
    func: Optional[Callable] = None,
    m_max: int = 10,
    norm_min: float = 1e-14,
    relerr: float = 1e-12,
    max_restarts: int = 50,
    info: Optional[NewtonInfo] = None,
):
    """Evaluate ``f(H·dt)|psi⟩`` by restarted Arnoldi + Newton
    interpolation (reference ``src/newton.jl:246-385``) for any operator
    of the ``apply`` protocol.

    Per restart ``s``: an ``m``-step Arnoldi factorization of ``H·dt``
    from the current residual vector; Ritz values of all leading
    sub-blocks are appended to a global Leja sequence; Newton
    divided-difference coefficients of ``f`` are extended; the Newton
    polynomial is evaluated *in the small extended Hessenberg matrix* to
    give the Krylov-basis coordinates ``P`` of this restart's correction
    ``ΔΨ = Σ Pᵢ qᵢ``; the next residual is the last Newton basis
    polynomial applied to the start vector.  Converged when
    ``β·|a_last| / (1 + ‖Ψ‖) < relerr``.
    """
    from .operators import as_tensor

    psi = as_tensor(psi)

    def arnoldi_fn(v, m):
        return arnoldi(op, v, m, dt, extended=True, norm_min=norm_min)

    with arnoldi_sites():  # the restarts replay one graph
        return _newton_loop(arnoldi_fn, psi, dt, func, m_max, norm_min,
                            relerr, max_restarts, info,
                            *sharded_dim(op, psi))


def _split_c128_planes(w) -> np.ndarray:
    """Host complex128 copy of ``w`` (the JAX function splits it into
    ``(4, n)`` f32 hi/lo planes; the port's coefficients are complex128
    throughout)."""
    return np.array(w, dtype=np.complex128).reshape(-1)


def newton_apply_dd(
    op,
    psi,
    dt: float,
    *,
    func: Optional[Callable] = None,
    m_max: int = 10,
    norm_min: float = 1e-12,
    relerr: float = 1e-12,
    max_restarts: int = 50,
    info: Optional[NewtonInfo] = None,
):
    """:func:`newton_apply` at reference accuracy: ``op`` is an operator
    of :mod:`.dd_linalg` (:class:`~.dd_linalg.DenseDDOp`,
    :class:`~.dd_linalg.CDDOp`, :class:`~.dd_linalg.TermsDDOp`, a
    callable, or any host matrix — converted by
    :func:`~.dd_linalg.cdd_op_from_matrix`), ``psi`` a complex128 state
    or host vector.  Returns the complex128 state."""
    from .dd_linalg import arnoldi_dd, dd_operands

    op, psi = dd_operands(op, psi)

    def arnoldi_fn(v, m):
        return arnoldi_dd(op, v, m, dt, norm_min=norm_min)

    with arnoldi_sites():  # the restarts replay one graph
        return _newton_loop(arnoldi_fn, psi, dt, func, m_max, norm_min,
                            relerr, max_restarts, info,
                            *sharded_dim(op, psi))
