"""Newton propagation on FIXED Leja points (PyTorch port of
:mod:`quantumpropagators.ops.newton_leja`).

For a HERMITIAN generator with a known spectral envelope
``[E_min, E_max]`` (the one the Chebyshev propagator estimates), the
interpolation nodes of the Newton method can be fixed per propagation
instead of per step:

1. Plan (host, float64): Leja-order points on ``[E_min·dt, E_max·dt]``,
   divided differences of ``f`` (default ``exp(-i z)``) at them,
   truncated where the sup-norm interpolation error on a fine grid of
   the interval drops below ``tol`` — for normal operators the
   certified bound ``‖f(A) − p(A)‖₂ = max_{λ∈spec} |f(λ) − p(λ)|``.
2. Step (device, complex128): the fixed recurrence
   ``p ← (H·dt − zₖ)p / radius``, ``Ψ += dₖ₊₁ p``: one operator apply
   and two vector updates per node, no reductions and no host
   round trip.  The whole grid is ONE scan (:func:`..utils.scan.scan`,
   the JAX package's ``lax.scan``): on the card one captured CUDA graph
   of a step, replayed per interval.

The plan is the real-Leja-points method (Caliari, Vianello and
Bergamaschi's ReLPM); :func:`~.newton.newton_apply_dd` stays the general
path for non-Hermitian generators and unknown envelopes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.scan import scan

__all__ = ["NewtonLejaPlan", "newton_leja_plan", "newton_leja_propagate_dd"]


class NewtonLejaPlan(NamedTuple):
    """Host-side plan: Leja points (float64), divided differences,
    radius, certified sup-norm error of the truncated interpolant.

    ``coeffs4`` keeps the JAX field's name; here it is the complex128
    array of the ``n`` divided differences (the JAX field holds their
    ``(4, n)`` f32 hi/lo planes)."""

    points: np.ndarray      # (n,) float64 — Leja-ordered nodes on [a, b]
    coeffs4: np.ndarray     # (n,) complex128 divided differences
    radius: float
    sup_error: float
    a: float
    b: float


def _leja_order(candidates: np.ndarray, n: int) -> np.ndarray:
    """Greedy Leja ordering of real candidates: start at max |z|, each
    next point maximizes ``Π |z − zⱼ|^(1/n)`` (damped product — same
    scheme as :func:`~.newton.extend_leja`, reference
    ``src/newton.jl:97-148``)."""
    pts = np.asarray(candidates, dtype=np.float64)
    out = [pts[np.argmax(np.abs(pts))]]
    pts = np.delete(pts, np.argmax(np.abs(pts)))
    expo = 1.0 / n
    for _ in range(n - 1):
        d = np.abs(pts[:, None] - np.asarray(out)[None, :]) ** expo
        i = int(np.argmax(np.prod(d, axis=1)))
        out.append(pts[i])
        pts = np.delete(pts, i)
    return np.asarray(out)


def _divided_differences(points, func, radius):
    """Newton divided differences of ``func`` at ``points`` with each
    factor normalized by ``radius`` (reference
    ``src/newton.jl:176-214`` scheme)."""
    n = len(points)
    a = np.zeros(n, dtype=np.complex128)
    a[0] = func(points[0])
    for k in range(1, n):
        d = np.complex128(1.0)
        pn = np.complex128(0.0)
        for j in range(1, k):
            d = d * (points[k] - points[j - 1]) / radius
            pn = pn + a[j] * d
        d = d * (points[k] - points[k - 1]) / radius
        if abs(d) <= 1e-200:
            raise FloatingPointError("divided differences underflow")
        a[k] = (func(points[k]) - a[0] - pn) / d
    return a


def _interp_sup_error(points, a, radius, func, grid):
    """Sup-norm of ``f − p_n`` on ``grid`` (the certified bound for
    normal operators)."""
    p = np.full(grid.shape, a[0], dtype=np.complex128)
    w = np.ones(grid.shape, dtype=np.complex128)
    for k in range(1, len(points)):
        w = w * (grid - points[k - 1]) / radius
        p = p + a[k] * w
    return float(np.max(np.abs(func(grid) - p)))


def newton_leja_plan(
    e_min: float,
    e_max: float,
    dt: float,
    *,
    func: Optional[Callable] = None,
    tol: float = 1e-13,
    n_max: int = 512,
    n_grid: int = 4000,
) -> NewtonLejaPlan:
    """Build the fixed-node plan for ``f(H·dt)`` with
    ``spec(H) ⊆ [e_min, e_max]`` (Hermitian).

    Nodes are Leja-ordered from a fine grid of ``[e_min·dt, e_max·dt]``
    and truncated at the first length whose grid sup-error is below
    ``tol`` — the certified per-step error bound for any Hermitian
    operator inside the envelope."""
    if func is None:
        func = lambda z: np.exp(-1j * z)
    lo, hi = sorted((e_min * dt, e_max * dt))
    if not hi > lo:
        raise ValueError("spectral interval must have positive width")
    radius = max((hi - lo) / 4.0, 1e-30)  # interval capacity
    grid = np.linspace(lo, hi, n_grid)
    cand = np.linspace(lo, hi, max(4 * n_max, 1024))
    n_try = 8
    while True:
        pts = _leja_order(cand, min(n_try, n_max))
        a = _divided_differences(pts, func, radius)
        err = _interp_sup_error(pts, a, radius, func, grid)
        if err < tol or n_try >= n_max:
            break
        n_try = min(2 * n_try, n_max)
    # trim to the shortest prefix still under tol (binary refinement)
    n_lo, n_hi = 2, len(pts)
    while n_lo < n_hi:
        mid = (n_lo + n_hi) // 2
        if _interp_sup_error(pts[:mid], a[:mid], radius, func, grid) < tol:
            n_hi = mid
        else:
            n_lo = mid + 1
    n = n_hi
    pts, a = pts[:n], a[:n]
    err = _interp_sup_error(pts, a, radius, func, grid)
    return NewtonLejaPlan(
        points=pts, coeffs4=a.astype(np.complex128), radius=float(radius),
        sup_error=err, a=lo, b=hi,
    )


def _banded_rows(terms):
    """The padded row count shared by every term when all are banded
    (a :class:`~.bsr_dd.BandedDD` or a real :class:`~.dd_linalg.CDDOp`
    of one), else ``None``."""
    from .bsr_dd import BandedDD
    from .dd_linalg import CDDOp

    rows = set()
    for t in terms:
        if isinstance(t, CDDOp) and t.im is None:
            t = t.re
        if not isinstance(t, BandedDD):
            return None
        rows.add(t.R * t.b)
    return rows.pop() if len(rows) == 1 else None


def _leja_loop(terms, ctab, points, d, psi, radius, dt, observable_fn,
               store_states, n_logical):
    """All PWC intervals as one :func:`~..utils.scan.scan`, each the fixed
    Newton recurrence over the interval's
    :class:`~.dd_linalg.TermsDDOp`.  ``ctab`` is the ``(n_steps, n_amp)``
    host complex128 amplitude table (the scan's ``xs``, on the state's
    device), ``points`` and ``d`` the plan's nodes and divided
    differences; observables and stored states see the first
    ``n_logical`` entries of the state.  The step writes its new state
    into ``out`` where the scan gives one."""
    from .dd_linalg import TermsDDOp, apply_cdd_op

    scale = float(dt) / float(radius)
    z_scaled = [float(z) / float(radius) for z in points]
    d = [complex(c) for c in d]

    def step(psi, row, out=None):
        op = TermsDDOp(terms=terms, coeffs4=row, shape=())
        phi = torch.mul(psi, d[0], out=out)
        p = psi
        for k, zk in enumerate(z_scaled[:-1]):
            # p ← (H·dt − z_k)·p / radius;  Φ += d_{k+1}·p
            w = apply_cdd_op(op, p)
            p = torch.add(w.mul_(scale), p, alpha=-zk)
            phi.add_(p, alpha=d[k + 1])
        seen = phi[:n_logical]
        if observable_fn is not None:
            return phi, torch.as_tensor(observable_fn(seen))
        return phi, (seen if store_states else None)

    table = torch.as_tensor(np.ascontiguousarray(ctab), dtype=torch.complex128,
                            device=psi.device)
    return scan(step, psi, table)


def newton_leja_propagate_dd(
    psi0,
    generator,
    tlist,
    *,
    e_min: Optional[float] = None,
    e_max: Optional[float] = None,
    func: Optional[Callable] = None,
    tol: float = 1e-13,
    n_max: int = 512,
    backward: bool = False,
    observable_fn=None,
    store_states: bool = False,
    specrange_buffer: float = 0.01,
    dd_operator_terms=None,
    **cheby_kwargs,
):
    """Propagate ``psi0`` over all of ``tlist`` with the fixed-Leja
    Newton method in complex128 (Hermitian generators).

    Spectral envelope: pass ``e_min``/``e_max`` (analytic bounds) or
    leave ``None`` to estimate over the control range exactly as the
    Chebyshev propagator does.  Returns ``(psi_final, outputs, plan)``:
    the complex128 final state, the per-step observables or states
    stacked (or ``None``), and the plan, whose ``sup_error`` is the
    certified per-step function-approximation bound.

    On the card each node of each step is one operator apply — for a
    banded term one ``banded_spmv<double>`` launch — and no host sync.
    When every term is banded the state is zero-padded once to the
    operators' ``R·b`` rows for the whole loop."""
    from ..models.generators import Generator, Operator, coeff_table_np
    from ..propagators._dd_support import build_dd_terms, state_to_cdd
    from ..propagators.base import get_uniform_dt

    tlist = np.asarray(tlist, dtype=np.float64)
    dt = get_uniform_dt(tlist, tol=1e-12, warn=False)
    if dt is None:
        raise ValueError(
            "fixed-Leja Newton requires a uniform time grid"
        )
    if backward:
        dt = -dt
    if e_min is None or e_max is None:
        from ..propagators.cheby import ChebyPropagator

        prop = ChebyPropagator(
            psi0, generator, tlist,
            specrange_buffer=specrange_buffer, **cheby_kwargs,
        )
        e_min = float(prop.wrk.e_min)
        e_max = e_min + float(prop.wrk.delta)
    plan = newton_leja_plan(
        e_min, e_max, float(dt), func=func, tol=tol, n_max=n_max,
    )
    # interval operators: the term operators once + per-interval coeffs
    if isinstance(generator, Generator):
        ops = list(generator.ops)
        table = np.asarray(coeff_table_np(generator, tlist), np.complex128)
        if backward:
            table = table[::-1]
    elif isinstance(generator, Operator):
        ops = list(generator.ops)
        table = np.broadcast_to(
            np.asarray(generator.coeffs, np.complex128)[None, :],
            (len(tlist) - 1, len(generator.coeffs)),
        )
    else:
        ops = [generator]
        table = np.zeros((len(tlist) - 1, 0), np.complex128)
    psi = state_to_cdd(psi0).reshape(-1)
    op_proto = Operator(ops, np.zeros((table.shape[1],)))
    terms = build_dd_terms(op_proto, dd_operator_terms, device=psi.device)
    n_logical = psi.shape[0]
    rows = _banded_rows(terms)
    if rows is not None and rows != n_logical:
        padded = psi.new_zeros(rows)
        padded[:n_logical] = psi
        psi = padded
    psi, outputs = _leja_loop(
        terms, table, plan.points, plan.coeffs4, psi, plan.radius,
        float(dt), observable_fn, store_states, n_logical,
    )
    return psi[:n_logical], outputs, plan
