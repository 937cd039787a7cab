"""Adaptive Runge-Kutta integration, Dormand-Prince 5(4) (PyTorch port of
:mod:`quantumpropagators.ops.ode`).

The in-house replacement for the reference's OrdinaryDiffEq dependency
(``ext/QuantumPropagatorsODEExt.jl``): the classic embedded DP5(4) pair
with a PI step-size controller, written as the JAX function's
``lax.while_loop`` (:func:`..utils.scan.while_loop`): the time, the step,
the error norm and the step control are 0-d tensors on the state's
device, so an attempted step reads nothing from the host.  Called
alone, the loop runs eagerly and the host reads its flag once a chunk
of attempts; inside a ``graphed(..., loop=True)`` site (the ODE
propagators' intervals) the chunk is a replayed CUDA graph.  For quantum
propagation the RHS is ``f(t, Ψ) = -i·H(t)·Ψ`` (see
:mod:`..propagators.ode`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils.scan import while_loop
from .operators import device_scalar

__all__ = ["dopri5_integrate"]

# Dormand-Prince 5(4) Butcher tableau
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = np.zeros((7, 7))
_A[1, 0] = 1 / 5
_A[2, :2] = [3 / 40, 9 / 40]
_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
_A[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_B5 = _A[6, :].copy()  # 5th order solution (FSAL)
_B4 = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)
_E = _B5 - _B4  # error weights (length 7)


#: the tableau as one table, rows 0-6 ``_A``, 7 ``_B5``, 8 ``_E``, 9 ``_C``:
#: an attempt's coefficients times its step are one product
_TABLE = np.vstack([_A, _B5, _E, _C])
_TABLES: dict = {}


def _table(device) -> torch.Tensor:
    """:data:`_TABLE` on ``device``, made once (an eager call makes it
    before a capture reads it: a copy from the host cannot be
    captured)."""
    device = torch.device(device)
    if device not in _TABLES:
        _TABLES[device] = torch.as_tensor(_TABLE, dtype=torch.float64,
                                          device=device)
    return _TABLES[device]


def _real(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def _like(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_complex(r) if x.is_complex() else r


def _axpy(y, a, x):
    """``y + a·x`` for a 0-d real tensor ``a``: one ``addcmul`` over the
    real view of complex tensors (complex ``addcmul`` is compiled at run
    time on the card, seconds at its first call in a process)."""
    return _like(torch.addcmul(_real(y), a, _real(x)), y)


def _ax(a, x):
    """``a·x`` for a 0-d real tensor ``a``, over the real view."""
    return _like(_real(x) * a, x)


def dopri5_integrate(
    f: Callable,
    y0,
    t0,
    t1,
    *,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    first_step=None,
    max_steps: int = 10_000,
    safety: float = 0.9,
):
    """Integrate ``dy/dt = f(t, y)`` from ``t0`` to ``t1`` adaptively.

    ``f`` takes ``t`` as a 0-d float64 tensor on the device of ``y0``
    (the JAX function's traced scalar: ``torch.*`` math on it works) and
    a tensor ``y``.  ``t0``, ``t1`` and ``first_step`` are numbers or 0-d
    tensors.  Supports backward integration (``t1 < t0``).  Returns
    ``y(t1)``; if ``max_steps`` attempted steps do not reach ``t1`` the
    result is whatever was reached, as in the JAX function.  The loop is
    the JAX ``lax.while_loop`` over ``(t, y, h, k, done, n, err_prev)``,
    every entry a tensor on the state's device."""
    device = y0.device
    t0, t1 = device_scalar(t0, device), device_scalar(t1, device)
    direction = torch.sign(t1 - t0)
    span = torch.abs(t1 - t0)
    h0 = span / 100.0 if first_step is None else \
        torch.abs(device_scalar(first_step, device))
    table = _table(device)

    def rk_step(t, y, h, k0):
        hT = h * table
        ts = t + hT[9]
        ks = [k0]
        for i in range(1, 7):
            yi = y
            for j in range(i):
                if _A[i, j] != 0.0:
                    yi = _axpy(yi, hT[i, j], ks[j])
            ks.append(f(ts[i], yi))
        y5, err = y, None
        for i in range(7):
            if _B5[i] != 0.0:
                y5 = _axpy(y5, hT[7, i], ks[i])
            if _E[i] != 0.0:
                err = _ax(hT[8, i], ks[i]) if err is None else \
                    _axpy(err, hT[8, i], ks[i])
        return y5, err, ks[6]  # FSAL: k7 = f(t+h, y5)

    def err_norm(err, y, y_new):
        scale = atol + rtol * torch.maximum(y.abs(), y_new.abs())
        return torch.sqrt(torch.mean(torch.square(err.abs() / scale)))

    def cond(state):
        t, y, h, k, done, n, err_prev = state
        return (~done) & (n < max_steps)

    def body(state):
        t, y, h, k, done, n, err_prev = state
        h_signed = direction * torch.minimum(h, torch.abs(t1 - t))
        last = torch.abs(t1 - t) <= h
        y_new, err, k_new = rk_step(t, y, h_signed, k)
        # the step control is not differentiated (a gradient flows
        # through the stages of the steps taken, not through their
        # choice): at a masked iteration's zero step the norm's
        # derivative is infinite, and times zero it would be NaN
        en = err_norm(err.detach(), y.detach(), y_new.detach())
        accept = en <= 1.0
        # PI controller (order 5 → exponent 1/5, with previous error)
        en_c = torch.clamp(en, min=1e-10)
        factor = safety * en_c ** (-0.7 / 5.0) \
            * torch.clamp(err_prev, min=1e-10) ** 0.08
        h_next = torch.abs(h_signed) * torch.clamp(factor, 0.2, 5.0)
        return (torch.where(accept, t + h_signed, t),
                torch.where(accept, y_new, y),
                h_next,
                torch.where(accept, k_new, k),
                accept & last,
                n + 1,
                torch.where(accept, en_c, err_prev))

    state = (t0, y0, h0, f(t0, y0),
             torch.zeros((), dtype=torch.bool, device=device),
             torch.zeros((), dtype=torch.int32, device=device),
             torch.ones((), dtype=torch.float64, device=device))
    return while_loop(cond, body, state)[1]
