"""Adaptive Runge-Kutta integration, Dormand-Prince 5(4) (PyTorch port of
:mod:`quantumpropagators.ops.ode`).

The in-house replacement for the reference's OrdinaryDiffEq dependency
(``ext/QuantumPropagatorsODEExt.jl``): the classic embedded DP5(4) pair
with a PI step-size controller.  The stages run on the state's device;
the step-size control runs on the host (one scalar read of the error
norm per attempted step).  For quantum propagation the RHS is
``f(t, Ψ) = -i·H(t)·Ψ`` (see :mod:`..propagators.ode`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

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

    ``f`` takes a float ``t`` and a tensor ``y``.  Supports backward
    integration (``t1 < t0``).  Returns ``y(t1)``; if ``max_steps``
    attempted steps do not reach ``t1`` the result is whatever was
    reached, as in the JAX function."""
    t0, t1 = float(t0), float(t1)
    direction = float(np.sign(t1 - t0))
    h = abs(t1 - t0) / 100.0 if first_step is None else abs(float(first_step))

    def rk_step(t, y, h, k0):
        ks = [k0]
        for i in range(1, 7):
            yi = y
            for j in range(i):
                if _A[i, j] != 0.0:
                    yi = yi + (h * _A[i, j]) * ks[j]
            ks.append(f(t + _C[i] * h, yi))
        y5, err = y, torch.zeros_like(y)
        for i in range(7):
            y5 = y5 + (h * _B5[i]) * ks[i]
            err = err + (h * _E[i]) * ks[i]
        return y5, err, ks[6]  # FSAL: k7 = f(t+h, y5)

    def err_norm(err, y, y_new):
        scale = atol + rtol * torch.maximum(y.abs(), y_new.abs())
        return float(torch.sqrt(torch.mean((err.abs() / scale) ** 2)))

    t, y, k = t0, y0, f(t0, y0)
    err_prev = 1.0
    for _ in range(max_steps):
        h_signed = direction * min(h, abs(t1 - t))
        last = abs(t1 - t) <= h
        y_new, err, k_new = rk_step(t, y, h_signed, k)
        en = err_norm(err, y, y_new)
        accept = en <= 1.0
        # PI controller (order 5 → exponent 1/5, with previous error)
        en_c = max(en, 1e-10)
        factor = safety * en_c ** (-0.7 / 5.0) * max(err_prev, 1e-10) ** 0.08
        h = abs(h_signed) * min(max(factor, 0.2), 5.0)
        if accept:
            t, y, k, err_prev = t + h_signed, y_new, k_new, en_c
            if last:
                break
    return y
