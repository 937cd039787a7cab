"""Pulse envelope shape functions.

Vectorized (numpy/jax-compatible) implementations of the reference's
shape library (``src/shapes.jl``): :func:`flattop`,
:func:`box`, :func:`blackman`.  All accept scalars or arrays and are
safe to use both on the host (control discretization) and inside jitted
code (they only use ufuncs and ``where``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["flattop", "box", "blackman"]


def box(t, t_start, t_stop):
    """Box shape: ``1`` for ``t_start <= t <= t_stop``, else ``0``.

    (reference ``src/shapes.jl:72``)
    """
    t = np.asarray(t, dtype=np.float64)
    result = np.where((t >= t_start) & (t <= t_stop), 1.0, 0.0)
    return result if result.ndim else float(result)


def blackman(t, t_start, t_stop, a: float = 0.16):
    """Blackman window shape between ``t_start`` and ``t_stop``.

    ``B(t) = 1/2 (1 - a - cos(2π x) + a cos(4π x))`` with
    ``x = (t - t_start)/(t_stop - t_start)`` and ``a = 0.16``; exactly
    zero outside the window (reference ``src/shapes.jl:100-107``).
    """
    t = np.asarray(t, dtype=np.float64)
    dT = t_stop - t_start
    x = (t - t_start) / dT
    result = (
        0.5
        * box(t, t_start, t_stop)
        * (1.0 - a - np.cos(2 * np.pi * x) + a * np.cos(4 * np.pi * x))
    )
    return result if np.ndim(result) else float(result)


def flattop(t, *, T, t_rise, t0: float = 0.0, t_fall=None, func: str = "blackman"):
    """Flat shape with a smooth switch-on/off from/to zero.

    Starts at 0 at ``t0``, ramps to 1 over ``t_rise``, stays at 1, ramps
    back to 0 over ``t_fall`` before ``T``; zero outside ``[t0, T]``.
    ``func`` selects the ramp: half a Blackman window (default) or a
    sine-squared curve (reference ``src/shapes.jl:22-60``).
    """
    if t_fall is None:
        t_fall = t_rise
    if func == "blackman":
        return _flattop_blackman(t, t0, T, t_rise, t_fall)
    if func == "sinsq":
        return _flattop_sinsq(t, t0, T, t_rise, t_fall)
    raise ValueError(f"Unknown func={func!r}. Accepted: 'blackman', 'sinsq'.")


def _flattop_sinsq(t, t0, T, t_rise, t_fall):
    t = np.asarray(t, dtype=np.float64)
    inside = (t >= t0) & (t <= T)
    on = np.sin(np.pi * (t - t0) / (2.0 * t_rise)) ** 2 if t_rise > 0 else 1.0
    off = np.sin(np.pi * (t - T) / (2.0 * t_fall)) ** 2 if t_fall > 0 else 1.0
    f = np.where(
        inside,
        np.where(t < t0 + t_rise, on, np.where(t > T - t_fall, off, 1.0)),
        0.0,
    )
    return f if f.ndim else float(f)


def _flattop_blackman(t, t0, T, t_rise, t_fall):
    t = np.asarray(t, dtype=np.float64)
    inside = (t >= t0) & (t <= T)
    on = blackman(t, t0, t0 + 2 * t_rise) if t_rise > 0 else 1.0
    off = blackman(t, T - 2 * t_fall, T) if t_fall > 0 else 1.0
    f = np.where(
        inside,
        np.where(t < t0 + t_rise, on, np.where(t > T - t_fall, off, 1.0)),
        0.0,
    )
    return f if f.ndim else float(f)
