"""Shared machinery for piecewise-constant propagators.

Conventions (reference ``src/pwc_utils.jl:1-24``):

- ``parameters`` is an identity-keyed dict mapping each control to its
  midpoint-discretized value array (``nt-1`` values); optimal-control
  frameworks mutate/replace these arrays between iterations.
- ``n`` is the 0-based index of the *next interval to be propagated*
  (forward: starts 0; backward: starts ``nt-2``), and ``t`` the current
  grid point.
- The generator is evaluated on interval ``n`` by plugging the current
  parameter values into the amplitudes — producing only a *coefficient
  vector*; the operator terms are immutable data shared by every
  step, so control updates never touch operator assembly.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..models.controls import discretize_on_midpoints, evaluate, get_controls
from ..models.generators import Generator, Operator
from ..utils.iddict import IdDict
from .base import Propagator, PWCPropagator

__all__ = ["PWCPropagatorBase", "IntervalStepper", "pwc_process_parameters"]


def pwc_process_parameters(parameters, controls, tlist) -> IdDict:
    """Build (or validate) the control → midpoint-values dict
    (reference ``src/pwc_utils.jl:29-45``)."""
    if parameters is None:
        parameters = IdDict(
            [(c, discretize_on_midpoints(c, tlist)) for c in controls]
        )
    else:
        if not isinstance(parameters, IdDict):
            parameters = IdDict(parameters)
        for c in controls:
            if c not in parameters:
                raise ValueError("parameters must contain all controls")
            if len(np.asarray(parameters[c])) != len(tlist) - 1:
                raise ValueError(
                    "each parameters value must be defined on the intervals "
                    "of tlist"
                )
    return parameters


class IntervalStepper(Propagator):
    """Interval-stepping implementation shared by piecewise propagators
    (and the interval bookkeeping of the time-continuous ODE
    propagator, which is NOT itself piecewise-constant)."""

    def __init__(
        self,
        state,
        generator,
        tlist,
        *,
        backward: bool = False,
        parameters=None,
    ):
        tlist = np.asarray(tlist, dtype=np.float64)
        if len(tlist) < 2:
            raise ValueError("tlist must have at least 2 points")
        self.tlist = tlist
        self.backward = bool(backward)
        self._generator = generator
        self.controls = get_controls(generator)
        self.parameters = pwc_process_parameters(parameters, self.controls, tlist)
        self.state = state
        nt = len(tlist)
        if backward:
            self.n = nt - 2
            self.t = float(tlist[-1])
        else:
            self.n = 0
            self.t = float(tlist[0])

    # -- time bookkeeping ---------------------------------------------------

    @property
    def _done(self) -> bool:
        nt = len(self.tlist)
        return (self.n < 0) if self.backward else (self.n > nt - 2)

    def _advance(self):
        """Move past the just-propagated interval
        (reference ``src/pwc_utils.jl:102-112``)."""
        if self.backward:
            self.t = float(self.tlist[self.n])
            self.n -= 1
        else:
            self.n += 1
            self.t = float(self.tlist[self.n])

    def set_t(self, t: float):
        """Set the current time, snapping (with a warning) to the
        nearest grid point (reference ``src/pwc_utils.jl:48-71``)."""
        tlist = self.tlist
        nt = len(tlist)
        t = float(t)
        if t <= tlist[0]:
            idx = 0
        elif t >= tlist[-1]:
            idx = nt - 1
        else:
            # snap UP to the first grid point >= t (reference
            # src/pwc_utils.jl:62, searchsortedfirst)
            idx = int(np.searchsorted(tlist, t, side="left"))
        if not np.isclose(t, tlist[idx], rtol=1.5e-8, atol=0.0):
            # rtol matches Julia isapprox (sqrt(eps)) for parity
            warnings.warn(f"Snapping t={t} to time grid value {tlist[idx]}")
        self.t = float(tlist[idx])
        self.n = idx - 1 if self.backward else idx

    # -- generator evaluation ----------------------------------------------

    def _interval_vals_dict(self, n: int) -> IdDict:
        vals = IdDict()
        for c in self.controls:
            vals[c] = float(np.asarray(self.parameters[c])[n])
        return vals

    def _interval_coeffs(self, n: int) -> np.ndarray:
        """Amplitude coefficients of the generator on interval ``n``
        (the analogue of ``_pwc_set_genop!``,
        ``src/pwc_utils.jl:86-99``)."""
        gen = self._generator
        if not isinstance(gen, Generator):
            if isinstance(gen, Operator):
                return np.asarray(gen.coeffs)
            return np.zeros((0,))
        vals = self._interval_vals_dict(n)
        coeffs = [
            evaluate(a, self.tlist, n, vals_dict=vals) for a in gen.amplitudes
        ]
        return np.asarray(coeffs)

    def _interval_terms(self) -> list:
        """The term operators of every interval: only the amplitudes of
        :meth:`_interval_coeffs` change from one interval to the next,
        and a graphed step takes them apart, as data."""
        gen = self._generator
        if isinstance(gen, (Generator, Operator)):
            return list(gen.ops)
        return [gen]

    def _amplitudes(self, n: int):
        """The amplitudes of interval ``n``, apart from the terms of
        :meth:`_interval_terms` (an :class:`Operator`'s coefficient tensor
        as it is)."""
        gen = self._generator
        if isinstance(gen, Operator) and isinstance(gen.coeffs, torch.Tensor):
            return gen.coeffs
        return self._interval_coeffs(n)

    def _interval_operator(self, n: int) -> Operator:
        gen = self._generator
        if isinstance(gen, Operator):
            return gen
        return Operator(self._interval_terms(), self._interval_coeffs(n))


class PWCPropagatorBase(IntervalStepper, PWCPropagator):
    """Common implementation for all piecewise-constant propagators."""
