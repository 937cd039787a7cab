"""ODE propagator (PyTorch port of :mod:`quantumpropagators.propagators.ode`;
reference ``src/ode_function.jl`` + ``ext/QuantumPropagatorsODEExt.jl``).

Integrates ``i ∂ₜ|Ψ⟩ = H(t)|Ψ⟩`` with the adaptive Dormand-Prince
integrator (:mod:`..ops.ode`).  Two variants, as in the reference:

- ``pwc=True`` (the reference's ``ODEPWCPropagator``): the generator is
  held piecewise-constant on each interval (coefficients from the
  midpoint parameter dict), so arbitrary controls work; the integrator
  adapts *within* the interval.
- ``pwc=False`` (``ODEContinuousPropagator``): time-continuous ``H(t)``
  — every amplitude must be a callable of ``t`` returning a number,
  called at each stage of the integrator with ``t`` a 0-d float64
  tensor on the CPU.

With neither flag, the variant is chosen as the JAX package chooses
it: each amplitude is called on an abstract time, a 0-d float64 tensor
on the ``meta`` device (the counterpart of ``jax.eval_shape``).
``torch.*`` math and constants compute there and integrate
continuously; ``numpy`` or ``math`` calls and Python branches on ``t``
raise there, and the propagator falls back to ``pwc=True`` with a
warning.  An explicit ``pwc=False`` integrates any callable of ``t``
continuously, also one that the JAX package (which must trace it)
refuses.
"""

from __future__ import annotations

import numbers
import warnings

import numpy as np
import torch

from ..models.controls import (discretize_on_midpoints, get_controls,
                               get_tlist_midpoints)
from ..models.generators import Generator, _scalar
from ..ops.ode import dopri5_integrate
from ..ops.operators import apply, as_tensor
from ..utils.iddict import IdDict
from ..utils.timings import TimingData
from .base import register_method
from .pwc import IntervalStepper, PWCPropagatorBase

__all__ = [
    "ODEPropagator",
    "ODEPWCPropagator",
    "ODEContinuousPropagator",
    "ode_function",
]


def ode_function(generator, *, c=-1j):
    """Wrap ``generator`` as the RHS ``f(t, Ψ) = c·H(t)·Ψ`` (reference
    ``src/ode_function.jl:53-93``).  Every amplitude must be a callable
    of ``t`` (a 0-d float64 tensor, as :func:`..ops.ode.dopri5_integrate`
    passes it) returning a number; a tensor it returns multiplies its
    operator's term as it is."""
    if isinstance(generator, Generator):
        ops = generator.ops
        amplitudes = generator.amplitudes
        off = generator.drift_offset

        def f(t, psi):
            out = None
            for i, op in enumerate(ops):
                y = apply(op, psi)
                if i >= off:
                    y = _scalar(amplitudes[i - off](t)) * y
                out = y if out is None else out + y
            return c * out

        return f

    def f_static(t, psi):
        return c * apply(generator, psi)

    return f_static


def _check_amplitudes(generator, t):
    """Call every amplitude of ``generator`` at the 0-d tensor ``t``;
    raises what a call raises, or ``TypeError`` for a value that is not a
    number or a 0-d tensor.  Touches neither the state nor the
    operators."""
    if not isinstance(generator, Generator):
        return
    for i, ampl in enumerate(generator.amplitudes):
        value = ampl(t)
        if not (isinstance(value, numbers.Number) or (
                isinstance(value, torch.Tensor) and value.dim() == 0)):
            raise TypeError(f"amplitude {i} returns {type(value)}, not a "
                            f"number")


def _time(t):
    """``t`` as this variant's amplitudes take it: a 0-d float64 tensor
    on the CPU."""
    return torch.tensor(float(t), dtype=torch.float64)


def _midpoint_parameters(generator, tlist) -> IdDict:
    """The ``parameters`` dict of :class:`..pwc.IntervalStepper`, each
    callable control called at :func:`_time` of the midpoints, as the
    continuous integrator calls it: a ``torch.*`` control takes no Python
    float, and the rule may send it to either variant."""
    mids = get_tlist_midpoints(tlist)
    return IdDict([
        (c, np.array([float(c(_time(t))) for t in mids]) if callable(c)
         else discretize_on_midpoints(c, tlist))
        for c in get_controls(generator)])


def _traceable(generator) -> bool:
    """Whether every amplitude of ``generator`` computes on an abstract
    time, a 0-d float64 tensor on the ``meta`` device: the port's
    counterpart of the JAX package's ``jax.eval_shape`` of the RHS."""
    try:
        _check_amplitudes(generator, torch.empty((), dtype=torch.float64,
                                                 device="meta"))
    except Exception:  # any failure of a user's callable means "no"
        return False
    return True


class _ODEBase:
    def _init_ode(self, rtol, atol, max_steps):
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.max_steps = int(max_steps)
        self.timing_data = TimingData()

    def _interval_bounds(self, n):
        if self.backward:
            return float(self.tlist[n + 1]), float(self.tlist[n])
        return float(self.tlist[n]), float(self.tlist[n + 1])

    def _integrate(self, f, n):
        t0, t1 = self._interval_bounds(n)
        return dopri5_integrate(f, self.state, t0, t1, rtol=self.rtol,
                                atol=self.atol, max_steps=self.max_steps)


class ODEPWCPropagator(_ODEBase, PWCPropagatorBase):
    """Piecewise-constant ODE propagation (reference
    ``ODEPWCPropagator``, ext ``:180-191``): the generator is frozen on
    each interval; adaptive integration within the interval."""

    def __init__(
        self,
        state,
        generator,
        tlist,
        *,
        backward: bool = False,
        parameters=None,
        rtol: float = 1e-10,
        atol: float = 1e-10,
        max_steps: int = 100_000,
        **_ignored,
    ):
        if parameters is None:
            parameters = _midpoint_parameters(generator, tlist)
        PWCPropagatorBase.__init__(
            self, as_tensor(state), generator, tlist, backward=backward,
            parameters=parameters,
        )
        self._init_ode(rtol, atol, max_steps)

    def prop_step(self):
        if self._done:
            return None
        with self.timing_data.section("prop_step"):
            op = self._interval_operator(self.n)
            self.state = self._integrate(lambda t, y: -1j * apply(op, y),
                                         self.n)
            self._advance()
            return self.state


class ODEContinuousPropagator(_ODEBase, IntervalStepper):
    """Time-continuous ODE propagation (reference
    ``ODEContinuousPropagator``, ext ``:169-178``): ``H(t)`` is
    evaluated at every stage, so every amplitude must be a callable of
    ``t`` returning a number.  Not a piecewise propagator."""

    def __init__(
        self,
        state,
        generator,
        tlist,
        *,
        backward: bool = False,
        parameters=None,
        rtol: float = 1e-10,
        atol: float = 1e-10,
        max_steps: int = 100_000,
        **_ignored,
    ):
        state = as_tensor(state)
        # fail fast with a clear message if an amplitude cannot be
        # evaluated at a time
        try:
            _check_amplitudes(generator, _time(np.asarray(tlist)[0]))
        except Exception as exc:
            raise ValueError(
                "Time-continuous ODE propagation evaluates H(t) at every "
                "integrator stage, so every amplitude must be a callable "
                "of t returning a number. For other controls, use "
                "`pwc=True` (piecewise-constant evaluation on interval "
                f"midpoints). Underlying error: {exc}"
            ) from None
        if parameters is None:
            parameters = _midpoint_parameters(generator, tlist)
        IntervalStepper.__init__(
            self, state, generator, tlist, backward=backward, parameters=parameters
        )
        self._init_ode(rtol, atol, max_steps)
        self._rhs = ode_function(generator)

    def prop_step(self):
        if self._done:
            return None
        with self.timing_data.section("prop_step"):
            self.state = self._integrate(self._rhs, self.n)
            self._advance()
            return self.state


#: Union alias matching the reference's ``ODEPropagator``
ODEPropagator = (ODEPWCPropagator, ODEContinuousPropagator)


def _factory(state, generator, tlist, **kwargs):
    # reference default is time-continuous (`pwc=false`,
    # ext/QuantumPropagatorsODEExt.jl:101-106); `piecewise` is an alias.
    # With neither flag, amplitudes that do not compute on an abstract
    # time fall back to the PWC variant with a warning, as in the JAX
    # package; an explicit `pwc=False` integrates them continuously.
    explicit = ("pwc" in kwargs) or ("piecewise" in kwargs)
    pwc = (kwargs.get("pwc") is True) or (kwargs.get("piecewise") is True)
    keep = ("backward", "parameters", "rtol", "atol", "max_steps")
    filtered = {k: v for k, v in kwargs.items() if k in keep}
    if pwc:
        return ODEPWCPropagator(state, generator, tlist, **filtered)
    if not explicit and not _traceable(generator):
        warnings.warn(
            "ODE method: amplitudes are not torch-traceable; falling back "
            "to piecewise-constant evaluation (pass pwc=True to silence, "
            "use torch.* math in controls for time-continuous H(t), or "
            "pass pwc=False to integrate them continuously)"
        )
        return ODEPWCPropagator(state, generator, tlist, **filtered)
    return ODEContinuousPropagator(state, generator, tlist, **filtered)


register_method("ode", _factory)
