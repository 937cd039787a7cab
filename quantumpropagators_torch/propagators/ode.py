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
  called at each stage of the integrator.
"""

from __future__ import annotations

from ..models.generators import Generator
from ..ops.ode import dopri5_integrate
from ..ops.operators import apply, as_tensor
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
    of ``t`` returning a number."""
    if isinstance(generator, Generator):
        ops = generator.ops
        amplitudes = generator.amplitudes
        off = generator.drift_offset

        def f(t, psi):
            out = None
            for i, op in enumerate(ops):
                y = apply(op, psi)
                if i >= off:
                    y = complex(amplitudes[i - off](t)) * y
                out = y if out is None else out + y
            return c * out

        return f

    def f_static(t, psi):
        return c * apply(generator, psi)

    return f_static


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
        IntervalStepper.__init__(
            self, state, generator, tlist, backward=backward, parameters=parameters
        )
        self._init_ode(rtol, atol, max_steps)
        self._rhs = ode_function(generator)
        # fail fast with a clear message if an amplitude cannot be
        # evaluated at a time
        try:
            self._rhs(float(self.tlist[0]), state)
        except Exception as exc:
            raise ValueError(
                "Time-continuous ODE propagation evaluates H(t) at every "
                "integrator stage, so every amplitude must be a callable "
                "of t returning a number. For other controls, use "
                "`pwc=True` (piecewise-constant evaluation on interval "
                f"midpoints). Underlying error: {exc}"
            ) from None

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
    # If neither flag is given and an amplitude cannot be evaluated at a
    # time, fall back to the PWC variant with a warning.
    explicit = ("pwc" in kwargs) or ("piecewise" in kwargs)
    pwc = (kwargs.get("pwc") is True) or (kwargs.get("piecewise") is True)
    keep = ("backward", "parameters", "rtol", "atol", "max_steps")
    filtered = {k: v for k, v in kwargs.items() if k in keep}
    if pwc:
        return ODEPWCPropagator(state, generator, tlist, **filtered)
    try:
        return ODEContinuousPropagator(state, generator, tlist, **filtered)
    except ValueError:
        if explicit:
            raise
        import warnings

        warnings.warn(
            "ODE method: amplitudes cannot be evaluated as functions of "
            "t; falling back to piecewise-constant evaluation (pass "
            "pwc=True to silence)"
        )
        return ODEPWCPropagator(state, generator, tlist, **filtered)


register_method("ode", _factory)
