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
  tensor.

With neither flag, the variant is chosen as the JAX package chooses
it: each amplitude is called on an abstract time, a 0-d float64 tensor
on the ``meta`` device (the counterpart of ``jax.eval_shape``).
``torch.*`` math and constants compute there and integrate
continuously; ``numpy`` or ``math`` calls and Python branches on ``t``
raise there, and the propagator falls back to ``pwc=True`` with a
warning.  An explicit ``pwc=False`` integrates any callable of ``t``
continuously, also one that the JAX package (which must trace it)
refuses.

Each interval is one call of a graphed site (:func:`..utils.scan.graphed`
with ``loop=True``, the port of the JAX package's ``jax.jit`` of
``_pwc_ode_step`` and of ``_cont_step``): on the card the DP5 loop's
chunks of masked attempts replay a captured CUDA graph, the host reading
one flag a chunk.  The piecewise variant reads the interval's terms in
place and takes its amplitudes, ``t0`` and ``t1`` as data, so a
propagator captures once, and not again after ``reinit_prop`` or for
new controls.  The continuous variant's amplitudes are called at every
stage with ``t`` a 0-d float64 tensor on the state's device (inside the
graph: the JAX package's traced scalar), where they compute on an
abstract time; an explicit ``pwc=False`` with amplitudes that do not
(host math) has no JAX counterpart to port and runs the eager loop,
each stage time handed to them on the CPU.
"""

from __future__ import annotations

import numbers
import warnings

import numpy as np
import torch

from ..models.controls import control_time
from ..models.generators import Generator, Operator, _scalar
from ..ops.ode import dopri5_integrate
from ..ops.operators import DeviceCopies, apply, as_tensor, op_mesh
from ..utils.scan import graphed
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
        return _rhs(generator.ops, generator.amplitudes, c)
    return _rhs((generator,), (), c)


def _rhs(ops, amplitudes, c=-1j):
    """``f(t, Ψ) = c·Σ aₗ(t)·Ĥₗ·Ψ``, the first ``len(ops) −
    len(amplitudes)`` terms drift."""
    off = len(ops) - len(amplitudes)

    def f(t, psi):
        out = None
        for i, op in enumerate(ops):
            y = apply(op, psi)
            if i >= off:
                y = _scalar(amplitudes[i - off](t)) * y
            out = y if out is None else out + y
        return c * out

    return f


def _pwc_interval(ops, amps, psi, t0, t1, rtol, atol, max_steps):
    """One interval of the piecewise variant, ``-i·Σ aₗ·Ĥₗ`` frozen at the
    amplitudes ``amps`` (the JAX ``_pwc_ode_step``, jitted with the
    operator, ``t0`` and ``t1`` traced).  The amplitudes multiply as 0-d
    tensors on the state's device whether they come as a host array (the
    eager body) or as the graph's buffer, so both give the same bits."""
    op = Operator(list(ops), as_tensor(amps, device=psi.device))
    return dopri5_integrate(lambda t, y: -1j * op.apply(y), psi, t0, t1,
                            rtol=rtol, atol=atol, max_steps=max_steps)


def _continuous_interval(amplitudes, ops, psi, t0, t1, rtol, atol,
                         max_steps):
    """One interval of the continuous variant, ``H(t)`` evaluated at every
    stage time (the JAX ``_cont_step``)."""
    return dopri5_integrate(_rhs(ops, amplitudes), psi, t0, t1, rtol=rtol,
                            atol=atol, max_steps=max_steps)


def _at_host_time(amplitude):
    """``amplitude`` called with the stage time at :func:`control_time`,
    where host math (``numpy``, ``math``, a branch on ``t``) takes it."""
    return lambda t: amplitude(control_time(t))


def _check_amplitudes(generator, t):
    """Call every amplitude of ``generator`` at the 0-d tensor ``t``;
    returns the values, or raises what a call raises, or ``TypeError``
    for a value that is not a number or a 0-d tensor.  Touches neither
    the state nor the operators."""
    if not isinstance(generator, Generator):
        return []
    values = []
    for i, ampl in enumerate(generator.amplitudes):
        value = ampl(t)
        if not (isinstance(value, numbers.Number) or (
                isinstance(value, torch.Tensor) and value.dim() == 0)):
            raise TypeError(f"amplitude {i} returns {type(value)}, not a "
                            f"number")
        values.append(value)
    return values


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

    def _terms(self, ops):
        """``ops`` on the state's device: numpy terms copied there once
        (a copy at every matvec could not be captured)."""
        return tuple(self._copies(t, self.state.device) for t in ops)


class ODEPWCPropagator(_ODEBase, PWCPropagatorBase):
    """Piecewise-constant ODE propagation (reference
    ``ODEPWCPropagator``, ext ``:180-191``): the generator is frozen on
    each interval; adaptive integration within the interval.

    Every interval is one call of ``_step``, a graphed loop site over
    :func:`_pwc_interval`: on the card it replays captured chunks of
    the DP5 loop, with the terms read in place and the amplitudes,
    ``t0`` and ``t1`` as data (one capture a propagator); the eager
    body on the CPU, under autograd and for a generator sharded over
    more than one rank."""

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
        self._copies = DeviceCopies()
        self._step = graphed(_pwc_interval, mesh=op_mesh(generator),
                             operators=("ops",),
                             controls=("amps", "t0", "t1"), own_pool=True,
                             loop=True)

    def prop_step(self):
        if self._done:
            return None
        with self.timing_data.section("prop_step"):
            t0, t1 = self._interval_bounds(self.n)
            self.state = self._step(
                self._terms(self._interval_terms()),
                self._amplitudes(self.n), self.state, t0, t1, self.rtol,
                self.atol, self.max_steps)
            self._advance()
            return self.state


class ODEContinuousPropagator(_ODEBase, IntervalStepper):
    """Time-continuous ODE propagation (reference
    ``ODEContinuousPropagator``, ext ``:169-178``): ``H(t)`` is
    evaluated at every stage, so every amplitude must be a callable of
    ``t`` returning a number.  Not a piecewise propagator.

    The route of ``_step`` is chosen once, from the amplitudes.  Where
    they compute on an abstract time (:func:`_traceable`, the JAX
    package's condition for this variant), a graphed loop site over
    :func:`_continuous_interval`: on the card the stage time is a 0-d
    float64 tensor there and the amplitudes are called inside the
    captured chunk (one capture a propagator, ``t0`` and ``t1`` data).
    Otherwise (an explicit ``pwc=False`` with host math) the eager body,
    the amplitudes called at a time on the CPU: the JAX package refuses
    such amplitudes here, so there is no compiled site to port.  An
    amplitude that closes over a tensor requiring grad (a drive
    parameter to differentiate) also runs the eager body while autograd
    records: the site sees its arguments, not what a callable closes
    over, and a ``while_loop`` is differentiated eagerly."""

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
            with torch.enable_grad():
                values = _check_amplitudes(generator,
                                           control_time(np.asarray(tlist)[0]))
        except Exception as exc:
            raise ValueError(
                "Time-continuous ODE propagation evaluates H(t) at every "
                "integrator stage, so every amplitude must be a callable "
                "of t returning a number. For other controls, use "
                "`pwc=True` (piecewise-constant evaluation on interval "
                f"midpoints). Underlying error: {exc}"
            ) from None
        IntervalStepper.__init__(
            self, state, generator, tlist, backward=backward, parameters=parameters
        )
        self._init_ode(rtol, atol, max_steps)
        self._copies = DeviceCopies()
        if isinstance(generator, Generator):
            self._ops, amplitudes = tuple(generator.ops), generator.amplitudes
        else:
            self._ops, amplitudes = (generator,), ()
        self._closes_over_grad = any(
            isinstance(v, torch.Tensor) and v.requires_grad for v in values)
        if _traceable(generator):
            self._amplitude_fns = tuple(amplitudes)
            self._step = graphed(_continuous_interval,
                                 mesh=op_mesh(generator), operators=("ops",),
                                 controls=("t0", "t1"), own_pool=True,
                                 loop=True)
        else:
            self._amplitude_fns = tuple(_at_host_time(a) for a in amplitudes)
            self._step = _continuous_interval

    def prop_step(self):
        if self._done:
            return None
        with self.timing_data.section("prop_step"):
            t0, t1 = self._interval_bounds(self.n)
            step = self._step
            if self._closes_over_grad and torch.is_grad_enabled():
                step = getattr(step, "body", step)
            self.state = step(
                self._amplitude_fns, self._terms(self._ops), self.state, t0,
                t1, self.rtol, self.atol, self.max_steps)
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
