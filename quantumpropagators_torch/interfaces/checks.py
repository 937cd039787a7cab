"""Interface-contract checkers (PyTorch port of
:mod:`quantumpropagators.interfaces.checks`; reference
``src/interfaces/``).

Runtime verification that user-supplied states / operators / amplitudes /
controls / generators / propagators satisfy the contracts the
propagation methods rely on.  Every checker returns ``bool`` and logs
each violated clause through the ``quantumpropagators_torch.interfaces``
logger, with the same diagnostic strings as the JAX package.  States are
measured on host copies (:func:`~..ops.operators.host_np`), so tensors
on any device can be checked.
"""

from __future__ import annotations

import logging
import warnings

import numpy as np
import torch

from ..models.controls import (
    control_time,
    discretize,
    discretize_on_midpoints,
    evaluate,
    get_controls,
    get_parameters,
    substitute,
)
from ..models.generators import Generator, Operator, ScaledOperator
from ..ops.operators import apply, host_np, op_dot, op_shape, vdot
from ..utils.iddict import IdDict

logger = logging.getLogger("quantumpropagators_torch.interfaces")

__all__ = [
    "check_tlist",
    "check_state",
    "check_state_vector_interface",
    "check_operator",
    "check_generator",
    "check_amplitude",
    "check_control",
    "check_propagator",
    "check_parameterized_function",
    "check_parameterized",
    "supports_inplace",
]


def _err(quiet: bool, msg: str) -> None:
    if not quiet:
        logger.error(msg)


def supports_inplace(obj) -> bool:
    """Mutability trait (reference ``src/interfaces/supports_inplace.jl``).

    ``True`` for a host ``numpy`` array, as in the JAX package.  ``False``
    for a ``torch.Tensor``: a tensor could be written in place, but the
    port's propagators never mutate the caller's state (every step
    returns a new tensor), which is what the trait reports to callers
    deciding whether to hand over a buffer for reuse."""
    if isinstance(obj, np.ndarray):
        return True
    return False


def supports_vector_interface(obj) -> bool:
    """Trait: does ``obj`` implement the 1D array *read* interface
    (len / getitem / iteration), as required for states used with
    vector-interface-dependent observables (reference
    ``src/interfaces/supports_vector_interface.jl``)."""
    try:
        n = len(obj)
        _ = obj[0]
        it = iter(obj)
        next(it)
        return np.ndim(obj) == 1 and n >= 0
    except Exception:
        return False


def supports_matrix_interface(obj) -> bool:
    """Trait: does ``obj`` implement the 2D array *read* interface.
    Lazy :class:`~..models.generators.Operator` / ``ScaledOperator``
    forward to their densification (reference
    ``src/interfaces/supports_matrix_interface.jl:34-36``)."""
    if isinstance(obj, (Operator, ScaledOperator)):
        return True
    try:
        shape = obj.shape
        if len(shape) != 2:
            return False
        _ = obj[0, 0]
        return True
    except Exception:
        return False


def check_tlist(tlist, *, quiet: bool = False) -> bool:
    """``tlist`` must be a monotonically increasing float vector of at
    least 2 points (reference ``src/interfaces/tlist.jl:17-50``)."""
    ok = True
    try:
        arr = np.asarray(tlist, dtype=np.float64)
    except Exception as exc:
        _err(quiet, f"tlist cannot be converted to a float vector: {exc}")
        return False
    if arr.ndim != 1:
        _err(quiet, "tlist must be a 1D vector")
        ok = False
    elif len(arr) < 2:
        _err(quiet, "tlist must have at least 2 points")
        ok = False
    elif not np.all(np.diff(arr) > 0):
        _err(quiet, "tlist must be monotonically increasing")
        ok = False
    if ok and not np.all(np.isfinite(arr)):
        _err(quiet, "tlist must contain only finite values")
        ok = False
    return ok


def _state_dot(x, y) -> complex:
    """Inner product of a (possibly custom) state type.

    Uses the type's OWN ``dot`` method when defined (the axioms must
    exercise the type's implementation, reference
    ``src/interfaces/state.jl`` checks the methods, not a view);
    otherwise the array view."""
    fn = getattr(x, "dot", None)
    if fn is not None and not isinstance(x, (np.ndarray, torch.Tensor)):
        return complex(fn(y))
    return complex(np.vdot(host_np(x), host_np(y)))


def _state_norm(x) -> float:
    fn = getattr(x, "norm", None)
    if fn is not None and not isinstance(x, torch.Tensor):
        return float(fn())
    return float(np.linalg.norm(host_np(x)))


def check_state(state, *, normalized: bool = False, quiet: bool = False) -> bool:
    """Verify the Hilbert-space axioms for a state (reference
    ``src/interfaces/state.jl``): inner product / norm consistency,
    linear combinations, scalar multiplication, copies.

    Custom state types must be array-convertible (``__array__``) and
    support ``+``, ``-``, and scalar ``*`` with their own semantics —
    the axioms exercise the type's arithmetic; measurement goes through
    the array view.
    """
    ok = True
    try:
        ip = _state_dot(state, state)
    except Exception as exc:
        _err(quiet, f"the inner product of a state with itself must be defined: {exc}")
        return False
    if not np.iscomplexobj(host_np(state)):
        _err(
            quiet,
            "the inner product of two states must be a complex number "
            "(the state must have a complex dtype)",
        )
        ok = False
    if abs(ip.imag) > 1e-9 * max(1.0, abs(ip)):
        _err(
            quiet,
            "dot(state, state) must be real (the inner product must "
            "conjugate its first argument)",
        )
        ok = False
    try:
        nrm = _state_norm(state)
        if not np.isfinite(nrm):
            _err(quiet, "the norm of a state must be finite")
            ok = False
        elif not np.isclose(nrm, np.sqrt(abs(ip)), rtol=1e-9, atol=1e-12):
            _err(quiet, "norm(state) must equal sqrt(dot(state, state))")
            ok = False
        if normalized and not np.isclose(nrm, 1.0, atol=1e-9):
            _err(quiet, f"the state must be normalized, got norm {nrm}")
            ok = False
    except Exception as exc:
        _err(quiet, f"the norm of a state must be defined: {exc}")
        ok = False
    try:
        two = state + state
        zero = state - state
        if not np.allclose(host_np(two), 2 * host_np(state)):
            _err(quiet, "state + state must equal 2 * state")
            ok = False
        if _state_norm(zero) > 1e-12 * max(1.0, _state_norm(state)):
            _err(quiet, "state - state must have norm 0")
            ok = False
    except Exception as exc:
        _err(quiet, f"states must support addition and subtraction: {exc}")
        ok = False
    try:
        scaled = 0.5j * state
        hom = _state_norm(scaled) - 0.5 * _state_norm(state)
        if abs(hom) > 1e-9 * max(1.0, _state_norm(state)):
            _err(quiet, "norm must be homogeneous: ‖αΨ‖ = |α|·‖Ψ‖")
            ok = False
    except Exception as exc:
        _err(quiet, f"states must support scalar multiplication: {exc}")
        ok = False
    try:
        a, b = state, 1j * state
        lhs = _state_norm(a + b)
        rhs = _state_norm(a) + _state_norm(b)
        if lhs > rhs + 1e-9:
            _err(quiet, "the triangle inequality must hold")
            ok = False
    except Exception:
        pass
    # states exposing a 1D read interface must implement it faithfully
    # (reference src/interfaces/state.jl:393-598)
    if hasattr(state, "__len__") and host_np(state).ndim == 1:
        if not check_state_vector_interface(state, quiet=quiet):
            ok = False
    return ok


def check_state_vector_interface(state, *, quiet: bool = False) -> bool:
    """Verify the 1D read interface of a state (reference
    ``src/interfaces/state.jl:393-598``): length, indexing, iteration,
    dtype — required for vector-interface-dependent observables and
    storage layouts."""
    ok = True
    try:
        n = len(state)
        if n <= 0:
            _err(quiet, "a state must have positive length")
            ok = False
    except Exception as exc:
        _err(quiet, f"len(state) must be defined: {exc}")
        return False
    try:
        v0 = state[0]
        complex(v0)
    except Exception as exc:
        _err(quiet, f"state[i] must return a number: {exc}")
        ok = False
    try:
        count = sum(1 for _ in state)
        if count != n:
            _err(quiet, "iterating a state must yield len(state) entries")
            ok = False
    except Exception as exc:
        _err(quiet, f"a state must be iterable: {exc}")
        ok = False
    try:
        arr = host_np(state)
        if arr.shape != (n,):
            _err(quiet, "np.asarray(state) must give a 1D array of len(state)")
            ok = False
        if not np.iscomplexobj(arr):
            _err(quiet, "the array view of a state must be complex")
            ok = False
    except Exception as exc:
        _err(quiet, f"a state must be array-convertible: {exc}")
        ok = False
    return ok


def check_operator(
    op,
    *,
    state=None,
    tlist=None,
    for_expval: bool = True,
    quiet: bool = False,
) -> bool:
    """Verify the static-operator contract (reference
    ``src/interfaces/operator.jl``): shape, time independence, no
    controls, action on a state, expectation values."""
    ok = True
    try:
        shape = op_shape(op)
        if len(shape) != 2 or shape[0] != shape[1]:
            _err(quiet, f"operator must be square, got shape {shape}")
            ok = False
    except Exception as exc:
        _err(quiet, f"operator must have a shape: {exc}")
        return False
    if tlist is None:
        tlist = np.array([0.0, 1.0])
    try:
        ev = evaluate(op, tlist, 0)
        if ev is not op:
            _err(quiet, "a static operator must evaluate to itself")
            ok = False
    except Exception as exc:
        _err(quiet, f"evaluate(op, tlist, n) must be defined: {exc}")
        ok = False
    if get_controls(op) != ():
        _err(quiet, "a static operator must not contain any controls")
        ok = False
    if state is not None:
        try:
            phi = apply(op, state)
            if host_np(phi).shape != host_np(state).shape:
                _err(quiet, "op @ state must return a state of the same shape")
                ok = False
        except Exception as exc:
            _err(quiet, f"an operator must be applicable to a state: {exc}")
            ok = False
            return ok
        try:
            # linearity: op @ (α ψ) == α (op @ ψ) (reference
            # src/interfaces/operator.jl mul! axioms)
            lhs = host_np(apply(op, 2.0 * state)).astype(complex)
            rhs = 2.0 * host_np(phi).astype(complex)
            scale = max(1.0, float(np.linalg.norm(rhs)))
            if np.linalg.norm(lhs - rhs) > 1e-9 * scale:
                _err(quiet, "op @ state must be linear in the state")
                ok = False
        except Exception as exc:
            _err(quiet, f"op @ state must be linear in the state: {exc}")
            ok = False
        if for_expval:
            try:
                e1 = complex(op_dot(state, op, state))
                e2 = complex(vdot(state, apply(op, state)))
                if not np.isclose(e1, e2, rtol=1e-9, atol=1e-12):
                    _err(
                        quiet,
                        "dot(state, op, state) must match dot(state, op @ state)",
                    )
                    ok = False
            except Exception as exc:
                _err(quiet, f"op must support expectation values: {exc}")
                ok = False
    return ok


def check_control(
    control, *, tlist, for_time_continuous: bool = False, quiet: bool = False
) -> bool:
    """Verify the control contract (reference
    ``src/interfaces/control.jl``): float evaluation on intervals,
    ``vals_dict`` override, discretization sizes and finiteness."""
    ok = True
    tlist = np.asarray(tlist, dtype=np.float64)
    try:
        val = evaluate(control, tlist, 0)
        float(val)
    except Exception as exc:
        _err(quiet, f"evaluate(control, tlist, n) must return a float: {exc}")
        return False
    try:
        vals_dict = IdDict([(control, 4.2)])
        v = evaluate(control, tlist, 0, vals_dict=vals_dict)
        if float(v) != 4.2:
            _err(quiet, "evaluate must honor a vals_dict override")
            ok = False
    except Exception as exc:
        _err(quiet, f"evaluate with vals_dict must work: {exc}")
        ok = False
    try:
        d = discretize(control, tlist)
        if len(d) != len(tlist):
            _err(quiet, "discretize(control, tlist) must have len(tlist) values")
            ok = False
        if not np.all(np.isfinite(d)):
            _err(quiet, "discretized control values must be finite")
            ok = False
        dm = discretize_on_midpoints(control, tlist)
        if len(dm) != len(tlist) - 1:
            _err(
                quiet,
                "discretize_on_midpoints(control, tlist) must have "
                "len(tlist)-1 values",
            )
            ok = False
    except Exception as exc:
        _err(quiet, f"control must support discretization: {exc}")
        ok = False
    if for_time_continuous and callable(control):
        try:
            float(evaluate(control, float(tlist[0])))
        except Exception as exc:
            _err(quiet, f"evaluate(control, t) must return a float: {exc}")
            ok = False
    return ok


def check_amplitude(
    ampl, *, tlist, for_time_continuous: bool = False, quiet: bool = False
) -> bool:
    """Verify the amplitude contract (reference
    ``src/interfaces/amplitude.jl``): controls tuple, substitution,
    numeric evaluation on intervals."""
    ok = True
    tlist = np.asarray(tlist, dtype=np.float64)
    try:
        raw = getattr(ampl, "_get_controls", None)
        controls = raw() if raw is not None else get_controls(ampl)
        if not isinstance(controls, tuple):
            _err(quiet, "get_controls(ampl) must return a tuple")
            ok = False
    except Exception as exc:
        _err(quiet, f"get_controls(ampl) must be defined: {exc}")
        return False
    for c in get_controls(ampl):
        if not check_control(c, tlist=tlist, quiet=quiet):
            _err(quiet, "every control in the amplitude must pass check_control")
            ok = False
    try:
        replaced = substitute(ampl, IdDict([(ampl, ampl)]))
        if replaced is not ampl:
            _err(quiet, "substitute(ampl, {ampl: ampl}) must return ampl")
            ok = False
    except Exception as exc:
        _err(quiet, f"substitute(ampl, replacements) must be defined: {exc}")
        ok = False
    try:
        # identity substitution of the CONTROLS goes through the
        # amplitude's own _substitute and must return a working
        # amplitude (reference src/interfaces/amplitude.jl substitution
        # round-trip)
        reps = IdDict([(c, c) for c in get_controls(ampl)])
        replaced = substitute(ampl, reps)
        if get_controls(replaced) != get_controls(ampl) or not np.isclose(
            complex(evaluate(replaced, tlist, 0)),
            complex(evaluate(ampl, tlist, 0)),
        ):
            _err(
                quiet,
                "substitute(ampl, {controls: controls}) must return an "
                "equivalent amplitude",
            )
            ok = False
    except Exception as exc:
        _err(
            quiet,
            f"substitute(ampl, replacements) must return an amplitude: {exc}",
        )
        ok = False
    try:
        v = evaluate(ampl, tlist, 0)
        complex(v)
    except Exception as exc:
        _err(quiet, f"evaluate(ampl, tlist, n) must return a number: {exc}")
        ok = False
    if for_time_continuous:
        try:
            complex(evaluate(ampl, float(tlist[0])))
        except Exception as exc:
            _err(quiet, f"evaluate(ampl, t) must return a number: {exc}")
            ok = False
    return ok


def check_generator(
    generator,
    *,
    state,
    tlist,
    for_parameterization: bool = False,
    for_time_continuous: bool = False,
    quiet: bool = False,
) -> bool:
    """Verify the generator contract (reference
    ``src/interfaces/generator.jl``): controls extraction, substitution
    round-trip, evaluation to a valid operator at interval midpoints."""
    ok = True
    tlist = np.asarray(tlist, dtype=np.float64)
    try:
        controls = get_controls(generator)
        if not isinstance(controls, tuple):
            _err(quiet, "get_controls(generator) must return a tuple")
            ok = False
    except Exception as exc:
        _err(quiet, f"get_controls(generator) must be defined: {exc}")
        return False
    for c in get_controls(generator):
        if not check_control(
            c, tlist=tlist, for_time_continuous=for_time_continuous, quiet=quiet
        ):
            _err(quiet, "every control in the generator must pass check_control")
            ok = False
    try:
        same = substitute(generator, IdDict([(generator, generator)]))
        if same is not generator:
            _err(quiet, "substitute(generator, {generator: generator}) must round-trip")
            ok = False
    except Exception as exc:
        _err(quiet, f"substitute(generator, replacements) must be defined: {exc}")
        ok = False
    try:
        op = evaluate(generator, tlist, 0)
        if not check_operator(op, state=state, tlist=tlist, quiet=quiet):
            _err(quiet, "the generator must evaluate to a valid operator")
            ok = False
    except Exception as exc:
        _err(quiet, f"evaluate(generator, tlist, n) must be defined: {exc}")
        ok = False
    if for_time_continuous:
        try:
            evaluate(generator, float(tlist[0]))
        except Exception as exc:
            _err(quiet, f"evaluate(generator, t) must be defined: {exc}")
            ok = False
    if for_parameterization:
        try:
            get_parameters(generator)
        except Exception as exc:
            _err(quiet, f"get_parameters(generator) must be defined: {exc}")
            ok = False
    if isinstance(generator, Generator):
        for ampl in generator.amplitudes:
            if not check_amplitude(ampl, tlist=tlist, quiet=quiet):
                _err(quiet, "every amplitude in the generator must pass check_amplitude")
                ok = False
    return ok


def check_parameterized_function(func, *, tlist, quiet: bool = False) -> bool:
    """Verify a :class:`ParameterizedFunction` (reference
    ``src/interfaces/parameterization.jl``): ``parameters`` array field
    aliased by ``get_parameters``, callable ``f(t) -> float``."""
    from ..models.controls import ParameterizedFunction

    ok = True
    if not isinstance(func, ParameterizedFunction):
        _err(quiet, "func must be an instance of ParameterizedFunction")
        ok = False
    params = getattr(func, "parameters", None)
    if params is None:
        _err(quiet, "func must have a `parameters` field")
        return False
    collected = get_parameters(func)
    if collected is not params:
        _err(quiet, "get_parameters(func) must alias func.parameters")
        ok = False
    try:
        float(func(control_time(np.asarray(tlist)[0])))
    except Exception as exc:
        _err(quiet, f"func(t) must return a float: {exc}")
        ok = False
    return ok


def check_parameterized(obj, *, quiet: bool = False) -> bool:
    """Verify that mutating the collected parameters of ``obj`` mutates
    the object's controls (parameter aliasing contract)."""
    ok = True
    params = get_parameters(obj)
    arrays = params if isinstance(params, tuple) else (params,)
    for arr in arrays:
        try:
            a = host_np(arr)
            if a.ndim != 1:
                _err(quiet, "parameter arrays must be 1D")
                ok = False
        except Exception as exc:
            _err(quiet, f"parameters must be array-like: {exc}")
            ok = False
    return ok


def _distance(x, y) -> float:
    """``‖x − y‖`` of two states, on host copies."""
    return float(np.linalg.norm(host_np(x) - host_np(y)))


def check_propagator(propagator, *, atol: float = 1e-9, quiet: bool = False) -> bool:
    """Verify the full behavioral propagator contract (reference
    ``src/interfaces/propagator.jl:55-337``):

    - required properties (``state``, ``tlist``, ``t``, ``parameters``,
      ``backward``)
    - ``prop_step()`` advances ``t`` by exactly one grid point and
      returns the new state; returns ``None`` past the end of the grid
    - ``set_state`` replaces the state; ``set_t`` moves on the grid
    - ``reinit_prop`` restores the initial position idempotently

    States are compared on host copies, so a propagator whose state is a
    CUDA tensor (or a sharded ``(n_local, N/n)`` tensor) is checked the
    same way."""
    from ..propagators.base import reinit_prop

    ok = True
    for prop_name in ("state", "tlist", "t", "parameters", "backward"):
        if not hasattr(propagator, prop_name):
            _err(quiet, f"propagator must have property `{prop_name}`")
            ok = False
    if not ok:
        return False
    tlist = np.asarray(propagator.tlist)
    nt = len(tlist)
    backward = bool(propagator.backward)
    t_start = tlist[-1] if backward else tlist[0]
    if not np.isclose(propagator.t, t_start, atol=atol):
        _err(
            quiet,
            f"propagator.t must start at {'tlist[-1]' if backward else 'tlist[0]'}",
        )
        ok = False
    psi0 = propagator.state
    psi = propagator.prop_step()
    if psi is None:
        _err(quiet, "prop_step() must return a state while t is inside the grid")
        return False
    expected_t = tlist[-2] if backward else tlist[1]
    if not np.isclose(propagator.t, expected_t, atol=atol):
        _err(quiet, "prop_step() must advance t by exactly one grid point")
        ok = False
    if not check_state(psi, quiet=quiet):
        _err(quiet, "prop_step() must return a valid state")
        ok = False
    if host_np(psi).shape != host_np(psi0).shape:
        _err(
            quiet,
            "prop_step() must return a state of the same shape as the "
            "initial state",
        )
        ok = False
    # run to the end of the grid
    steps = 1
    while steps < nt - 1:
        psi = propagator.prop_step()
        if psi is None:
            _err(quiet, "prop_step() returned None before the end of the grid")
            ok = False
            break
        steps += 1
    end = propagator.prop_step()
    if end is not None:
        _err(quiet, "prop_step() must return None past the end of the grid")
        ok = False
    t_end = tlist[0] if backward else tlist[-1]
    if not np.isclose(propagator.t, t_end, atol=atol):
        _err(quiet, "after the last step, t must be at the end of the grid")
        ok = False
    # set_t: exact mid-grid jump, and snap-with-warning for off-grid
    # times (reference src/interfaces/propagator.jl set_t! contract +
    # src/pwc_utils.jl:48-71 snapping)
    try:
        mid = nt // 2
        propagator.set_t(tlist[mid])
        if not np.isclose(propagator.t, tlist[mid], atol=atol):
            _err(quiet, "set_t to a grid point must set t exactly")
            ok = False
        if nt >= 3:
            t_off = 0.5 * (tlist[mid] + tlist[mid + 1])
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                propagator.set_t(t_off)
            on_grid = bool(np.any(np.isclose(tlist, propagator.t, atol=atol)))
            if on_grid and not np.isclose(propagator.t, t_off, atol=atol):
                # piecewise propagators must snap AND warn
                if not any("Snap" in str(w.message) for w in caught):
                    _err(
                        quiet,
                        "set_t to an off-grid time must warn when "
                        "snapping to the grid",
                    )
                    ok = False
            elif not on_grid and not np.isclose(
                propagator.t, t_off, atol=atol
            ):
                _err(quiet, "set_t must set t (to the value or a grid snap)")
                ok = False
    except Exception as exc:
        _err(quiet, f"set_t must be defined: {exc}")
        ok = False
    # set_state: must take effect even when the current state differs
    # (probe with a state that is NOT the propagator's current one, so
    # a no-op set_state cannot pass by accident)
    try:
        probe = (1j) * psi0
        propagator.set_state(probe)
        if _distance(propagator.state, probe) > atol:
            _err(quiet, "set_state must replace the propagator's state")
            ok = False
        propagator.set_state(psi0)
        if _distance(propagator.state, psi0) > atol:
            _err(quiet, "set_state must replace the propagator's state")
            ok = False
    except Exception as exc:
        _err(quiet, f"set_state must be defined: {exc}")
        ok = False
    # reinit (idempotency required by contract)
    try:
        reinit_prop(propagator, psi0)
        if not np.isclose(propagator.t, t_start, atol=atol):
            _err(quiet, "reinit_prop must reset t to the start of the grid")
            ok = False
        reinit_prop(propagator, psi0)
        if not np.isclose(propagator.t, t_start, atol=atol):
            _err(quiet, "reinit_prop must be idempotent")
            ok = False
    except Exception as exc:
        _err(quiet, f"reinit_prop must be defined: {exc}")
        ok = False
    if isinstance(propagator.parameters, IdDict):
        for c in propagator.parameters:
            vals = host_np(propagator.parameters[c])
            if len(vals) != nt - 1:
                _err(
                    quiet,
                    "piecewise propagator parameters must map controls to "
                    "nt-1 interval values",
                )
                ok = False
    return ok
