"""Interface-contract checkers (PyTorch port of the part of
:mod:`quantumpropagators.interfaces.checks` that ``propagate(check=True)``
reaches; reference ``src/interfaces/``).

Runtime verification that user-supplied states / operators / amplitudes /
controls / generators satisfy the contracts the propagation methods rely
on.  Every checker returns ``bool`` and logs each violated clause through
the ``quantumpropagators.interfaces`` logger, with the same diagnostic
strings as the JAX package.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..models.controls import (
    discretize,
    discretize_on_midpoints,
    evaluate,
    get_controls,
    get_parameters,
    substitute,
)
from ..models.generators import Generator
from ..ops.operators import apply, host_np, op_dot, op_shape, vdot
from ..utils.iddict import IdDict

logger = logging.getLogger("quantumpropagators.interfaces")

__all__ = [
    "check_tlist",
    "check_state",
    "check_state_vector_interface",
    "check_operator",
    "check_generator",
    "check_amplitude",
    "check_control",
]


def _err(quiet: bool, msg: str) -> None:
    if not quiet:
        logger.error(msg)


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
