"""Controls and time-grid semantics (the reference's L2 layer).

Host-side utilities implementing the exact discretization conventions of
the reference (``src/controls.jl``): values on the points
of a time grid ``tlist`` vs. values on the *midpoints* of its intervals,
with boundary-preserving "un-averaging" that makes repeated round-trips
bijective (``src/controls.jl:189-208``).

These run on the host in float64 numpy: in the TPU-native design, controls
are evaluated *once* at initialization into an ``(nt-1, n_terms)``
coefficient table that is fed to jitted propagation steps as a plain
array, so nothing here ever traces.

A callable control is called at :func:`control_time` of a host time: a
0-d float64 tensor, the port's counterpart of the JAX package's traced
scalar, so that a control written in ``torch`` math (``torch.sin(t)``)
takes it as a ``jnp.sin`` control takes a tracer, and ``numpy``,
``math`` and Python branches compute on it the values (and ``numpy``
the types) they compute on the float.

Index convention: intervals are 0-based here (``n`` in ``0..nt-2``),
unlike the 1-based Julia reference.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..utils.iddict import IdDict

__all__ = [
    "control_time",
    "discretize",
    "discretize_on_midpoints",
    "get_tlist_midpoints",
    "t_mid",
    "evaluate",
    "get_controls",
    "substitute",
    "get_parameters",
    "ParameterizedFunction",
]


def _as_float_array(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


class _Time(torch.Tensor):
    """A 0-d float64 tensor that ``numpy`` takes as the float it holds:
    an array times it is the array ``numpy`` makes of the float (a
    tensor's priority would refuse the product), and a ufunc of it
    returns the ``numpy`` scalar (a tensor's ``__array_wrap__`` would
    return a tensor, with a deprecation warning from NumPy 2).  A true
    division by zero raises as the float's does (a tensor's gives inf).
    ``torch`` math on it returns tensors."""

    __array_priority__ = -1

    def __array_wrap__(self, array, context=None, return_scalar=False):
        return array[()] if array.ndim == 0 else array

    def __truediv__(self, other):
        if _is_zero(other):
            return float(self) / 0.0  # raises ZeroDivisionError
        return super().__truediv__(other)

    def __rtruediv__(self, other):
        if _is_zero(self):
            return other / 0.0  # raises for a Python number
        return super().__rtruediv__(other)


def _is_zero(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dim() == 0 and x.device.type == "cpu" and bool(x == 0)
    return isinstance(x, (int, float, complex)) and x == 0


def control_time(t) -> torch.Tensor:
    """The host time ``t`` as every callable control is called with it: a
    0-d float64 tensor on the CPU (``float`` of it is ``t`` exactly)."""
    return torch.tensor(float(t), dtype=torch.float64).as_subclass(_Time)


def _value(x):
    """A control's value, a 0-d tensor as the Python number it holds (a
    ``numpy`` ufunc of a tensor returns a tensor)."""
    if isinstance(x, torch.Tensor) and x.dim() == 0:
        return x.item()
    return x


def _on_times(control, times) -> np.ndarray:
    return np.array([float(control(control_time(t))) for t in times],
                    dtype=np.float64)


def get_tlist_midpoints(
    tlist, *, preserve_start: bool = True, preserve_end: bool = True
) -> np.ndarray:
    """Midpoints of the intervals of ``tlist``.

    By default the first and last "midpoint" snap to the exact start/end
    of the grid to preserve boundary conditions (cf. reference
    ``src/controls.jl:92-124``).
    """
    tlist = _as_float_array(tlist)
    N = len(tlist)
    if N < 3:
        raise ValueError(
            "`tlist` must have a length of at least 3 in get_tlist_midpoints"
        )
    dts = np.diff(tlist)
    if np.any(dts <= 0):
        raise ValueError("`tlist` must be monotonically increasing")
    mid = tlist[:-1] + 0.5 * dts
    if preserve_start:
        mid[0] = tlist[0]
    if preserve_end:
        mid[-1] = tlist[-1]
    return mid


def t_mid(tlist, n: int) -> float:
    """Midpoint of the ``n``'th (0-based) interval of ``tlist``.

    Snaps to the grid start/end for the first/last interval, following
    the convention of :func:`discretize_on_midpoints` (reference
    ``src/controls.jl:332-343``).
    """
    tlist = np.asarray(tlist)
    n_intervals = len(tlist) - 1
    if not 0 <= n < n_intervals:
        raise IndexError(f"interval index {n} out of range [0, {n_intervals})")
    if n == 0:
        return float(tlist[0])
    if n == n_intervals - 1:
        return float(tlist[-1])
    return float(tlist[n] + 0.5 * (tlist[n + 1] - tlist[n]))


def discretize(control, tlist, *, via_midpoints: bool = True) -> np.ndarray:
    """Discretize ``control`` onto the points of ``tlist``.

    For a callable control the default path evaluates on the interval
    midpoints first and then averages back onto the grid points, so that
    round-trips with :func:`discretize_on_midpoints` are safe (reference
    ``src/controls.jl:43-68``).  A vector control of length ``nt-1``
    (midpoint values) is averaged onto the points (inverse of
    :func:`discretize_on_midpoints`); a vector of length ``nt`` is
    returned as a float64 copy.
    """
    tlist = _as_float_array(tlist)
    if callable(control):
        if via_midpoints:
            vals_on_midpoints = discretize_on_midpoints(control, tlist)
            return discretize(vals_on_midpoints, tlist)
        return _on_times(control, tlist)
    control = _as_float_array(control)
    if control.ndim != 1:
        raise ValueError("control array must be one-dimensional")
    nt = len(tlist)
    if len(control) == nt:
        return control.copy()
    if len(control) == nt - 1:
        vals = np.empty(nt, dtype=np.float64)
        vals[0] = control[0]
        vals[-1] = control[-1]
        vals[1:-1] = 0.5 * (control[:-1] + control[1:])
        return vals
    raise ValueError(
        f"control array (length {len(control)}) must be defined either on "
        f"`tlist` (length {nt}) or on the intervals of `tlist`"
    )


def discretize_on_midpoints(control, tlist) -> np.ndarray:
    """Discretize ``control`` onto the midpoints of the intervals of ``tlist``.

    For a vector control of length ``nt`` (values on the grid points),
    applies the boundary-preserving "un-averaging"
    ``p_i = 2 c_i - p_{i-1}`` with ``p_0 = c_0`` and ``p_last = c_last``
    (reference ``src/controls.jl:189-208``); this makes any *further*
    round trips with :func:`discretize` exactly bijective.
    """
    tlist = _as_float_array(tlist)
    nt = len(tlist)
    if callable(control):
        return _on_times(control, get_tlist_midpoints(tlist))
    control = _as_float_array(control)
    if control.ndim != 1:
        raise ValueError("control array must be one-dimensional")
    if len(control) == nt - 1:
        return control.copy()
    if len(control) == nt:
        vals = np.empty(nt - 1, dtype=np.float64)
        vals[0] = control[0]
        for i in range(1, nt - 2):
            vals[i] = 2.0 * control[i] - vals[i - 1]
        vals[-1] = control[-1]
        return vals
    raise ValueError(
        f"control array (length {len(control)}) must be defined on the points "
        f"of `tlist` (length {nt})"
    )


# --------------------------------------------------------------------------
# The `evaluate` protocol
# --------------------------------------------------------------------------

def evaluate(obj: Any, *args, vals_dict: IdDict | None = None):
    """Evaluate ``obj`` at a point in time.

    ``evaluate(control, t)`` for time-continuous evaluation;
    ``evaluate(control, tlist, n)`` for the midpoint of the (0-based)
    ``n``'th interval of ``tlist``.  A ``vals_dict`` (identity-keyed)
    overrides the value of any control ("plug in this value").

    Mirrors the protocol of reference ``src/controls.jl:240-429``:
    controls evaluate to floats, generators to static operators, static
    objects to themselves.  Objects implementing an ``_evaluate(*args,
    vals_dict)`` method (amplitudes, generators, parameterized
    functions) delegate to it.
    """
    if vals_dict is None:
        vals_dict = IdDict()
    if obj in vals_dict:
        return vals_dict[obj]
    custom = getattr(obj, "_evaluate", None)
    if custom is not None:
        return custom(*args, vals_dict=vals_dict)
    if isinstance(obj, (int, float, complex, np.number)):
        return obj
    if isinstance(obj, tuple) and len(obj) > 0 and not np.isscalar(obj[0]):
        # tuple-format generator `(H0, (H1, eps), ...)` evaluated
        # directly (reference src/controls.jl:429-455)
        return _evaluate_tuple_generator(obj, *args, vals_dict=vals_dict)
    if callable(obj):
        if len(args) == 1:
            return _value(obj(control_time(args[0])))
        if len(args) == 2:
            tlist, n = args
            return _value(obj(control_time(t_mid(tlist, int(n)))))
        raise TypeError("evaluate(control, ...) takes `t` or `(tlist, n)`")
    if isinstance(obj, (list, np.ndarray)) and np.ndim(obj) == 1:
        if len(args) != 2:
            raise ValueError(
                "`evaluate(control_vector, t)` is invalid; use "
                "`evaluate(control_vector, tlist, n)`"
            )
        tlist, n = args
        control = np.asarray(obj)
        nt = len(tlist)
        n = int(n)
        if len(control) == nt - 1:
            return float(control[n])
        if len(control) == nt:
            # convert this single point to its midpoint value
            if n == 0:
                return float(control[0])
            if n == nt - 2:
                return float(control[nt - 1])
            # un-average: p_n = 2 c_n - p_{n-1}; need recursion from start
            vals = discretize_on_midpoints(control, tlist)
            return float(vals[n])
        raise ValueError(
            f"control (length {len(control)}) must be discretized either on "
            f"`tlist` (length {nt}) or on the midpoints of `tlist`"
        )
    # Static objects (operators, arrays of dim > 1) evaluate to themselves
    return obj


def _evaluate_tuple_generator(parts: tuple, *args, vals_dict=None):
    """Evaluate ``(H0, (H1, eps), ...)`` to a static operator sum."""
    op = None
    for part in parts:
        if isinstance(part, tuple):
            if len(part) != 2:
                raise ValueError("time-dependent term must be a 2-tuple (op, ampl)")
            term_op, control = part
            coeff = evaluate(control, *args, vals_dict=vals_dict)
            if not isinstance(coeff, (int, float, complex, np.number)):
                raise TypeError(
                    f"control {control!r} does not evaluate to a number"
                )
            from ..ops.operators import scale_operator

            term = scale_operator(coeff, term_op)
        else:
            term = part
        if op is None:
            op = term
        else:
            from ..ops.operators import add_operators

            op = add_operators(op, term)
    return op


def get_controls(obj: Any) -> tuple:
    """Extract the tuple of controls from ``obj``.

    Controls are callables, 1D arrays, or :class:`ParameterizedFunction`
    instances.  Static operators and numbers contain no controls.
    Objects with a ``_get_controls()`` method (generators, amplitudes)
    delegate to it (reference ``src/controls.jl:222-235``).
    """
    custom = getattr(obj, "_get_controls", None)
    if custom is not None:
        return tuple(custom())
    if isinstance(obj, (int, float, complex, np.number)):
        return ()
    if isinstance(obj, tuple):
        # tuple-format generator: collect controls of (op, ampl) terms
        controls: list = []
        for part in obj:
            if isinstance(part, tuple) and len(part) == 2:
                for c in get_controls(part[1]):
                    if not any(c is k for k in controls):
                        controls.append(c)
        return tuple(controls)
    if callable(obj):
        return (obj,)
    if isinstance(obj, (list, np.ndarray)) and np.ndim(obj) == 1:
        return (obj,)
    return ()


def substitute(obj: Any, replacements: IdDict | dict):
    """Structurally replace controls/operators inside ``obj``.

    Returns ``replacements[obj]`` if ``obj`` itself is a key; otherwise
    recurses into container objects implementing ``_substitute``
    (reference ``src/controls.jl:497-515``).
    """
    if not isinstance(replacements, IdDict):
        replacements = IdDict(replacements)
    if obj in replacements:
        return replacements[obj]
    custom = getattr(obj, "_substitute", None)
    if custom is not None:
        return custom(replacements)
    return obj


class ParameterizedFunction:
    """Abstract base class for parameterized control functions.

    Subclasses implement ``__call__(self, t) -> float`` and hold their
    tunable parameters in ``self.parameters`` (a 1D float array, which
    optimal-control code may mutate/alias; reference
    ``src/controls.jl:644-649``).
    """

    parameters: np.ndarray

    def __call__(self, t: float) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    def _get_parameters(self):
        return self.parameters


class ParameterPartition(tuple):
    """A combined view over several parameter arrays (the analogue of
    the reference's ``RecursiveArrayTools.ArrayPartition`` combining,
    ``src/controls.jl:575-621``).

    It IS the tuple of the underlying arrays (so per-array access and
    identity checks keep working), and additionally exposes a flat
    1D-vector interface whose *writes alias through* to the underlying
    arrays — an optimizer can treat all tunable parameters of a
    generator as one vector while the controls see every update:

    >>> p = ParameterPartition((a, b))
    >>> v = p.as_vector()          # concatenated copy, for the optimizer
    >>> p.set_vector(v_new)        # scatters back INTO a and b in place
    """

    @property
    def n_params(self) -> int:
        return sum(np.asarray(a).size for a in self)

    def __array__(self, dtype=None, copy=None):
        if len(self) == 0:
            return np.zeros(0, dtype=dtype or np.float64)
        out = np.concatenate([np.ravel(np.asarray(a)) for a in self])
        return out if dtype is None else out.astype(dtype)

    def as_vector(self) -> np.ndarray:
        """Flat concatenated copy of all parameter values."""
        return np.asarray(self)

    def set_vector(self, values) -> None:
        """Scatter a flat vector back into the underlying arrays
        *in place* (controls holding the arrays see the update)."""
        values = np.asarray(values)
        if values.shape != (self.n_params,):
            raise ValueError(
                f"expected a flat vector of {self.n_params} values, "
                f"got shape {values.shape}"
            )
        off = 0
        for a in self:
            n = np.asarray(a).size
            a[...] = values[off:off + n].reshape(np.shape(a))
            off += n

    def flat_index(self, i: int) -> tuple:
        """Map a flat index to ``(array_position, within_array_index)``."""
        off = 0
        for k, a in enumerate(self):
            n = np.asarray(a).size
            if i < off + n:
                return k, i - off
            off += n
        raise IndexError(i)


def get_parameters(obj: Any) -> np.ndarray | tuple:
    """Collect the unique tunable parameter arrays from ``obj``.

    Recurses through the controls of ``obj``; parameter arrays are
    deduplicated *by identity*, so controls sharing a parameter array
    contribute it only once (reference ``src/controls.jl:575-621``).
    Returns a single array if exactly one was found, otherwise a
    :class:`ParameterPartition` (a tuple subclass with a combined
    flat-vector view, the ``ArrayPartition`` analogue).
    """
    seen: list = []

    def _collect(o):
        getter = getattr(o, "_get_parameters", None)
        if getter is not None:
            arrs = getter()
            if isinstance(arrs, (tuple, list)):
                candidates = arrs
            else:
                candidates = [arrs]
            for arr in candidates:
                if not any(arr is s for s in seen):
                    seen.append(arr)
        else:
            for c in get_controls(o):
                if c is not o:
                    _collect(c)

    _collect(obj)
    if len(seen) == 1:
        return seen[0]
    return ParameterPartition(seen)
