"""Non-trivial control amplitudes (reference ``src/amplitudes.jl``).

An *amplitude* is the coefficient ``aₗ(t)`` of a generator term, which
may differ from a bare control ``ϵₗ(t)``:

- :class:`LockedAmplitude` — time-dependent but *not* a control (not
  tunable by optimal control; empty ``get_controls``), e.g. a fixed
  shape (reference ``src/amplitudes.jl:27-89``).
- :class:`ShapedAmplitude` — ``a(t) = S(t)·ϵ(t)`` with a static shape
  modulating a tunable control (``:131-258``).
- :class:`GuidedAmplitude` — ``a(t) = G(t) + S(t)·ϵ(t)``: a fixed guide
  field plus a shaped tunable correction (``:285-482``).

Each accepts callables or midpoint-discretized vectors for every slot,
and an optional ``tlist`` constructor argument to discretize callables
immediately.
"""

from __future__ import annotations

import numpy as np

from .controls import (
    discretize_on_midpoints,
    evaluate,
    get_controls,
    substitute,
)

__all__ = ["LockedAmplitude", "ShapedAmplitude", "GuidedAmplitude", "ControlAmplitude"]


def _is_vector(x) -> bool:
    return isinstance(x, (list, np.ndarray)) and np.ndim(x) == 1


def _eval_slot(slot, *args, vals_dict=None):
    """Evaluate a shape/guide/control slot at a point in time."""
    if _is_vector(slot):
        if len(args) != 2:
            raise ValueError(
                "an amplitude with a vector component can only be evaluated "
                "with (tlist, n)"
            )
        tlist, n = args
        vec = np.asarray(slot)
        if len(vec) != len(tlist) - 1:
            raise ValueError(
                "vector amplitude components must be discretized on the "
                "midpoints of tlist"
            )
        return float(vec[int(n)])
    return evaluate(slot, *args, vals_dict=vals_dict)


class ControlAmplitude:
    """Abstract base for amplitudes wrapping a tunable control."""

    def _substitute(self, replacements):
        if self in replacements:
            return replacements[self]
        kwargs = {
            k: substitute(v, replacements) for k, v in self._parts().items()
        }
        return type(self)._from_parts(**kwargs)

    def _parts(self) -> dict:  # pragma: no cover - abstract
        raise NotImplementedError


class LockedAmplitude:
    """A time-dependent amplitude that is not a control.

    ``LockedAmplitude(shape)`` wraps a callable ``S(t)``;
    ``LockedAmplitude(shape, tlist)`` discretizes it onto the midpoints
    of ``tlist`` (after which only ``(tlist, n)`` evaluation is valid).
    """

    def __init__(self, shape, tlist=None):
        if tlist is not None:
            shape = discretize_on_midpoints(shape, tlist)
        elif not (callable(shape) or _is_vector(shape)):
            raise ValueError("shape must be a callable or a vector")
        self.shape = shape

    def _get_controls(self):
        return ()

    def _evaluate(self, *args, vals_dict=None):
        return _eval_slot(self.shape, *args, vals_dict=vals_dict)

    def _substitute(self, replacements):
        if self in replacements:
            return replacements[self]
        return LockedAmplitude(substitute(self.shape, replacements))

    def __repr__(self):
        return f"LockedAmplitude({self.shape!r})"


class ShapedAmplitude(ControlAmplitude):
    """``a(t) = S(t) · ϵ(t)`` — a static shape modulating a control.

    ``ShapedAmplitude(control, shape=...)``, or
    ``ShapedAmplitude(control, tlist, shape=...)`` to discretize both
    control and shape onto midpoints.
    """

    def __init__(self, control, tlist=None, *, shape):
        if tlist is not None:
            control = discretize_on_midpoints(control, tlist)
            shape = discretize_on_midpoints(shape, tlist)
        else:
            if not (callable(shape) or _is_vector(shape)):
                raise ValueError("shape must be a callable or a vector")
            if _is_vector(control) and callable(shape):
                raise ValueError(
                    "a vector control requires a vector shape (or pass tlist)"
                )
        self.control = control
        self.shape = shape

    def _parts(self):
        return {"control": self.control, "shape": self.shape}

    @classmethod
    def _from_parts(cls, control, shape):
        return cls(control, shape=shape)

    def _get_controls(self):
        return get_controls(self.control)

    def _evaluate(self, *args, vals_dict=None):
        S = _eval_slot(self.shape, *args, vals_dict=vals_dict)
        eps = evaluate(self.control, *args, vals_dict=vals_dict)
        return S * eps

    def __repr__(self):
        return f"ShapedAmplitude({self.control!r}, shape={self.shape!r})"


class GuidedAmplitude(ControlAmplitude):
    """``a(t) = G(t) + S(t) · ϵ(t)`` — a fixed guide field plus a shaped
    tunable correction.  Only ``ϵ`` is a control; ``G`` and ``S`` are
    locked."""

    def __init__(self, control, tlist=None, *, shape, guide):
        if tlist is not None:
            control = discretize_on_midpoints(control, tlist)
            shape = discretize_on_midpoints(shape, tlist)
            guide = discretize_on_midpoints(guide, tlist)
        else:
            for name, slot in (("shape", shape), ("guide", guide)):
                if not (callable(slot) or _is_vector(slot)):
                    raise ValueError(f"{name} must be a callable or a vector")
        self.control = control
        self.shape = shape
        self.guide = guide

    def _parts(self):
        return {"control": self.control, "shape": self.shape, "guide": self.guide}

    @classmethod
    def _from_parts(cls, control, shape, guide):
        return cls(control, shape=shape, guide=guide)

    def _get_controls(self):
        return get_controls(self.control)

    def _evaluate(self, *args, vals_dict=None):
        G = _eval_slot(self.guide, *args, vals_dict=vals_dict)
        S = _eval_slot(self.shape, *args, vals_dict=vals_dict)
        eps = evaluate(self.control, *args, vals_dict=vals_dict)
        return G + S * eps

    def __repr__(self):
        return (
            f"GuidedAmplitude({self.control!r}, shape={self.shape!r}, "
            f"guide={self.guide!r})"
        )
