"""Propagator base types, method registry, and the ``init_prop`` entry
(PyTorch port of :mod:`quantumpropagators.propagators.base`).

The L5 layer (reference ``src/propagator.jl``): a *propagator* is a
stateful stepping object with the contract

- properties ``state``, ``tlist``, ``t``, ``parameters``, ``backward``
- ``prop_step()`` advances one interval and returns the new state, or
  ``None`` past the end of the grid
- ``set_state(state)`` / ``set_t(t)`` mutate position
- ``reinit_prop(propagator, state, **kw)`` re-arms for a new propagation

Propagator objects are host-side objects holding static configuration
and interval bookkeeping; the O(N) numerical work runs on the state's
device.  Method selection is an
open registry dict (``register_method``), replacing the reference's
``Val``-based dispatch (``src/propagator.jl:208-264``) with the same
"new methods register an init function" extensibility.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

import numpy as np

__all__ = [
    "Propagator",
    "PiecewisePropagator",
    "PWCPropagator",
    "register_method",
    "init_prop",
    "prop_step",
    "set_state",
    "set_t",
    "reinit_prop",
    "get_uniform_dt",
]


class Propagator:
    """Abstract propagator (reference ``src/propagator.jl:48-74``).

    Subclasses must set ``state``, ``tlist``, ``t``, ``parameters``,
    ``backward`` and implement ``prop_step`` / ``_reinit``.  Access to
    the original generator is deliberately not part of the interface
    (the reference's "property firewall",
    ``src/propagator.jl:77-86``).
    """

    state: Any
    tlist: np.ndarray
    t: float
    parameters: Any
    backward: bool

    def prop_step(self):
        raise NotImplementedError

    def set_state(self, state):
        """Replace the current state (does not change ``t``)."""
        self.state = state
        return self.state

    def set_t(self, t: float):
        raise NotImplementedError

    def _reinit(self, state, **kwargs):
        """Reset to ``state`` at the start (or end, if backward) of the
        time grid."""
        self.set_state(state)
        t0 = float(self.tlist[-1]) if self.backward else float(self.tlist[0])
        self.set_t(t0)

    def __setattr__(self, name, value):
        if name == "generator":
            raise AttributeError(
                "The generator of a propagator cannot be mutated; use "
                "`parameters` to modify control values"
            )
        object.__setattr__(self, name, value)

    def __getattr__(self, name):
        # property firewall (reference src/propagator.jl:77-86): the
        # generator is not readable either — methods may internally
        # transform it, so exposing it would leak a lie
        if name == "generator":
            raise AttributeError(
                "A propagator does not expose its generator (it may be "
                "internally transformed); keep your own reference if needed"
            )
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}"
        )


class PiecewisePropagator(Propagator):
    """Propagator moving on the intervals of ``tlist`` with per-interval
    control parameters (``propagator.parameters[control][n]``)."""


class PWCPropagator(PiecewisePropagator):
    """Piecewise-*constant* propagator: the generator is evaluated to a
    static operator on each interval midpoint."""


# --------------------------------------------------------------------------
# Method registry
# --------------------------------------------------------------------------

_METHODS: dict[str, Callable] = {}


def register_method(name: str, factory: Callable) -> None:
    """Register a propagation method.

    ``factory(state, generator, tlist, **kwargs) -> Propagator``.  The
    open-registry analogue of defining an ``init_prop(...,
    ::Val{:Name})`` overload in the reference
    (``docs/src/howto.md:19-48``).
    """
    _METHODS[name.lower()] = factory


def available_methods() -> tuple:
    return tuple(sorted(_METHODS))


def init_prop(state, generator, tlist, method: str = "auto", **kwargs) -> Propagator:
    """Initialize a propagator for ``state`` under ``generator`` over
    ``tlist`` (reference ``src/propagator.jl:208-264``).

    ``method`` is a registered method name ('cheby', 'newton',
    'expprop', 'krylov', 'ode', ...), or 'auto' to choose 'cheby' for
    Hermitian-looking generators and 'newton' otherwise.  Keyword
    arguments not understood by the chosen method are ignored (the
    reference's tolerant kwarg protocol, ``src/propagate.jl:102-104``).
    """
    tlist = np.asarray(tlist, dtype=np.float64)
    if isinstance(generator, tuple):
        # tuple-format generator `(H0, (H1, eps), ...)` (reference
        # accepts these everywhere; normalize through hamiltonian())
        from ..models.generators import hamiltonian

        generator = hamiltonian(*generator, check=False)
    key = str(method).lower()
    if key == "auto":
        key = "cheby" if _looks_hermitian(generator, state, tlist) else "newton"
    try:
        factory = _METHODS[key]
    except KeyError:
        raise ValueError(
            f"Unknown propagation method {method!r}; available: "
            f"{available_methods()}"
        ) from None
    # `piecewise`/`pwc` both select variants (e.g. for the ODE method)
    # and assert the resulting propagator type (reference
    # src/propagator.jl:233-244) — pass them through AND enforce.
    piecewise = kwargs.get("piecewise", None)
    pwc = kwargs.get("pwc", None)
    propagator = factory(state, generator, tlist, **kwargs)
    if piecewise and not isinstance(propagator, PiecewisePropagator):
        raise TypeError(
            f"method {method!r} does not yield a piecewise propagator"
        )
    if pwc and not isinstance(propagator, PWCPropagator):
        raise TypeError(f"method {method!r} does not yield a PWC propagator")
    return propagator


# Functional-style aliases matching the reference API naming
def prop_step(propagator: Propagator):
    return propagator.prop_step()


def set_state(propagator: Propagator, state):
    return propagator.set_state(state)


def set_t(propagator: Propagator, t: float):
    return propagator.set_t(t)


def reinit_prop(propagator: Propagator, state, **kwargs):
    """Re-initialize ``propagator`` with a new initial state (reference
    ``src/propagator.jl:283-312``)."""
    propagator._reinit(state, **kwargs)
    return propagator


def _looks_hermitian(generator, state, tlist) -> bool:
    """Cheap probabilistic hermiticity probe for ``method='auto'``:
    compare ``⟨x, H y⟩`` with ``conj(⟨y, H x⟩)`` on random vectors for
    the generator evaluated on the first interval.  Chooses Chebyshev
    for Hermitian-looking generators, Newton otherwise.  For an
    operator that carries a shard-slot mesh the vectors are sharded on
    it and the products summed over every slot."""
    import torch

    from ..models.controls import evaluate
    from ..ops.operators import (apply, op_device, op_mesh, op_shape,
                                 sharded_vdot)

    try:
        op = evaluate(generator, np.asarray(tlist, dtype=np.float64), 0)
        N = op_shape(op)[1]
        rng = np.random.default_rng(0)
        dtype = state.dtype if isinstance(state, torch.Tensor) \
            else torch.complex128
        x = torch.as_tensor(
            (rng.standard_normal(N) + 1j * rng.standard_normal(N))
        ).to(device=op_device(op), dtype=dtype)
        y = torch.as_tensor(
            (rng.standard_normal(N) + 1j * rng.standard_normal(N))
        ).to(device=op_device(op), dtype=dtype)
        mesh = op_mesh(op)
        if mesh is not None:
            x, y = mesh.shard(x), mesh.shard(y)
        a = complex(sharded_vdot(x, apply(op, y), mesh))
        b = complex(sharded_vdot(y, apply(op, x), mesh))
        scale = max(abs(a), abs(b), 1e-300)
        tol = 1e-5 if x.dtype == torch.complex64 else 1e-10
        return abs(a - np.conj(b)) / scale < tol
    except Exception:
        return True  # default to cheby if the probe cannot run


def get_uniform_dt(tlist, *, tol: float = 1e-12, warn: bool = False) -> Optional[float]:
    """The uniform time step of ``tlist``, or ``None`` if the grid is
    non-uniform beyond ``tol`` (reference ``src/propagator.jl:267-280``)."""
    tlist = np.asarray(tlist)
    dts = np.diff(tlist)
    dt = float(dts[0])
    dev = np.abs(dts - dt)
    if np.any(dev > tol):
        if warn:
            i = int(np.argmax(dev > tol))
            warnings.warn(
                f"Non-uniform time grid: dt={dts[i]:.2e} in interval {i} "
                f"differs from the first dt={dt:.2e} by {dev[i]:.2e} > "
                f"tol={tol:.2e}"
            )
        return None
    return dt
