"""Observable / trajectory storage (PyTorch port of
:mod:`quantumpropagators.storage`; reference ``src/storage.jl``).

``propagate`` extracts per-time-grid-point data via a tuple of
*observables* and writes it into a pre-allocated host storage object:

- numeric array data of fixed shape → a ``numpy`` array with the time
  axis *last* (a stored state vector gives the reference's ``n × nt``
  layout, ``src/storage.jl:33-48``)
- anything else → a length-``nt`` object array.

Observables may be: a static operator (stored value is the expectation
value ``⟨Ψ|O|Ψ⟩``), a 1-argument function of the state, or a 3-argument
function ``f(state, tlist, n)`` (reference ``src/storage.jl:100-123``).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.operators import host_np, is_operator, op_dot

__all__ = [
    "init_storage",
    "map_observable",
    "map_observables",
    "write_to_storage",
    "get_from_storage",
]


class _StoreState:
    """Default observable: a host copy of the propagated state
    (reference ``src/propagate.jl:13-15``)."""

    def __call__(self, state):
        return host_np(state).copy()

    def __repr__(self):
        return "<store state>"


def map_observable(observable, state, tlist, n):
    """Evaluate one observable for the state at grid point ``n``
    (0-based)."""
    if is_operator(observable):
        return complex(op_dot(state, observable, state))
    if callable(observable):
        try:
            return observable(state, tlist, n)
        except TypeError:
            return observable(state)
    raise TypeError(f"Cannot evaluate observable {observable!r}")


def map_observables(observables, state, tlist, n):
    """Evaluate a tuple of observables; a single observable is unwrapped
    (reference ``src/storage.jl:67-80``)."""
    if observables is None:
        observables = (_StoreState(),)
    if not isinstance(observables, (tuple, list)):
        observables = (observables,)
    vals = [map_observable(o, state, tlist, n) for o in observables]
    if len(vals) == 1:
        return vals[0]
    if all(isinstance(v, (int, float, complex, np.number)) for v in vals):
        return np.asarray(vals)
    return tuple(vals)


def init_storage(data_sample, tlist_or_nt) -> np.ndarray:
    """Allocate storage for per-grid-point ``data_sample`` over ``nt``
    points: array-like samples get a dense array with time as the LAST
    axis (reference ``src/storage.jl:33-48``); other data gets an object
    array."""
    nt = (
        int(tlist_or_nt)
        if isinstance(tlist_or_nt, (int, np.integer))
        else len(np.asarray(tlist_or_nt))
    )
    if isinstance(data_sample, (np.ndarray, torch.Tensor)) or isinstance(
        data_sample, (int, float, complex, np.number)
    ):
        arr = host_np(data_sample)
        return np.zeros(arr.shape + (nt,), dtype=arr.dtype)
    storage = np.empty((nt,), dtype=object)
    return storage


def write_to_storage(storage: np.ndarray, i: int, data) -> None:
    """Write ``data`` into slot ``i`` (0-based grid point index;
    reference ``src/storage.jl:144-150``)."""
    if storage.dtype == object:
        storage[i] = data
    else:
        storage[..., i] = host_np(data)


def get_from_storage(storage: np.ndarray, i: int):
    """Read slot ``i`` (reference ``src/storage.jl:174-187``)."""
    if storage.dtype == object:
        return storage[i]
    return storage[..., i]
