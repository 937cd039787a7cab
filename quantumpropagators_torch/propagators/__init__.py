"""Propagator layer: stateful stepping objects.  Only the ``cheby``
method is registered so far; other method names raise the same
"Unknown propagation method" error as the JAX package."""

from .base import (
    PiecewisePropagator,
    Propagator,
    PWCPropagator,
    available_methods,
    get_uniform_dt,
    init_prop,
    prop_step,
    register_method,
    reinit_prop,
    set_state,
    set_t,
)

# Register the built-in methods
from . import cheby as _cheby  # noqa: F401

from .cheby import ChebyPropagator

__all__ = [
    "Propagator",
    "PiecewisePropagator",
    "PWCPropagator",
    "init_prop",
    "prop_step",
    "set_state",
    "set_t",
    "reinit_prop",
    "register_method",
    "available_methods",
    "get_uniform_dt",
    "ChebyPropagator",
]
