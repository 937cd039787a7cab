"""Propagator layer: stateful stepping objects.  The registered methods
are the JAX package's: ``cheby``, ``expprop``, ``newton``, ``krylov`` /
``expv`` and ``ode``; any other method name raises the same "Unknown
propagation method" error."""

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
from . import expprop as _expprop  # noqa: F401
from . import newton as _newton  # noqa: F401
from . import krylov as _krylov  # noqa: F401
from . import ode as _ode  # noqa: F401

from .cheby import ChebyPropagator
from .expprop import ExpPropagator
from .newton import NewtonPropagator
from .krylov import KrylovPropagator
from .ode import ODEContinuousPropagator, ODEPropagator, ODEPWCPropagator, ode_function

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
    "ExpPropagator",
    "NewtonPropagator",
    "KrylovPropagator",
    "ODEPropagator",
    "ode_function",
]
