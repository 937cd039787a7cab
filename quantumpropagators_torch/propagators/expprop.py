"""Dense matrix-exponential PWC propagator (PyTorch port of
:mod:`quantumpropagators.propagators.expprop`; reference
``src/exp_propagator.jl``).

The debug/small-system method: each step forms ``U = f(H·dt)`` by dense
matrix exponentiation on the state's device (:func:`..ops.expprop.expm`)
and applies it.  ``convert_state`` / ``convert_operator`` escape hatches
allow densifying unusual types before the exponential (reference
``src/exp_propagator.jl:35-39``); a custom ``func`` receives the host
numpy matrix ``H·dt``, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..ops.expprop import expprop_apply
from ..ops.operators import apply, as_tensor, host_np, to_dense
from ..utils.timings import TimingData
from .base import register_method
from .pwc import PWCPropagatorBase

__all__ = ["ExpPropagator"]


class ExpPropagator(PWCPropagatorBase):
    def __init__(
        self,
        state,
        generator,
        tlist,
        *,
        backward: bool = False,
        parameters=None,
        func: Optional[Callable] = None,
        convert_state: Optional[Callable] = None,
        convert_operator: Optional[Callable] = None,
        **_ignored,
    ):
        super().__init__(
            state, generator, tlist, backward=backward, parameters=parameters
        )
        self.func = func
        self.convert_state = convert_state
        self.convert_operator = convert_operator
        self.timing_data = TimingData()

    def prop_step(self):
        if self._done:
            return None
        with self.timing_data.section("prop_step"):
            n = self.n
            op = self._interval_operator(n)
            dt = float(self.tlist[n + 1] - self.tlist[n])
            if self.backward:
                dt = -dt
            psi = self.state
            if self.convert_state is not None:
                psi = self.convert_state(psi)
            if self.convert_operator is not None:
                op = self.convert_operator(op)
            psi = as_tensor(psi)
            if self.func is None:
                psi = expprop_apply(op, psi, dt)
            else:
                U = self.func(host_np(to_dense(op)) * dt)
                psi = apply(np.asarray(U), psi)
            self.state = psi
            self._advance()
            return self.state


def _factory(state, generator, tlist, **kwargs):
    keep = ("backward", "parameters", "func", "convert_state", "convert_operator")
    return ExpPropagator(
        state, generator, tlist, **{k: v for k, v in kwargs.items() if k in keep}
    )


register_method("expprop", _factory)
