"""Dense matrix-exponential PWC propagator (PyTorch port of
:mod:`quantumpropagators.propagators.expprop`; reference
``src/exp_propagator.jl``).

The debug/small-system method: each step forms ``U = f(H·dt)`` by dense
matrix exponentiation on the state's device (:func:`..ops.expprop.expm`)
and applies it.  ``convert_state`` / ``convert_operator`` escape hatches
allow densifying unusual types before the exponential (reference
``src/exp_propagator.jl:35-39``); a custom ``func`` receives the host
numpy matrix ``H·dt``, as in the JAX package.

Without those, each interval is one call of a graphed site
(:func:`~..utils.scan.graphed`, the port of the JAX ``jax.jit`` of
:func:`_exp_step`): on the card it replays one CUDA graph that sums the
dense terms (made on the state's device once a propagator, the JAX
``op.to_dense()``) with the interval's amplitudes, takes the
exponential (:func:`..ops.expprop.expm`, its choices on the card) and
applies it.  The amplitudes and ``dt`` are data, so a propagator
captures once, and not again after ``reinit_prop`` or for a new time
grid of the same length.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..models.generators import Operator
from ..ops.expprop import expm, expprop_apply
from ..ops.operators import (apply, as_tensor, device_scalar, host_np,
                             op_mesh, to_dense)
from ..utils.scan import graphed
from ..utils.timings import TimingData
from .base import register_method
from .pwc import PWCPropagatorBase

__all__ = ["ExpPropagator"]


def _exp_step(dense, amps, psi, dt):
    """One interval, ``exp(−i·H·dt)·psi`` with ``H`` the dense terms
    summed with the amplitudes ``amps`` (the JAX ``_exp_step``, jitted
    with the operator and ``dt`` traced; ``dt`` carries the direction).
    The amplitudes and ``dt`` are 0-d tensors on the state's device
    whether they come as host values (the eager body) or as the graph's
    buffers, so both give the same bits."""
    H = Operator(list(dense), as_tensor(amps, device=psi.device)).to_dense()
    U = expm(-1j * H * device_scalar(dt, psi.device))
    return U @ psi



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
        # with none of the host-side hooks, the graphed site; a hook
        # works on each interval's operator or state on the host, as in
        # the JAX package, so those steps stay eager
        self._graphed = func is None and convert_state is None \
            and convert_operator is None
        self._dense = None
        self._step = graphed(_exp_step, mesh=op_mesh(generator),
                             operators=("dense",), controls=("amps", "dt"),
                             own_pool=True)

    def _dense_terms(self, device):
        """The dense terms on ``device``, made once a propagator."""
        if self._dense is None or self._dense[0].device != device:
            self._dense = tuple(as_tensor(to_dense(t), device=device)
                                for t in self._interval_terms())
        return self._dense

    def prop_step(self):
        if self._done:
            return None
        with self.timing_data.section("prop_step"):
            n = self.n
            dt = float(self.tlist[n + 1] - self.tlist[n])
            if self.backward:
                dt = -dt
            if self._graphed:
                psi = as_tensor(self.state)
                psi = self._step(self._dense_terms(psi.device),
                                 self._amplitudes(n), psi, dt)
            else:
                psi = self._hooked_step(n, dt)
            self.state = psi
            self._advance()
            return self.state

    def _hooked_step(self, n, dt):
        """One interval through ``convert_state``, ``convert_operator``
        and ``func``, on the host where they need it."""
        op = self._interval_operator(n)
        psi = self.state
        if self.convert_state is not None:
            psi = self.convert_state(psi)
        if self.convert_operator is not None:
            op = self.convert_operator(op)
        psi = as_tensor(psi)
        if self.func is None:
            return expprop_apply(op, psi, dt)
        U = self.func(host_np(to_dense(op)) * dt)
        return apply(np.asarray(U), psi)


def _factory(state, generator, tlist, **kwargs):
    keep = ("backward", "parameters", "func", "convert_state", "convert_operator")
    return ExpPropagator(
        state, generator, tlist, **{k: v for k, v in kwargs.items() if k in keep}
    )


register_method("expprop", _factory)
