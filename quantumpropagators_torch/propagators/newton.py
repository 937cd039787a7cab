"""Newton-with-restarted-Arnoldi PWC propagator (PyTorch port of
:mod:`quantumpropagators.propagators.newton`; reference
``src/newton_propagator.jl``).

The general-purpose method for non-Hermitian generators (Liouvillians):
each interval applies ``f(H·dt)`` via :func:`~..ops.newton.newton_apply`,
with ``func``/``norm_min``/``relerr``/``max_restarts`` carried through
(reference ``src/newton_propagator.jl:137-146``).
"""

from __future__ import annotations

from typing import Callable, Optional

from ..ops.newton import NewtonInfo, newton_apply, newton_apply_dd
from ..ops.arnoldi import ArnoldiSites, arnoldi_sites
from ..ops.operators import as_tensor
from ..utils.timings import TimingData
from ._dd_support import DDStateMixin
from .base import register_method
from .pwc import PWCPropagatorBase

__all__ = ["NewtonPropagator"]


class NewtonPropagator(DDStateMixin, PWCPropagatorBase):
    """``precision``: ``'auto'``/``'native'`` (the state's dtype) or
    ``'dd'`` (complex128, the reference-accuracy tier)."""

    def __init__(
        self,
        state,
        generator,
        tlist,
        *,
        backward: bool = False,
        parameters=None,
        func: Optional[Callable] = None,
        m_max: int = 10,
        norm_min: float = 1e-14,
        relerr: float = 1e-12,
        max_restarts: int = 50,
        precision: str = "auto",
        dd_operator_terms=None,
        **_ignored,
    ):
        state = as_tensor(state)
        super().__init__(
            state, generator, tlist, backward=backward, parameters=parameters
        )
        self.func = func
        self.m_max = int(m_max)
        self.norm_min = float(norm_min)
        self.relerr = float(relerr)
        self.max_restarts = int(max_restarts)
        self.timing_data = TimingData()
        self.newton_info = NewtonInfo()
        self._init_dd(state, precision, dd_operator_terms)
        # every step's Arnoldi calls replay this propagator's graphs
        self._arnoldi_sites = ArnoldiSites()

    def prop_step(self):
        if self._done:
            return None
        with self.timing_data.section("prop_step"), \
                arnoldi_sites(self._arnoldi_sites):
            n = self.n
            kwargs = dict(func=self.func, m_max=self.m_max,
                          relerr=self.relerr, max_restarts=self.max_restarts,
                          info=self.newton_info)
            if self.precision == "dd":
                self._dd_step(n, newton_apply_dd,
                              norm_min=max(self.norm_min, 1e-13), **kwargs)
            else:
                self.state = newton_apply(
                    self._interval_operator(n), self.state,
                    self._signed_dt(n), norm_min=self.norm_min, **kwargs,
                )
            self.timing_data.count("matvec", self.newton_info.matvecs)
            self.newton_info.matvecs = 0
            self._advance()
            return self.state


def _factory(state, generator, tlist, **kwargs):
    keep = (
        "backward",
        "parameters",
        "func",
        "m_max",
        "norm_min",
        "relerr",
        "max_restarts",
        "precision",
        "dd_operator_terms",
    )
    return NewtonPropagator(
        state, generator, tlist, **{k: v for k, v in kwargs.items() if k in keep}
    )


register_method("newton", _factory)
