"""Krylov (expv) PWC propagator (PyTorch port of
:mod:`quantumpropagators.propagators.krylov`).

The analogue of the reference's ExponentialUtilities propagator
(``src/exponential_utilities_propagator.jl``): each interval applies
``exp(-i dt H_n)`` via a single Krylov subspace
(:func:`~..ops.expv.expv_apply`) — no restart loop, no spectral-range
estimate, any generator.
"""

from __future__ import annotations

from typing import Optional

from ..ops.expv import expv_apply, expv_apply_dd
from ..ops.arnoldi import ArnoldiSites, arnoldi_sites
from ..ops.operators import as_tensor
from ..utils.timings import TimingData
from ._dd_support import DDStateMixin
from .base import register_method
from .pwc import PWCPropagatorBase

__all__ = ["KrylovPropagator"]


class KrylovPropagator(DDStateMixin, PWCPropagatorBase):
    """``precision``: see
    :class:`~..propagators.newton.NewtonPropagator`."""

    def __init__(
        self,
        state,
        generator,
        tlist,
        *,
        backward: bool = False,
        parameters=None,
        m_max: int = 30,
        tol: Optional[float] = None,
        norm_min: float = 1e-15,
        precision: str = "auto",
        dd_operator_terms=None,
        **_ignored,
    ):
        state = as_tensor(state)
        super().__init__(
            state, generator, tlist, backward=backward, parameters=parameters
        )
        self.m_max = int(m_max)
        self.tol = tol
        self.norm_min = float(norm_min)
        self.timing_data = TimingData()
        self._init_dd(state, precision, dd_operator_terms)
        # every step's Arnoldi calls replay this propagator's graphs
        self._arnoldi_sites = ArnoldiSites()

    def prop_step(self):
        if self._done:
            return None
        with self.timing_data.section("prop_step"), \
                arnoldi_sites(self._arnoldi_sites):
            n = self.n
            if self.precision == "dd":
                self._dd_step(n, expv_apply_dd, m=self.m_max, tol=self.tol,
                              norm_min=max(self.norm_min, 1e-13))
            else:
                self.state = expv_apply(
                    self._interval_operator(n), self.state,
                    self._signed_dt(n), m=self.m_max, tol=self.tol,
                    norm_min=self.norm_min,
                )
            self.timing_data.count("matvec", self.m_max)
            self._advance()
            return self.state


def _factory(state, generator, tlist, **kwargs):
    keep = ("backward", "parameters", "m_max", "tol", "norm_min",
            "precision", "dd_operator_terms")
    return KrylovPropagator(
        state, generator, tlist, **{k: v for k, v in kwargs.items() if k in keep}
    )


register_method("krylov", _factory)
register_method("expv", _factory)
