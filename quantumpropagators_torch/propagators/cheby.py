"""Chebyshev PWC propagator (PyTorch port of
:mod:`quantumpropagators.propagators.cheby`; reference
``src/cheby_propagator.jl``).

Initialization estimates the spectral envelope of the generator over the
range of control values (evaluating at extremal controls and taking the
spectral range of both; ``src/cheby_propagator.jl:331-345``), enlarges
it by ``specrange_buffer``, and fixes the Chebyshev coefficients for the
uniform time step.  Re-initialization only recomputes coefficients when
current control amplitudes leave the certified range
(``src/cheby_propagator.jl:243-299``).

The per-interval step is one graphed call (:func:`~..utils.scan.graphed`,
the port of the JAX ``jax.jit`` of :func:`_cheby_step`): on the card each
interval replays one CUDA graph that reads the term operators in place
and takes the interval's amplitudes, the Chebyshev coefficients, ``Δ``,
``E_min`` and ``dt`` as data, so control updates and a re-initialized
envelope of the same length replay the same graph.  Each propagator
owns its site (and the site its memory pool), so dropping the
propagator frees its graph, and its copies of host terms on the state's
device, made once.  A generator sharded over a group of more than one
rank runs the interval eagerly (no cross-rank capture).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.controls import discretize
from ..models.generators import Operator
from ..ops.arnoldi import ArnoldiSites, arnoldi_sites
from ..ops.cheby import ChebyWorkspace, cheby_apply
from ..ops.operators import DeviceCopies, as_tensor, op_mesh
from ..ops.specrange import specrange
from ..utils.iddict import IdDict
from ..utils.scan import graphed
from ..utils.timings import TimingData
from .base import get_uniform_dt, register_method
from .pwc import PWCPropagatorBase

__all__ = ["ChebyPropagator", "cheby_get_spectral_envelope"]


def _cheby_step(ops, amps, psi, coeffs, delta, e_min, dt, forward,
                check_normalization):
    """One interval over ``Operator(ops, amps)``: the JAX ``_cheby_step``,
    jitted with the operator, ``coeffs``, ``delta``, ``e_min`` and ``dt``
    traced and ``forward``/``check_normalization`` static."""
    return cheby_apply(
        Operator(list(ops), amps), psi, coeffs, delta, e_min, dt,
        forward=forward, check_normalization=check_normalization,
    )


def _cheby_step_dd(terms, amps, psi, coeffs, delta, e_min, dt, forward):
    """One reference-accuracy interval over the dd terms with the
    interval's amplitudes (the JAX ``_cheby_step_dd`` over a
    ``TermsDDOp``, jitted with ``delta``, ``e_min``, ``dt`` and
    ``forward`` static); a banded term is one ``banded_spmv<double>``
    launch per order on the card."""
    from ..ops.dd_linalg import TermsDDOp, apply_cdd_op
    from ..ops.df64_sparse import cheby_dd_recurrence

    op = TermsDDOp(terms=tuple(terms), coeffs4=amps)
    return cheby_dd_recurrence(lambda v: apply_cdd_op(op, v), psi, coeffs,
                               0.0, delta, e_min, dt, forward)


def cheby_get_spectral_envelope(generator, tlist, control_ranges, method, **kwargs):
    """Estimate ``(E_min, E_max)`` of ``generator`` over the whole
    propagation, by evaluating at minimal and maximal control values and
    taking the union of both spectral ranges
    (reference ``src/cheby_propagator.jl:331-345``).  The two
    ``specrange`` calls share one graphed Arnoldi site, which lives for
    this call only."""
    from ..models.controls import evaluate

    n = len(tlist) // 2
    min_vals = IdDict([(c, r[0]) for c, r in control_ranges.items()])
    max_vals = IdDict([(c, r[1]) for c, r in control_ranges.items()])
    G_min = evaluate(generator, tlist, n, vals_dict=min_vals)
    G_max = evaluate(generator, tlist, n, vals_dict=max_vals)
    with arnoldi_sites(ArnoldiSites()):
        E_min, E_max = specrange(G_max, method, **kwargs)
        e2_min, e2_max = specrange(G_min, method, **kwargs)
    return min(E_min, e2_min), max(E_max, e2_max)


class ChebyPropagator(PWCPropagatorBase):
    """Piecewise-constant Chebyshev propagator.

    ``precision="dd"`` keeps the JAX package's name for its
    reference-accuracy tier: the state is complex128 and each interval
    applies the dd terms built once at init
    (:func:`~._dd_support.build_dd_terms`: the generator's terms, or
    ``dd_operator_terms`` in their place; a ready
    :class:`~..ops.bsr_dd.BandedDD` term is one ``banded_spmv<double>``
    launch per order on the card).
    """

    def __init__(
        self,
        state,
        generator,
        tlist,
        *,
        backward: bool = False,
        parameters=None,
        control_ranges=None,
        specrange_method: str = "auto",
        specrange_buffer: float = 0.01,
        cheby_coeffs_limit: float = 1e-12,
        check_normalization: bool = False,
        uniform_dt_tolerance: float = 1e-12,
        coeffs_pad_to: int = 8,
        precision: str = "native",
        dd_operator_terms=None,
        **specrange_kwargs,
    ):
        if precision not in ("native", "dd"):
            raise ValueError(f"unknown precision={precision!r}")
        state = as_tensor(state)
        super().__init__(
            state, generator, tlist, backward=backward, parameters=parameters
        )
        self.precision = precision
        self.set_state(state)
        self._dd_terms = None
        self._copies = DeviceCopies()
        if precision == "dd":
            from ..ops.dd_linalg import TermsDDOp
            from ._dd_support import build_dd_terms

            self._dd_terms = build_dd_terms(
                self._interval_operator(0), dd_operator_terms,
                device=self.state.device,
            )
            self._step = graphed(_cheby_step_dd,
                                 mesh=op_mesh(TermsDDOp(self._dd_terms, None)),
                                 operators=("terms",),
                                 controls=("amps", "coeffs"), own_pool=True)
        else:
            self._step = graphed(
                _cheby_step, mesh=op_mesh(self._generator),
                operators=("ops",),
                controls=("amps", "coeffs", "delta", "e_min", "dt"),
                own_pool=True)
        self.specrange_method = specrange_method
        self.specrange_buffer = float(specrange_buffer)
        self.specrange_options = dict(specrange_kwargs)
        self.check_normalization = bool(check_normalization)
        self.cheby_coeffs_limit = float(cheby_coeffs_limit)
        self.coeffs_pad_to = int(coeffs_pad_to)
        self.timing_data = TimingData()

        if control_ranges is None:
            # Certify over the union of grid-point and midpoint values:
            # the midpoint values are what the steps actually use, so
            # this keeps `reinit` (which checks midpoint ranges) stable.
            control_ranges = IdDict()
            for c in self.controls:
                vals = np.concatenate(
                    [discretize(c, tlist), np.asarray(self.parameters[c])]
                )
                control_ranges[c] = (float(np.min(vals)), float(np.max(vals)))
        else:
            if not isinstance(control_ranges, IdDict):
                control_ranges = IdDict(control_ranges)
            for c in self.controls:
                if c not in control_ranges:
                    raise ValueError("control_ranges must contain all controls")
                lo, hi = control_ranges[c]
                if lo > hi:
                    raise ValueError("control range must be (min, max)")
        self.control_ranges = control_ranges

        dt = get_uniform_dt(tlist, tol=uniform_dt_tolerance, warn=True)
        if dt is None:
            raise ValueError(
                "Chebyshev propagation only works on a uniform time grid"
            )
        self._dt = float(dt)
        self.wrk = self._make_workspace(state)

    # -- workspace ----------------------------------------------------------

    def _make_workspace(self, state) -> ChebyWorkspace:
        E_min, E_max = cheby_get_spectral_envelope(
            self._generator,
            self.tlist,
            self.control_ranges,
            self.specrange_method,
            **self.specrange_options,
        )
        delta = E_max - E_min
        if not delta > 0:
            raise ValueError(f"Spectral range Δ={delta} must be positive")
        buf = self.specrange_buffer * delta
        E_min = E_min - buf / 2
        delta = delta + buf
        return ChebyWorkspace.create(
            delta,
            E_min,
            self._dt,
            limit=self.cheby_coeffs_limit,
            pad_to=self.coeffs_pad_to,
        )

    # -- stepping -----------------------------------------------------------

    def set_state(self, state):
        state = as_tensor(state)
        if self.precision == "dd":
            state = state.to(torch.complex128)
        self.state = state
        return self.state

    @property
    def state_dd(self):
        """The complex128 state (the JAX package's dd planes merged)."""
        return self.state.to(torch.complex128)

    def prop_step(self):
        if self._done:
            return None
        with self.timing_data.section("prop_step"):
            n = self.n
            wrk = self.wrk
            dt = -self._dt if self.backward else self._dt
            if self.precision == "dd":
                result = self._step(
                    self._dd_terms,
                    np.asarray(self._amplitudes(n), np.complex128),
                    self.state, wrk.coeffs, wrk.delta, wrk.e_min, dt,
                    not self.backward,
                )
            else:
                device = self.state.device
                result = self._step(
                    tuple(self._copies(t, device)
                          for t in self._interval_terms()),
                    self._amplitudes(n),
                    self.state, wrk.coeffs, wrk.delta, wrk.e_min, dt,
                    not self.backward, self.check_normalization,
                )
            if self.check_normalization and self.precision != "dd":
                psi, max_norm = result
                # the interval's one read of the device, as in JAX
                if float(max_norm) > 1.0 + self.wrk.limit:
                    raise RuntimeError(
                        f"Incorrect normalization "
                        f"(E_min={self.wrk.e_min}, Δ={self.wrk.delta})"
                    )
            else:
                psi = result
            self.state = psi
            self.timing_data.count("matvec", self.wrk.coeffs.shape[0] - 1)
            self._advance()
            return self.state

    # -- re-initialization (the optimal-control fast path) -------------------

    def _reinit(self, state, *, transform_control_ranges=None, **_ignored):
        self.set_state(state)
        if transform_control_ranges is None:
            transform_control_ranges = lambda c, lo, hi, check: (lo, hi)
        current = IdDict(
            [
                (
                    c,
                    (
                        float(np.min(np.asarray(self.parameters[c]))),
                        float(np.max(np.asarray(self.parameters[c]))),
                    ),
                )
                for c in self.controls
            ]
        )
        need_recalc = False
        for c in self.controls:
            lo, hi = current[c]
            lo_chk, hi_chk = transform_control_ranges(c, lo, hi, True)
            lo0, hi0 = self.control_ranges[c]
            if lo_chk < lo0 or hi_chk > hi0:
                need_recalc = True
                break
        if need_recalc:
            for c in self.controls:
                lo, hi = current[c]
                current[c] = transform_control_ranges(c, lo, hi, False)
            self.control_ranges = current
            self.wrk = self._make_workspace(state)
        else:
            self.timing_data.reset()
        t0 = float(self.tlist[-1]) if self.backward else float(self.tlist[0])
        self.set_t(t0)


def _factory(state, generator, tlist, **kwargs):
    kwargs = {
        k: v
        for k, v in kwargs.items()
        if k
        in (
            "backward",
            "parameters",
            "control_ranges",
            "specrange_method",
            "specrange_buffer",
            "cheby_coeffs_limit",
            "check_normalization",
            "uniform_dt_tolerance",
            "coeffs_pad_to",
            "m_min",
            "m_max",
            "prec",
            "norm_min",
            "enlarge",
            "E_min",
            "E_max",
            "rng",
            "precision",
            "dd_operator_terms",
        )
    }
    return ChebyPropagator(state, generator, tlist, **kwargs)


register_method("cheby", _factory)
