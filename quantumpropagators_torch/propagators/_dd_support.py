"""Shared reference-accuracy plumbing for the Krylov-method propagators
(PyTorch port of :mod:`quantumpropagators.propagators._dd_support`).

The JAX package's ``precision="dd"`` carries the state and the interval
operators as double-float planes on f32-only devices.  Here ``"dd"``
promotes the state to complex128 and applies the interval operator as a
:class:`~..ops.dd_linalg.TermsDDOp`; ``"auto"`` is ``"native"`` on every
device, as it is in the JAX package wherever float64 exists."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "resolve_dd_precision",
    "build_dd_terms",
    "state_to_cdd",
    "interval_terms_dd",
    "DDStateMixin",
]


def resolve_dd_precision(precision: str) -> str:
    """``'auto'`` → ``'native'`` (the card and the CPU have float64);
    explicit ``'dd'``/``'native'`` pass through."""
    if precision not in ("auto", "dd", "native"):
        raise ValueError(f"unknown precision={precision!r}")
    return "native" if precision == "auto" else precision


def _dd_term(t, device):
    """One term operator at reference accuracy on ``device``.

    An operator that is already one of :mod:`..ops.dd_linalg`'s (or a
    :class:`~..ops.bsr_dd.BandedDD`) passes through.  A real
    :class:`~..ops.operators.BSROperator` whose block size is 128 on the
    card (8 on the CPU) becomes band planes on its own device
    (:func:`~..ops.bsr_dd.banded_dd_from_bsr`), the choice
    ``fused._static_dd_path`` makes; when that raises (complex entries,
    too many bands) the term, like every other one, goes through a host
    scipy matrix and :func:`~..ops.dd_linalg.cdd_op_from_matrix`.  A
    term that carries a shard-slot mesh applies itself to the sharded
    complex128 state and passes through."""
    from ..ops.bsr_dd import BandedDD, banded_dd_from_bsr
    from ..ops.dd_linalg import CDDOp, DenseDDOp, cdd_op_from_matrix
    from ..ops.operators import BSROperator, to_scipy_sparse

    if isinstance(t, (CDDOp, DenseDDOp)) \
            or getattr(t, "mesh", None) is not None:
        return t
    if isinstance(t, BandedDD):
        return CDDOp(t, None, t.shape)
    block = 128 if device.type == "cuda" else 8
    if isinstance(t, BSROperator) and t.block_size == block:
        try:
            banded = banded_dd_from_bsr(t)
        except ValueError:
            pass
        else:
            banded = dataclasses.replace(banded,
                                         planes=banded.planes.to(device))
            return CDDOp(banded, None, tuple(t.shape))
    return cdd_op_from_matrix(to_scipy_sparse(t), device=device)


def build_dd_terms(op_proto, host_terms=None, *, device=None) -> tuple:
    """Every term of a prototype interval Operator at reference accuracy,
    built ONCE at init: term data never changes across steps or control
    updates.

    ``host_terms`` (the ``dd_operator_terms`` propagator kwarg): one
    operator per generator term in order, in place of the generator's
    own terms — host float64 matrices, as in the JAX package, or
    operators already built by :mod:`..ops.dd_linalg` or
    :mod:`..ops.bsr_dd`, which are used as they are.  ``device``
    defaults to the device of the generator's terms."""
    from ..models.generators import Operator
    from ..ops.operators import op_device

    terms = op_proto.ops if isinstance(op_proto, Operator) else [op_proto]
    device = op_device(terms[0]) if device is None else torch.device(device)
    if host_terms is not None:
        host_terms = list(host_terms)
        if len(host_terms) != len(terms):
            raise ValueError(
                f"dd_operator_terms has {len(host_terms)} terms; the "
                f"generator has {len(terms)}"
            )
        terms = host_terms
    return tuple(_dd_term(t, device) for t in terms)


def state_to_cdd(state) -> torch.Tensor:
    """The state as a complex128 tensor (a tensor stays on its device)."""
    from ..ops.df64 import cdd_from_c128

    return cdd_from_c128(state)


def interval_terms_dd(dd_terms, coeffs):
    """The interval operator as a :class:`~..ops.dd_linalg.TermsDDOp`:
    only the coefficients change per interval.  The graphed Arnoldi site
    takes them apart from the terms again (``ops/dd_linalg.py``
    ``_split_dd``) and copies them in as per-call data, so that no
    graph's key holds them."""
    from ..ops.dd_linalg import TermsDDOp
    from ..ops.newton import _split_c128_planes
    from ..ops.operators import host_np

    n = dd_terms[0].shape[0] if dd_terms[0].shape else 0
    return TermsDDOp(
        terms=dd_terms,
        coeffs4=_split_c128_planes(np.asarray(host_np(coeffs))),
        shape=(n, n),
    )


class DDStateMixin:
    """``precision`` handling shared by the Krylov propagators:
    ``'native'`` steps in the state's own dtype, ``'dd'`` in complex128
    over the interval operator as a :class:`~..ops.dd_linalg.TermsDDOp`
    (the JAX package's reference-accuracy tier), ``'auto'`` is
    ``'native'``."""

    def _init_dd(self, state, precision, dd_operator_terms):
        self.precision = resolve_dd_precision(precision)
        self._state_dd = None
        self._dd_terms = None
        if self.precision == "dd":
            self._state_dd = state_to_cdd(state)
            self._dd_terms = build_dd_terms(
                self._interval_operator(0), dd_operator_terms,
                device=self._state_dd.device,
            )

    def set_state(self, state):
        from ..ops.operators import as_tensor

        self.state = as_tensor(state)
        if self.precision == "dd":
            self._state_dd = state_to_cdd(self.state)
        return self.state

    @property
    def state_dd(self):
        """The complex128 state (``precision='dd'`` only)."""
        return self._state_dd

    def _signed_dt(self, n: int) -> float:
        dt = float(self.tlist[n + 1] - self.tlist[n])
        return -dt if self.backward else dt

    def _dd_step(self, n: int, apply_dd, **kwargs):
        """One interval at reference accuracy with ``apply_dd(op, psi,
        dt, **kwargs)``."""
        op = interval_terms_dd(self._dd_terms, self._interval_coeffs(n))
        self._state_dd = apply_dd(op, self._state_dd, self._signed_dt(n),
                                  **kwargs)
        self.state = self._state_dd
