"""Linear algebra of the Krylov methods at reference accuracy (PyTorch
port of :mod:`quantumpropagators.ops.dd_linalg`).

The JAX package builds compensated double-float reductions, operator
applies and an Arnoldi iteration out of f32 planes because the TPU has
no float64.  Here every value is a float64/complex128 tensor, so the
reductions are plain ones and the operators are:

- :class:`DenseDDOp`: a complex128 dense matrix, applied with
  ``torch.matmul``;
- :class:`CDDOp`: a complex operator as a (real part, imaginary part)
  pair of real operators — a float64 :class:`~.operators.BSROperator`
  (the JAX ``BSRdd``) or a :class:`~.bsr_dd.BandedDD`, whose product is
  the banded SpMV kernel (:mod:`.banded_spmv`) on the card;
- :class:`TermsDDOp`: ``Ĥ₀ + Σₗ cₗĤₗ`` over such term operators, with
  only the coefficients changing from interval to interval;
- an operator that carries a shard-slot mesh
  (:func:`~.operators.op_mesh`), applied as it is, so a sharded state
  runs at reference accuracy too.

:func:`arnoldi_dd` is the port's CGS2 :func:`.arnoldi.arnoldi` over
:func:`apply_cdd_op`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .arnoldi import _arnoldi_impl, _read, graphed_call
from .banded_spmv import banded_dd_apply
from .bsr_dd import BandedDD
from .df64 import DD, cdd_from_c128
from .operators import (BSROperator, as_tensor, host_np, op_mesh,
                        resolve_device, vdot)

__all__ = [
    "dd_sum",
    "dd_div",
    "dd_sqrt",
    "cdd_dot",
    "cdd_norm_sq",
    "cdd_norm",
    "cdd_combine",
    "DenseDDOp",
    "CDDOp",
    "TermsDDOp",
    "dense_dd_from_numpy",
    "cdd_op_from_matrix",
    "apply_cdd_op",
    "arnoldi_dd",
    "cdd_to_device_complex",
]


def cdd_to_device_complex(x) -> torch.Tensor:
    """A reference-accuracy state as the complex128 tensor it already
    is (the JAX function merges the dd planes)."""
    return cdd_from_c128(x)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def dd_sum(x, axis=-1) -> torch.Tensor:
    """Sum of a float64 tensor along ``axis``."""
    return torch.sum(DD(x), dim=axis)


def dd_div(x, y):
    return x / y


def dd_sqrt(x) -> torch.Tensor:
    return torch.sqrt(DD(x))


def cdd_dot(x, y) -> torch.Tensor:
    """``⟨x|y⟩ = Σ conj(x)·y`` (a 0-d complex128 tensor)."""
    return vdot(x, y)


def cdd_norm_sq(x) -> torch.Tensor:
    return torch.sum(torch.abs(x) ** 2)


def cdd_norm(x) -> torch.Tensor:
    return torch.linalg.vector_norm(x)


def cdd_combine(q, w) -> torch.Tensor:
    """``Σᵢ wᵢ qᵢ`` over the rows of the ``(m, N)`` basis ``q``; ``w`` is
    ``(m,)`` (host or device)."""
    w = torch.as_tensor(np.asarray(host_np(w)), device=q.device)
    return torch.tensordot(w.to(q.dtype), q, dims=1)


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DenseDDOp:
    """A dense operator as one complex128 matrix ``mat`` (the JAX class
    holds four f32 planes)."""

    mat: Any

    @property
    def shape(self):
        return tuple(self.mat.shape)


def dense_dd_from_numpy(A, *, device=None) -> DenseDDOp:
    if device is None and isinstance(A, torch.Tensor):
        device = A.device
    return DenseDDOp(as_tensor(np.asarray(host_np(A)), device=device)
                     .to(torch.complex128))


@dataclass(frozen=True)
class CDDOp:
    """A complex operator ``re + i·im`` from real operators (a float64
    :class:`~.operators.BSROperator` or a :class:`~.bsr_dd.BandedDD`);
    ``im`` is ``None`` for real operators.  A real operator on a
    complex128 state is one product: on the card, one banded SpMV
    launch for a :class:`~.bsr_dd.BandedDD`."""

    re: Any
    im: Any = None
    shape: tuple = ()


def cdd_op_from_matrix(A, *, sparse: Optional[bool] = None,
                       block_size: Optional[int] = None, device=None):
    """The operator for a host matrix: a :class:`DenseDDOp` for small
    systems, a :class:`CDDOp` of float64 blocked-ELL parts for sparse
    ones (the JAX package's choice)."""
    import scipy.sparse as sp

    from .df64_sparse import bsr_dd_from_scipy

    if device is None and isinstance(A, torch.Tensor):
        device = A.device
    if isinstance(A, torch.Tensor):
        A = host_np(A)
    if sparse is None:
        sparse = sp.issparse(A) and min(A.shape) > 256
    if not sparse:
        Ad = A.toarray() if sp.issparse(A) else np.asarray(A)
        return dense_dd_from_numpy(Ad, device=device)
    A = sp.csr_matrix(A)
    re = bsr_dd_from_scipy(sp.csr_matrix(A.real), block_size=block_size,
                           device=device)
    im = None
    if A.nnz > 0 and np.iscomplexobj(A.data) \
            and np.abs(A.data.imag).max() > 0:
        im = bsr_dd_from_scipy(sp.csr_matrix(A.imag), block_size=block_size,
                               device=device)
    return CDDOp(re, im, tuple(A.shape))


@dataclass(frozen=True)
class TermsDDOp:
    """``Ĥ₀ + Σₗ cₗĤₗ`` as term operators plus coefficients: the leading
    ``len(terms) − len(coeffs4)`` terms are drift (coefficient 1).

    ``coeffs4`` keeps the JAX field's name; here it holds the ``n_amp``
    complex128 coefficients (the JAX field holds their ``(4, n_amp)``
    f32 hi/lo planes): a host array, or a tensor on the state's device
    (a scan's row, read on the device).  Either way applying the
    operator never waits on the device."""

    terms: Any
    coeffs4: Any
    shape: tuple = ()


def _padded(apply, rows: int, x):
    """``apply`` on ``x`` zero-padded to ``rows`` entries, the result cut
    back to ``x``'s length."""
    n = x.shape[-1]
    if n == rows:
        return apply(x.contiguous())
    if n > rows:
        raise ValueError(f"state has {n} entries, the operator {rows}")
    xp = x.new_zeros(rows)
    xp[:n] = x
    return apply(xp)[:n]


def _apply_real_dd(op, x):
    """Apply a REAL operator to a complex128 state: the banded SpMV for a
    :class:`~.bsr_dd.BandedDD`, :meth:`~.operators.BSROperator.apply`
    for a float64 blocked-ELL operator."""
    if isinstance(op, BandedDD):
        return _padded(lambda v: banded_dd_apply(op, v), op.R * op.b, x)
    if isinstance(op, BSROperator):
        return _padded(op.apply, op.shape[0], x)
    raise TypeError(f"not a real dd operator: {type(op)}")


def apply_cdd_op(op, v):
    """``op @ v`` for any operator container of this module (or a
    callable, or a bare real operator) on a complex128 state."""
    if isinstance(op, TermsDDOp):
        coeffs = op.coeffs4
        if isinstance(coeffs, torch.Tensor):
            coeffs = coeffs.reshape(-1)
        else:
            coeffs = [complex(c) for c in
                      np.asarray(coeffs, dtype=np.complex128).reshape(-1)]
        n_drift = len(op.terms) - len(coeffs)
        out = None
        for i, t in enumerate(op.terms):
            y = apply_cdd_op(t, v)
            if i >= n_drift:
                y = coeffs[i - n_drift] * y
            out = y if out is None else out + y
        return out
    if isinstance(op, DenseDDOp):
        return torch.matmul(op.mat, v)
    if isinstance(op, CDDOp):
        y = _apply_real_dd(op.re, v)
        if op.im is None:
            return y
        return y + 1j * _apply_real_dd(op.im, v)
    if getattr(op, "mesh", None) is not None:
        return op.apply(v)
    if callable(op):
        return op(v)
    return _apply_real_dd(op, v)


# ---------------------------------------------------------------------------
# Arnoldi
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Applied:
    """Any operator of :func:`apply_cdd_op` behind the ``apply``
    protocol that :func:`.arnoldi.arnoldi` calls, with the operator's
    shape (where it has one) and, through ``op``, its mesh."""

    op: Any

    @property
    def shape(self):
        return getattr(self.op, "shape", None)

    def apply(self, v):
        return apply_cdd_op(self.op, v)


def _split_dd(op):
    """``(terms, amplitudes)`` of a :class:`TermsDDOp` (its ``coeffs4``
    are per-call data of the graphed site); any other operator as itself
    and ``None``."""
    if isinstance(op, TermsDDOp):
        return ("terms", tuple(op.terms), op.shape), op.coeffs4
    return ("op", op), None


def _join_dd(terms, amps):
    if terms[0] == "terms":
        return _Applied(TermsDDOp(terms[1], amps, terms[2]))
    return _Applied(terms[1])


def _arnoldi_dd_impl(op, amps, psi, m: int, dt, norm_min):
    """The body of :func:`arnoldi_dd`, the JAX ``_arnoldi_dd_impl``
    (``m``, ``dt`` and ``norm_min`` static there).  ``m`` and
    ``norm_min`` are part of the graphed site's key; ``dt`` is per-call
    data, as in :func:`.arnoldi.arnoldi`: a time grid's intervals differ
    in their last bits, and the site holds one graph where ``jax.jit``
    caches one executable for each."""
    return _arnoldi_impl(op, amps, psi, m, dt, norm_min, True, True,
                         join=_join_dd)


def arnoldi_dd(op, psi, m: int, dt: float = 1.0, *,
               norm_min: float = 1e-12):
    """Extended Arnoldi factorization of ``H·dt`` in complex128 from the
    normalized ``psi``: ``(Hess, q, m_eff)`` with ``Hess`` an
    ``(m+1, m+1)`` host complex128 array, ``q`` the ``(m+1, N)`` basis on
    ``psi``'s device and ``m_eff ≤ m`` (< m at Krylov breakdown).  The
    call runs through the active :func:`~.arnoldi.arnoldi_sites` scope's
    graphed site, as :func:`~.arnoldi.arnoldi` does."""
    psi = cdd_from_c128(psi)
    terms, amps = _split_dd(op)
    Hess, q, m_eff = graphed_call(
        _arnoldi_dd_impl, {"controls": ("amps", "dt")}, op_mesh(op), terms,
        amps, psi, int(m), float(dt), float(norm_min), part=int(m))
    Hess, m_eff = _read(Hess, m_eff)
    return Hess, q, m_eff


def _device_of(op) -> torch.device:
    """The device an operator container's tensors live on."""
    for attr in ("mat", "re", "planes", "blocks"):
        inner = getattr(op, attr, None)
        if isinstance(inner, torch.Tensor):
            return inner.device
        if inner is not None:
            return _device_of(inner)
    terms = getattr(op, "terms", None)
    return _device_of(terms[0]) if terms else resolve_device(None)


def dd_operands(op, psi):
    """``(op, psi)`` ready for the reference-accuracy Krylov methods:
    ``psi`` a complex128 tensor (a host vector goes to the operator's
    device) and ``op`` an operator of this module or a callable (a host
    or dense matrix is converted by :func:`cdd_op_from_matrix` on the
    state's device)."""
    is_dd = isinstance(op, (DenseDDOp, CDDOp, TermsDDOp))
    device = None
    if not isinstance(psi, torch.Tensor) and is_dd:
        device = _device_of(op)
    psi = cdd_from_c128(psi, device=device)
    if not is_dd and not callable(op):
        op = cdd_op_from_matrix(op, device=psi.device)
    return op, psi
