"""Operator containers and the ``apply`` protocol (PyTorch port of
:mod:`quantumpropagators.ops.operators`).

Every propagation kernel is generic over any operator that implements
``apply(op, psi) -> psi'`` (the analogue of the reference's 3-arg
``mul!``).  Operators hold torch tensors; the device of an operator is
the device of its tensors, and ``apply`` runs wherever the state and the
operator live.

Operator types:

- 2D ``torch.Tensor`` / ``numpy`` arrays (dense)
- :class:`DiagonalOperator` — elementwise multiply
- :class:`CSROperator` — gather + ``index_add`` SpMV (sorted rows)
- :class:`~..models.generators.Operator` — lazy sum Σ cₗ Ĥₗ

States are tensors with the Hilbert dimension on the *last* axis;
leading axes are batch dimensions.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

__all__ = [
    "DiagonalOperator",
    "CSROperator",
    "apply",
    "op_dot",
    "to_dense",
    "to_scipy_sparse",
    "op_shape",
    "op_device",
    "csr_from_scipy",
    "csr_from_dense",
    "add_operators",
    "scale_operator",
    "is_operator",
    "as_tensor",
    "host_np",
    "vdot",
]


def as_tensor(x, *, device=None, dtype=None) -> torch.Tensor:
    """``x`` (tensor, numpy array, or anything array-like) as a torch
    tensor; numpy input is copied, tensors are moved/cast only when
    asked."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=dtype if dtype is not None else x.dtype)
    arr = np.array(x)
    return torch.as_tensor(arr, dtype=dtype, device=device)


def host_np(x) -> np.ndarray:
    """Host numpy copy of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _promote(a: torch.Tensor, b: torch.Tensor):
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype), b.to(dtype)


def vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``Σ conj(x)·y`` over all elements (``jnp.vdot`` semantics)."""
    x, y = _promote(x, y)
    return torch.sum(x.conj().reshape(-1) * y.reshape(-1))


@dataclass(frozen=True)
class DiagonalOperator:
    """A diagonal operator; ``apply`` is an elementwise product."""

    diag: Any  # (N,) tensor

    @property
    def shape(self):
        return (self.diag.shape[-1], self.diag.shape[-1])

    def apply(self, psi):
        return self.diag * psi

    def to_dense(self):
        return torch.diag(self.diag)


@dataclass(frozen=True)
class CSROperator:
    """Sparse operator in CSR layout with explicit per-entry row ids.

    ``data[k]`` is the entry at ``(row[k], col[k])``, sorted by row.
    ``indptr`` is carried for host-side conversions.
    """

    data: Any  # (nnz,)
    col: Any  # (nnz,) int64
    row: Any  # (nnz,) int64
    indptr: Any  # (N+1,) int64
    shape: tuple = ()

    @property
    def nnz(self):
        return self.col.shape[-1]

    def apply(self, psi):
        data, psi = _promote(self.data, psi)
        prod = data * psi[..., self.col]
        out = torch.zeros(psi.shape[:-1] + (self.shape[0],),
                          dtype=prod.dtype, device=prod.device)
        return out.index_add_(-1, self.row, prod)

    def to_dense(self):
        A = torch.zeros(self.shape, dtype=self.data.dtype,
                        device=self.data.device)
        return A.index_put_((self.row, self.col), self.data, accumulate=True)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (host_np(self.data), host_np(self.col), host_np(self.indptr)),
            shape=self.shape,
        )


# --------------------------------------------------------------------------
# Generic functional interface
# --------------------------------------------------------------------------

def _is_dense(obj) -> bool:
    return isinstance(obj, (torch.Tensor, np.ndarray))


def is_operator(obj) -> bool:
    """True if ``obj`` can act as a static operator on a state."""
    if _is_dense(obj) and np.ndim(obj) == 2:
        return True
    return hasattr(obj, "apply") and hasattr(obj, "shape")


def apply(op, psi):
    """Apply a static operator to a state: ``psi' = op @ psi``."""
    if _is_dense(op):
        if op.ndim != 2:
            raise ValueError(f"dense operator must be 2D, got shape {op.shape}")
        A, psi = _promote(as_tensor(op, device=psi.device), psi)
        return torch.einsum("ij,...j->...i", A, psi)
    applier = getattr(op, "apply", None)
    if applier is not None:
        return applier(psi)
    raise TypeError(f"object of type {type(op)} does not implement `apply`")


def op_dot(x, op, y):
    """Expectation-style inner product ``⟨x| op |y⟩``."""
    return vdot(x, apply(op, y))


def to_dense(op):
    """Materialize any operator as a dense torch matrix."""
    if _is_dense(op):
        return as_tensor(op)
    fn = getattr(op, "to_dense", None)
    if fn is not None:
        return fn()
    raise TypeError(f"cannot densify operator of type {type(op)}")


def op_shape(op) -> tuple:
    return tuple(op.shape)


def op_device(op) -> torch.device:
    """The device an operator's tensors live on (CPU for numpy
    operators)."""
    if isinstance(op, torch.Tensor):
        return op.device
    if isinstance(op, np.ndarray):
        return torch.device("cpu")
    for name in ("diag", "data", "site_mats"):
        t = getattr(op, name, None)
        if isinstance(t, torch.Tensor):
            return t.device
    mats = getattr(op, "group_mats", None)
    if mats:
        return op_device(mats[0])
    inner = getattr(op, "ops", None)
    if inner:
        return op_device(inner[0])
    inner = getattr(op, "operator", None)
    if inner is not None:
        return op_device(inner)
    return torch.device("cpu")


def to_scipy_sparse(op):
    """Convert any operator to a host ``scipy.sparse.csr_matrix``
    without a dense ``(N, N)`` intermediate for sparse inputs."""
    import scipy.sparse as sp

    if sp.issparse(op):
        return sp.csr_matrix(op)
    if isinstance(op, CSROperator):
        return op.to_scipy()
    if isinstance(op, DiagonalOperator):
        return sp.diags(host_np(op.diag)).tocsr()
    if _is_dense(op):
        return sp.csr_matrix(host_np(op))
    # ScaledOperator / other lazy operators
    scale = getattr(op, "coeff", None)
    inner = getattr(op, "operator", None)
    if scale is not None and inner is not None:
        return (complex(scale) * to_scipy_sparse(inner)).tocsr()
    return sp.csr_matrix(host_np(to_dense(op)))


# --------------------------------------------------------------------------
# Construction helpers (host-side)
# --------------------------------------------------------------------------

def csr_from_scipy(A, dtype=None, device=None) -> CSROperator:
    """Build a :class:`CSROperator` from any scipy sparse matrix."""
    A = A.tocsr()
    A.sum_duplicates()
    data = np.asarray(A.data)
    if dtype is None:
        data = data.astype(np.complex128 if A.dtype.kind == "c" else A.dtype)
    indptr = np.asarray(A.indptr, dtype=np.int64)
    row = np.repeat(np.arange(A.shape[0], dtype=np.int64), np.diff(indptr))
    return CSROperator(
        data=as_tensor(data, dtype=dtype, device=device),
        col=as_tensor(np.asarray(A.indices, dtype=np.int64), device=device),
        row=as_tensor(row, device=device),
        indptr=as_tensor(indptr, device=device),
        shape=tuple(A.shape),
    )


def csr_from_dense(A, tol: float = 0.0) -> CSROperator:
    """Build a :class:`CSROperator` from a dense matrix, dropping entries
    with ``|a_ij| <= tol``."""
    import scipy.sparse as sp

    device = A.device if isinstance(A, torch.Tensor) else None
    A = host_np(A)
    if tol > 0:
        A = np.where(np.abs(A) > tol, A, 0)
    return csr_from_scipy(sp.csr_matrix(A), device=device)


def add_operators(a, b):
    """Host-side structural sum of two static operators (used by the
    ``hamiltonian`` constructor when merging terms with identical
    amplitudes)."""
    if _is_dense(a) and _is_dense(b):
        x, y = _promote(as_tensor(a), as_tensor(b))
        return x + y.to(x.device)
    if isinstance(a, DiagonalOperator) and isinstance(b, DiagonalOperator):
        return DiagonalOperator(a.diag + b.diag)
    if isinstance(a, CSROperator) or isinstance(b, CSROperator):
        return csr_from_scipy(to_scipy_sparse(a) + to_scipy_sparse(b),
                              device=op_device(a))
    x, y = _promote(to_dense(a), to_dense(b))
    return x + y


def scale_operator(alpha, op):
    """Host-side structural scaling ``alpha * op``."""
    if _is_dense(op):
        return alpha * as_tensor(op)
    if isinstance(op, DiagonalOperator):
        return DiagonalOperator(alpha * op.diag)
    if isinstance(op, CSROperator):
        return dataclasses.replace(op, data=alpha * op.data)
    return alpha * to_dense(op)
