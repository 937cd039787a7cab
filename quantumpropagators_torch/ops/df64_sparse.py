"""Block-sparse operators at reference accuracy (PyTorch port of
:mod:`quantumpropagators.ops.df64_sparse`).

The JAX package's ``BSRdd`` keeps each entry of a real blocked-ELL
operator as a hi/lo f32 pair and contracts it with compensated sums,
because the TPU has no float64.  Here it is a float64
:class:`~.operators.BSROperator` (``BSRdd`` is that class) applied to a
complex128 state by :meth:`~.operators.BSROperator.apply`, and the
Chebyshev recurrence over it is :func:`.cheby.cheby_apply`, global phase
``exp(−iβ·dt)`` included (β = Δ/2 + E_min, nonzero for a generic
envelope).  :func:`cheby_apply_dd_bsr` is a graphed site inside an
:func:`~.arnoldi.arnoldi_sites` scope; :func:`bsr_apply_dd` stays one
eager product a call (one product has nothing to replay) and is captured
wherever a graph calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from .arnoldi import graphed_call
from .cheby import cheby_apply
from .operators import BSROperator, as_tensor, bsr_from_scipy

__all__ = [
    "dd_split_np",
    "bsr_dd_from_scipy",
    "bsr_apply_dd",
    "cheby_apply_dd_bsr",
    "cheby_dd_recurrence",
    "BSRdd",
]

#: the float64 blocked-ELL operator that stands for the JAX ``BSRdd``
BSRdd = BSROperator


def dd_split_np(x64, *, device=None) -> torch.Tensor:
    """Host float64 data as a float64 tensor (the JAX function splits it
    into hi/lo f32 planes)."""
    return as_tensor(np.asarray(x64, dtype=np.float64), device=device)


def bsr_dd_from_scipy(A, block_size: int = None, *,
                      device=None) -> BSROperator:
    """A real scipy sparse matrix as a float64 blocked-ELL operator.

    As in the JAX package, the logical dimension is padded up to a
    multiple of the block size and the operator's ``shape`` is the
    padded one: states must be zero-padded to ``shape[0]`` (the zero
    rows and columns keep the tail exactly zero)."""
    import scipy.sparse as sp

    from .operators import choose_block_size

    A = sp.csr_matrix(A)
    if np.iscomplexobj(A.data) and np.abs(A.data.imag).max() > 0:
        raise ValueError(
            "bsr_dd_from_scipy supports real operator entries; "
            "propagate complex generators via their real/imaginary "
            "parts or the Liouvillian embedding"
        )
    A = sp.csr_matrix(A.real.astype(np.float64))
    N = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ValueError("BSRdd requires a square matrix")
    b = int(block_size) if block_size else choose_block_size(N)
    n_pad = -(-N // b) * b
    if n_pad != N:
        A = sp.bmat(
            [[A, sp.csr_matrix((N, n_pad - N))],
             [sp.csr_matrix((n_pad - N, N)),
              sp.csr_matrix((n_pad - N, n_pad - N))]],
            format="csr",
        )
    return bsr_from_scipy(A, block_size=b, dtype=torch.float64,
                          device=device)


def bsr_apply_dd(op: BSROperator, x) -> torch.Tensor:
    """``y = A·x`` for a real float64 blocked-ELL operator."""
    return op.apply(x)


def cheby_dd_recurrence(apply_cdd, psi, coeffs_hi, coeffs_lo, delta, e_min,
                        dt, forward) -> torch.Tensor:
    """The Chebyshev recurrence over a complex128 matvec ``apply_cdd``,
    global phase included.  ``coeffs_hi + coeffs_lo`` are the float64
    coefficients (the JAX signature's split; ``coeffs_lo`` may be 0):
    host arrays, or a tensor ``coeffs_hi`` whose sum stays on its
    device."""
    if isinstance(coeffs_hi, torch.Tensor):
        coeffs = coeffs_hi.to(torch.float64) + coeffs_lo
    else:
        coeffs = (np.asarray(coeffs_hi, np.float64)
                  + np.asarray(coeffs_lo, np.float64))
    return cheby_apply(None, as_tensor(psi).to(torch.complex128), coeffs,
                       delta, e_min, dt, forward=forward,
                       apply_fn=lambda _op, v: apply_cdd(v))


def _cheby_dd_bsr_impl(op, psi, coeffs, delta, e_min, dt, forward):
    """The body of :func:`cheby_apply_dd_bsr` (the JAX
    ``_cheby_dd_bsr_impl``, jitted with ``shape_n``, ``delta``, ``e_min``,
    ``dt`` and ``forward`` static): the recurrence over ``op``'s blocks
    and columns read in place, the coefficients data."""
    coeffs = torch.as_tensor(coeffs).to(psi.device, torch.float64)
    return cheby_apply(op, psi, coeffs, delta, e_min, dt, forward=forward)


#: the site of :func:`cheby_apply_dd_bsr` (see :data:`.df64._APPLY`)
_APPLY = {"operators": ("op",), "controls": ("coeffs",), "lend": False}


def cheby_apply_dd_bsr(op: BSROperator, psi, coeffs, delta, e_min,
                       dt) -> torch.Tensor:
    """``exp(-i H dt)|psi⟩`` in complex128 over a real blocked-ELL
    operator; ``coeffs`` are host float64 Chebyshev coefficients.  A
    graphed site as :func:`.df64.cheby_apply_dd` is: inside an
    :func:`~.arnoldi.arnoldi_sites` scope a call replays the scope's
    graph (keyed on the operator's tensors and shape, ``delta``,
    ``e_min``, ``dt`` and the coefficient count), outside every scope it
    runs the body."""
    return graphed_call(_cheby_dd_bsr_impl, _APPLY, None, op,
                        as_tensor(psi).to(torch.complex128),
                        np.asarray(coeffs, dtype=np.float64), float(delta),
                        float(e_min), float(dt), dt > 0)
