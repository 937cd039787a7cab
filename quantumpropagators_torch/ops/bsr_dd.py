"""Banded block operators at reference accuracy (PyTorch port of
:mod:`quantumpropagators.ops.bsr_dd_pallas`).

The JAX package keeps each operator entry as a hi/lo float32 pair
because the TPU has no float64; the H100 has, so the port holds one
float64 ``planes`` tensor in the same band-major layout, and the state
is complex128.  The product itself is :mod:`.banded_spmv` (the CUDA
kernel ``csrc/banded_spmv.cu`` and its plain version).

Scope: **block-banded** real operators with static block-diagonal
offsets (≤ ``max_bands``) — optomech/transmon kron chains, lattice
discretizations, re-blocked BSR chains.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .banded_spmv import (  # noqa: F401  (re-exported, as the JAX module does)
    banded_dd_apply,
    banded_dd_apply_extended,
)
from .cheby import cheby_apply
from .operators import as_tensor

__all__ = [
    "BandedDD",
    "banded_dd_from_scipy",
    "banded_dd_from_bsr",
    "banded_dd_apply",
    "banded_dd_apply_extended",
    "cheby_apply_dd_banded",
]

_B = 128  # block size after re-blocking on the card


@dataclass(frozen=True)
class BandedDD:
    """Band-major banded block operator.

    ``planes``: ``(n_bands, b, R, b)`` float64 with entry ``[k, i, r, o]
    = A[r·b + o, (r + offsets[k])·b + i]``.  ``offsets`` is a static
    tuple of block-diagonal offsets; blocks outside the matrix are zero.
    """

    planes: Any
    offsets: tuple = ()
    R: int = 0
    b: int = _B
    shape: tuple = ()
    logical_nnz: int = 0


def _check_bands(offsets, max_bands, b):
    if len(offsets) > max_bands:
        raise ValueError(
            f"{len(offsets)} block-diagonal offsets after re-blocking "
            f"(> {max_bands}): not a banded operator at block size {b}"
        )


def banded_dd_from_scipy(A, max_bands: int = 9, block: int = _B,
                         device=None) -> BandedDD:
    """Re-block a real banded scipy matrix to ``block``-blocks and
    extract its block-diagonal bands.

    The logical dimension is zero-padded up to a multiple of ``block``;
    the operator must be block-banded after re-blocking (≤ ``max_bands``
    distinct block-diagonal offsets — guards against densifying a
    non-banded matrix into ``R`` bands)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    if np.iscomplexobj(A.data) and np.abs(A.data.imag).max() > 0:
        raise ValueError("banded_dd_from_scipy supports real entries")
    A = sp.csr_matrix(A.real.astype(np.float64))
    b = int(block)
    N = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ValueError("BandedDD requires a square matrix")
    n_pad = -(-N // b) * b
    if n_pad != N:
        A = sp.bmat(
            [[A, sp.csr_matrix((N, n_pad - N))],
             [sp.csr_matrix((n_pad - N, N)),
              sp.csr_matrix((n_pad - N, n_pad - N))]],
            format="csr",
        )
    Bm = A.tobsr(blocksize=(b, b))
    Bm.eliminate_zeros()
    R = n_pad // b
    rows = np.repeat(np.arange(R), np.diff(Bm.indptr))
    diags = Bm.indices.astype(np.int64) - rows
    offsets = tuple(int(d) for d in np.unique(diags))
    _check_bands(offsets, max_bands, b)
    planes = np.zeros((len(offsets), b, R, b), dtype=np.float64)
    kmap = {d: k for k, d in enumerate(offsets)}
    for j, (r, d) in enumerate(zip(rows, diags)):
        # block (b_out, b_in) → planes[k, b_in, r, b_out]
        planes[kmap[int(d)], :, r, :] = Bm.data[j].T
    return BandedDD(
        planes=as_tensor(planes, device=device),
        offsets=offsets,
        R=R,
        b=b,
        shape=(n_pad, n_pad),
        logical_nnz=int(A.nnz),
    )


def banded_dd_from_bsr(op, max_bands: int = 9) -> BandedDD:
    """The :class:`BandedDD` of a real :class:`~.operators.BSROperator`,
    built on the operator's device without a host copy: each block
    ``blocks[r, j]`` goes to ``planes[k, :, r, :]`` transposed, with
    ``k`` the band of ``cols[r, j] − r``.  All-zero blocks (the
    blocked-ELL padding, which points at block-column 0) are dropped
    first, exactly as ``to_scipy_sparse`` + ``eliminate_zeros`` drop
    them, so they never add a spurious offset ``−r``; the result equals
    :func:`banded_dd_from_scipy` of the same operator, offsets and
    planes bit for bit."""
    blocks = op.blocks
    if blocks.is_complex():
        if bool((blocks.imag != 0).any()):
            raise ValueError("banded_dd_from_scipy supports real entries")
        blocks = blocks.real
    blocks = blocks.to(torch.float64)
    R, _, b, _ = blocks.shape
    rr, jj = torch.nonzero((blocks != 0).flatten(2).any(-1), as_tuple=True)
    diags = op.cols[rr, jj].to(torch.int64) - rr
    offs_t, band = torch.unique(diags, sorted=True, return_inverse=True)
    offsets = tuple(int(d) for d in offs_t.tolist())
    _check_bands(offsets, max_bands, b)
    planes = torch.zeros((len(offsets), b, R, b), dtype=torch.float64,
                         device=blocks.device)
    # planes viewed as [k, r, i, o] takes block[o, i] transposed
    planes.permute(0, 2, 1, 3)[band, rr] = blocks[rr, jj].transpose(-1, -2)
    return BandedDD(
        planes=planes,
        offsets=offsets,
        R=R,
        b=b,
        shape=(R * b, R * b),
        logical_nnz=int(torch.count_nonzero(planes)),
    )


def cheby_apply_dd_banded(op: BandedDD, psi, coeffs, delta, e_min, dt,
                          *, tile_rows: int = 8, out=None):
    """``exp(-i H dt)|psi⟩`` for a banded operator at reference accuracy:
    the complex128 Chebyshev recurrence (:func:`.cheby.cheby_apply`) with
    the banded SpMV as its matvec and the host-computed global phase
    ``exp(−iβ·dt)``.  ``psi`` is a complex128 vector of ``R·b``
    entries on the operator's device; ``coeffs`` host float64; ``out``
    (optional) a complex128 buffer of ``psi``'s shape for the result."""

    def apply_fn(_op, v):
        return banded_dd_apply(op, v, tile_rows=tile_rows)

    return cheby_apply(
        op, psi.to(torch.complex128), np.asarray(coeffs, dtype=np.float64),
        delta, e_min, dt, forward=dt > 0, apply_fn=apply_fn, out=out,
    )

