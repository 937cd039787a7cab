"""Distributed generic sparse (CSR) SpMV over a shard-slot mesh: PyTorch
port of :mod:`quantumpropagators.parallel.sharded_csr`.

The state is row-sharded and each slot owns the CSR slab of its rows.
Two communication strategies:

- :func:`make_allgather_csr_apply` gathers the whole state every
  matvec: right for ARBITRARY sparsity, ``(P−1)/P · N`` entries moved.
- :func:`make_banded_csr_apply`: when every nonzero lies within a
  bandwidth ``w`` of its slot's rows, each slot needs only ``w`` halo
  entries from each neighbour: two edge exchanges per matvec,
  independent of ``N``.

Column indices are remapped on the host when partitioning, so the
product is a plain gather and ``index_add_`` (the JAX package computes
it in XLA, outside any Pallas kernel); slabs are padded to the largest
slot's nnz with zero entries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..ops.operators import CSROperator, _promote, as_tensor
from ..utils.scan import graphed
from .mesh import STATE_AXIS, Mesh

__all__ = [
    "PartitionedCSR",
    "BandedPartitionedCSR",
    "partition_csr_rows",
    "partition_csr_banded",
    "make_allgather_csr_apply",
    "make_banded_csr_apply",
]


@dataclass(frozen=True)
class PartitionedCSR:
    """Row-partitioned CSR slabs, stacked over the slots.

    ``data``/``col``/``row`` have shape ``(P, nnz_max)`` (zero-padded;
    padding entries point at row 0 / col 0 with zero data).  ``col``
    holds GLOBAL column indices; ``row`` holds LOCAL row indices.
    """

    data: Any  # (P, nnz_max)
    col: Any  # (P, nnz_max) int64, global
    row: Any  # (P, nnz_max) int64, local
    n_rows_local: int = 0
    n_devices: int = 0
    shape: tuple = ()


@dataclass(frozen=True)
class BandedPartitionedCSR:
    """Row-partitioned CSR with columns remapped into the extended
    local vector ``[left_halo | local | right_halo]`` (halo width
    ``w``); requires all nonzeros within ``w`` of the local block."""

    data: Any  # (P, nnz_max)
    col: Any  # (P, nnz_max) int64, extended-local (0 .. 2w+n_local-1)
    row: Any  # (P, nnz_max) int64, local
    halo: int = 0
    n_rows_local: int = 0
    n_devices: int = 0
    shape: tuple = ()


def _pad_slabs(slabs, device):
    """Pad per-slot (data, col, row) triples to uniform nnz."""
    nnz_max = max(len(d) for d, c, r in slabs)
    P_ = len(slabs)
    dtype = slabs[0][0].dtype
    if dtype.kind == "c":
        dtype = np.complex128
    data = np.zeros((P_, nnz_max), dtype=dtype)
    col = np.zeros((P_, nnz_max), dtype=np.int64)
    row = np.zeros((P_, nnz_max), dtype=np.int64)
    for i, (d, c, r) in enumerate(slabs):
        data[i, : len(d)] = d
        col[i, : len(c)] = c
        row[i, : len(r)] = r
    return (as_tensor(data, device=device), as_tensor(col, device=device),
            as_tensor(row, device=device))


def _host_csr(A, n_devices):
    if isinstance(A, CSROperator):
        A = A.to_scipy()
    A = A.tocsr()
    N = A.shape[0]
    if N % n_devices:
        raise ValueError(f"matrix dim {N} not divisible by {n_devices} devices")
    return A, N // n_devices


def _slab(A, d, n_local):
    S = A[d * n_local: (d + 1) * n_local].tocoo()
    order = np.lexsort((S.col, S.row))
    return S.data[order], S.col[order], S.row[order]


def partition_csr_rows(A, n_devices: int, *, device=None) -> PartitionedCSR:
    """Partition a scipy CSR (or :class:`CSROperator`) into row slabs on
    ``device`` (default: the package's default device)."""
    A, n_local = _host_csr(A, n_devices)
    slabs = [_slab(A, d, n_local) for d in range(n_devices)]
    data, col, row = _pad_slabs(slabs, device)
    return PartitionedCSR(data=data, col=col, row=row, n_rows_local=n_local,
                          n_devices=n_devices, shape=tuple(A.shape))


def partition_csr_banded(A, n_devices: int, *,
                         device=None) -> BandedPartitionedCSR:
    """Partition a banded CSR into row slabs with neighbour halos.

    The halo width is the largest distance of any nonzero column from
    its slot's rows, and must not exceed the slot size (only
    nearest-neighbour exchange is generated).
    """
    A, n_local = _host_csr(A, n_devices)
    coo = A.tocoo()
    lo = (coo.row // n_local) * n_local
    w = int(
        max(
            np.maximum(lo - coo.col, 0).max(initial=0),
            np.maximum(coo.col - (lo + n_local - 1), 0).max(initial=0),
        )
    )
    if w > n_local:
        raise ValueError(
            f"bandwidth halo {w} exceeds block size {n_local}; use the "
            "all-gather path or fewer devices"
        )
    slabs = []
    for d in range(n_devices):
        data, cols, rows = _slab(A, d, n_local)
        # remap global -> extended-local [0, 2w + n_local)
        ext = cols - (d * n_local - w)
        if ext.min(initial=0) < 0 or (len(ext) and ext.max() >= n_local + 2 * w):
            raise ValueError("nonzero outside nearest-neighbor halo")
        slabs.append((data, ext, rows))
    data, col, row = _pad_slabs(slabs, device)
    return BandedPartitionedCSR(data=data, col=col, row=row, halo=w,
                                n_rows_local=n_local, n_devices=n_devices,
                                shape=tuple(A.shape))


def _csr_slab_matvec(data, col, row, x, n_rows):
    """Per slot ``s``: ``y[s] = Σ data[s]·x[s, col[s]]`` summed into
    ``row[s]``; ``x`` is ``(n_local, M)``, the result ``(n_local,
    n_rows)``.  The sum is an accumulating ``index_put_``, which adds
    each row's entries in their order (on the card after a stable sort
    of the indices), so every call gives the same bits; ``index_add_``
    adds with atomics on the card, in an order that varies."""
    data, x = _promote(data, x)
    prod = data * torch.gather(x, 1, col)
    S = prod.shape[0]
    offs = torch.arange(S, device=row.device)[:, None] * n_rows
    out = torch.zeros(S * n_rows, dtype=prod.dtype, device=prod.device)
    return out.index_put_(((row + offs).reshape(-1),), prod.reshape(-1),
                          accumulate=True).view(S, n_rows)


def _local_slabs(pcsr, mesh: Mesh):
    return (mesh.local_rows(pcsr.data), mesh.local_rows(pcsr.col),
            mesh.local_rows(pcsr.row))


def allgather_csr_apply(pcsr: PartitionedCSR, psi_local, *, mesh: Mesh,
                        axis_name=STATE_AXIS):
    """SpMV on this rank's slots ``psi_local`` (``(n_local,
    n_rows_local)``): gather the full state, apply each slot's slab."""
    data, col, row = _local_slabs(pcsr, mesh)
    full = mesh.all_gather(psi_local).reshape(1, -1)
    return _csr_slab_matvec(data, col, row, full.expand(mesh.n_local, -1),
                            pcsr.n_rows_local)


def banded_csr_apply(pcsr: BandedPartitionedCSR, psi_local, *, mesh: Mesh,
                     axis_name=STATE_AXIS):
    """SpMV on this rank's slots with nearest-neighbour halo exchange:
    two edge exchanges of width ``halo``."""
    w = pcsr.halo
    if w == 0:
        ext = psi_local
    else:  # the global edges wrap around, where no nonzero reads
        left, right = mesh.halos(psi_local, w)
        ext = torch.cat([left, psi_local, right], dim=1)
    data, col, row = _local_slabs(pcsr, mesh)
    return _csr_slab_matvec(data, col, row, ext, pcsr.n_rows_local)


def _make_apply(mesh: Mesh, inner):
    def apply(pcsr, psi):
        return inner(pcsr, mesh.local(psi), mesh=mesh).reshape(psi.shape)

    return graphed(apply, mesh=mesh, operators=("pcsr",))


def make_allgather_csr_apply(mesh: Mesh, pcsr: PartitionedCSR):
    """Distributed SpMV ``(pcsr, psi) -> H psi`` (all-gather); ``psi``
    a sharded vector of the mesh, the result in its shape.  On the card
    each call of this and of :func:`make_banded_csr_apply` replays one
    CUDA graph (:func:`~..utils.scan.graphed`: the slabs read in place,
    ``psi`` copied in, one capture per partition); on a mesh whose group
    spans more than one rank the apply runs eagerly."""
    return _make_apply(mesh, allgather_csr_apply)


def make_banded_csr_apply(mesh: Mesh, pcsr: BandedPartitionedCSR):
    """Distributed SpMV ``(pcsr, psi) -> H psi`` (halo)."""
    return _make_apply(mesh, banded_csr_apply)
