"""Distributed block-sparse (BSR) SpMV over a shard-slot mesh: PyTorch
port of :mod:`quantumpropagators.parallel.sharded_bsr`.

The state is sharded by BLOCK rows; each slot owns its slab of dense
``(b, b)`` blocks in blocked-ELL layout and applies it with one batched
``torch.einsum`` over contiguous block gathers (the JAX package's XLA
``dot_general``; no Pallas kernel there either).

- :func:`make_banded_bsr_apply`: every nonzero block within ``wb``
  block rows of its slot's slab, two edge exchanges of ``wb·b``
  entries per matvec, independent of ``N``.
- :func:`make_allgather_bsr_apply`: arbitrary block sparsity, one
  ``all_gather`` of the state per matvec.

Block-column ids are remapped on the host when partitioning, and slabs
are padded to the largest block degree.  The reference-accuracy forms
(``PartitionedBSRdd`` and the ``*_dd`` functions) keep the JAX names;
as everywhere in the port, their double-float pairs are float64
operators and complex128 states.

:class:`DistributedBSR` puts a partition behind the operator protocol
and carries its mesh, so Newton, Arnoldi, ``specrange`` and ``expv`` run
on a sharded state unchanged: matvecs are the halo (or all-gather)
SpMV, inner products per-slot partial sums over the mesh's ``psum``
(:func:`~..ops.operators.op_mesh`), where the JAX class relies on GSPMD.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..ops.df64_sparse import BSRdd, bsr_dd_from_scipy, cheby_dd_recurrence
from ..ops.cheby import cheby_apply
from ..ops.operators import (BSROperator, as_tensor, bsr_from_scipy, host_np,
                              resolve_device)
from ..utils.scan import graphed
from .mesh import STATE_AXIS, Mesh

__all__ = [
    "PartitionedBSR",
    "partition_bsr",
    "make_banded_bsr_apply",
    "make_allgather_bsr_apply",
    "banded_bsr_apply",
    "allgather_bsr_apply",
    "make_sharded_bsr_cheby_step",
    "PartitionedBSRdd",
    "partition_bsr_dd",
    "banded_bsr_apply_dd",
    "allgather_bsr_apply_dd",
    "make_sharded_bsr_cheby_step_dd",
    "DistributedBSR",
]


@dataclass(frozen=True)
class PartitionedBSR:
    """Block-row-partitioned blocked-ELL slabs, stacked over the slots.

    ``blocks``: ``(P, R_local, k, b, b)``; ``cols``: ``(P, R_local, k)``
    int64.  For ``halo_blocks >= 0`` (banded mode) cols are
    extended-local block ids in ``[0, R_local + 2·halo_blocks)``; for
    ``halo_blocks < 0`` (all-gather mode) cols are GLOBAL block ids.
    """

    blocks: Any
    cols: Any
    halo_blocks: int = 0
    n_block_rows_local: int = 0
    n_devices: int = 0
    block_size: int = 0
    shape: tuple = ()


#: the reference-accuracy partition: a :class:`PartitionedBSR` with
#: float64 blocks (the JAX class holds hi/lo float32 block planes)
PartitionedBSRdd = PartitionedBSR


def _partition_cols(nz, cols, n_devices, mode):
    """Shared block-row partition layout: from the nonzero mask ``nz``
    ``(R, k)`` and block-column ids ``cols``, compute the per-slot
    remapped column ids and the halo width.

    Returns ``(slab_cols int64 (P, Rl, k), halo, Rl)``: ``halo >= 0``
    means banded mode with extended-local ids in ``[0, Rl + 2·halo)``;
    ``halo == -1`` means all-gather mode with global ids."""
    R, k = cols.shape
    if R % n_devices:
        raise ValueError(
            f"{R} block-rows not divisible by {n_devices} devices"
        )
    Rl = R // n_devices
    lo = (np.arange(R) // Rl)[:, None] * Rl
    wb = int(
        max(
            (np.maximum(lo - cols, 0) * nz).max(initial=0),
            (np.maximum(cols - (lo + Rl - 1), 0) * nz).max(initial=0),
        )
    )
    banded_ok = wb <= Rl
    if mode == "banded" and not banded_ok:
        raise ValueError(
            f"block halo {wb} exceeds slab size {Rl}; use mode="
            "'allgather' or fewer devices"
        )
    use_banded = mode == "banded" or (mode == "auto" and banded_ok)
    slab_cols = cols.reshape(n_devices, Rl, k).astype(np.int64)
    if use_banded:
        nz3 = nz.reshape(n_devices, Rl, k)
        for d in range(n_devices):
            ext = slab_cols[d] - (d * Rl - wb)
            # padding (zero) blocks may carry col 0 anywhere in the
            # grid: point them at a guaranteed-local block instead
            slab_cols[d] = np.where(nz3[d], ext, wb)
        halo = wb
    else:
        halo = -1
    return slab_cols, halo, Rl


def _partition(op: BSROperator, n_devices, mode, device) -> PartitionedBSR:
    """The slabs of ``op`` on ``device``.  The block mask is reduced where
    the blocks live and only it and the column ids visit the host; the
    slabs are a view of ``op``'s blocks when those are already on
    ``device``."""
    blocks = as_tensor(op.blocks)
    cols = host_np(op.cols)
    R, k, b, _ = blocks.shape
    if op.shape[0] != R * b:
        raise ValueError(
            "partition_bsr requires a block-aligned operator "
            f"(logical dim {op.shape[0]} != {R}x{b}); pad the matrix "
            "to a multiple of the block size first"
        )
    nz = host_np(torch.linalg.vector_norm(  # (R, k) nonzero blocks
        blocks.reshape(R, k, -1), ord=float("inf"), dim=-1) > 0)
    slab_cols, halo, Rl = _partition_cols(nz, cols, n_devices, mode)
    return PartitionedBSR(
        blocks=blocks.reshape(n_devices, Rl, k, b, b).to(
            resolve_device(device)),
        cols=as_tensor(slab_cols, device=device),
        halo_blocks=halo,
        n_block_rows_local=Rl,
        n_devices=n_devices,
        block_size=b,
        shape=tuple(op.shape),
    )


def partition_bsr(
    A, n_devices: int, block_size: int = None, *, mode: str = "auto",
    device=None,
) -> PartitionedBSR:
    """Partition a matrix (scipy or :class:`BSROperator`) into per-slot
    BSR block-row slabs on ``device`` (default: the package's).

    ``mode``: ``'banded'`` (halo exchange; every nonzero block within
    one slab of the diagonal), ``'allgather'``, or ``'auto'`` (banded
    when the measured block halo fits, else all-gather).
    """
    op = A if isinstance(A, BSROperator) else bsr_from_scipy(
        A, block_size=block_size)
    return _partition(op, n_devices, mode, device)


def partition_bsr_dd(
    A, n_devices: int, block_size: int = None, *, mode: str = "auto",
    device=None,
) -> PartitionedBSRdd:
    """Partition a real-f64 scipy matrix (or a prebuilt float64
    :data:`~..ops.df64_sparse.BSRdd`) into per-slot float64 BSR slabs;
    the logical dimension is padded to a multiple of the block size."""
    op = A if isinstance(A, BSRdd) else bsr_dd_from_scipy(
        A, block_size=block_size)
    if op.blocks.is_complex() or op.blocks.dtype != torch.float64:
        raise ValueError("partition_bsr_dd needs float64 blocks")
    return _partition(op, n_devices, mode, device)


def _bsr_slab_matvec(blocks, cols, x_blocks):
    """Per slot ``s``: ``blocks[s] (Rl, k, b, b) · x_blocks[s][cols[s]]``
    → ``(n_local, Rl, b)``; ``x_blocks`` is ``(n_local, M, b)``."""
    S, M, b = x_blocks.shape
    offs = torch.arange(S, device=cols.device)[:, None, None] * M
    xg = x_blocks.reshape(S * M, b)[cols + offs]  # (S, Rl, k, b)
    if xg.is_complex() and not blocks.is_complex():
        # real blocks: contract re and im together, never promoting the
        # blocks to complex
        rdtype = torch.promote_types(xg.dtype.to_real(), blocks.dtype)
        xr = torch.view_as_real(xg.to(rdtype.to_complex()))
        y = _SlabContract.apply(blocks.to(rdtype), xr)
        return torch.view_as_complex(y.contiguous())
    dtype = torch.promote_types(blocks.dtype, xg.dtype)
    return _SlabContract.apply(blocks.to(dtype), xg.to(dtype))


class _SlabContract(torch.autograd.Function):
    """The slab matvec's contraction ``y[s,r,o(,x)] = Σ_{j,i}
    blocks[s,r,j,o,i] xg[s,r,j,i(,x)]``, the einsum itself forward; its
    backward reads the blocks where they lie (``xg`` is 4-D, or 5-D
    with the real and imaginary parts last).  The einsum's own backward
    would keep the permuted copy of the blocks its forward makes, one
    the size of the operator a call, as the call's residual."""

    @staticmethod
    def forward(ctx, blocks, xg):
        ctx.save_for_backward(blocks, xg)
        if xg.dim() == 5:
            return torch.einsum("srjoi,srjix->srox", blocks, xg)
        return torch.einsum("srjoi,srji->sro", blocks, xg)

    @staticmethod
    def backward(ctx, gy):
        blocks, xg = ctx.saved_tensors
        pair = xg.dim() == 5
        g = (gy if pair else gy[..., None])[:, :, None]  # (S, Rl, 1, b, X)
        g_blocks = g_x = None
        if ctx.needs_input_grad[1]:
            # every block's conjugate transpose against its row's
            # cotangent, as conj(blocksᵀ conj(g)): one small product a
            # block over a transposed view, no copy of the blocks (a
            # conjugated view of them would be made real)
            g_x = torch.matmul(blocks.mT, g.conj())
            g_x = (g_x if pair else g_x[..., 0]).conj_physical()
        if ctx.needs_input_grad[0]:
            x = (xg if pair else xg[..., None]).conj()
            g_blocks = torch.einsum("srjox,srjix->srjoi", g, x)
        return g_blocks, g_x


def _halo_extend(v_local, w, mesh: Mesh):
    """Edge halo exchange of ``w`` entries per side: returns the
    extended-local ``[left_halo | v_local | right_halo]`` of each slot
    (the global edges wrap around, where no nonzero block reads)."""
    left, right = mesh.halos(v_local, w)
    return torch.cat([left, v_local, right], dim=1)


def banded_bsr_apply(pbsr: PartitionedBSR, psi_local, *, mesh: Mesh,
                     axis_name=STATE_AXIS):
    """Block SpMV on this rank's slots ``psi_local`` (``(n_local,
    Rl·b)``) with nearest-neighbour halo exchange: two edge exchanges of
    ``halo_blocks·b`` entries."""
    b = pbsr.block_size
    wb = pbsr.halo_blocks
    x = psi_local
    if wb > 0:
        x = _halo_extend(psi_local, wb * b, mesh)
    y = _bsr_slab_matvec(mesh.local_rows(pbsr.blocks),
                         mesh.local_rows(pbsr.cols),
                         x.reshape(mesh.n_local, -1, b))
    return y.reshape(mesh.n_local, -1)


def allgather_bsr_apply(pbsr: PartitionedBSR, psi_local, *, mesh: Mesh,
                        axis_name=STATE_AXIS):
    """Block SpMV on this rank's slots over the whole gathered state
    (arbitrary block sparsity)."""
    b = pbsr.block_size
    full = mesh.all_gather(psi_local).reshape(1, -1, b)
    y = _bsr_slab_matvec(mesh.local_rows(pbsr.blocks),
                         mesh.local_rows(pbsr.cols),
                         full.expand(mesh.n_local, -1, -1))
    return y.reshape(mesh.n_local, -1)


def banded_bsr_apply_dd(pb: PartitionedBSRdd, x, *, mesh: Mesh,
                        axis_name=STATE_AXIS):
    """Reference-accuracy :func:`banded_bsr_apply` under the JAX names:
    ``pb`` a float64 partition, ``x`` this rank's float64 or complex128
    slots ``(n_local, Rl·b)`` (the JAX function takes one double-float
    plane pair)."""
    return banded_bsr_apply(pb, x, mesh=mesh)


def allgather_bsr_apply_dd(pb: PartitionedBSRdd, x, *, mesh: Mesh,
                           axis_name=STATE_AXIS):
    """Reference-accuracy :func:`allgather_bsr_apply` under the JAX
    names (see :func:`banded_bsr_apply_dd`)."""
    return allgather_bsr_apply(pb, x, mesh=mesh)


def _inner_for(pbsr: PartitionedBSR):
    return banded_bsr_apply if pbsr.halo_blocks >= 0 else allgather_bsr_apply


def _make_apply(mesh: Mesh, inner):
    def apply(pbsr, psi):
        return inner(pbsr, mesh.local(psi), mesh=mesh).reshape(psi.shape)

    return graphed(apply, mesh=mesh, operators=("pbsr",))


def make_banded_bsr_apply(mesh: Mesh, pbsr: PartitionedBSR):
    """Distributed block SpMV ``(pbsr, psi) -> H psi`` (halo); ``psi`` a
    sharded vector of the mesh, the result in its shape.  On the card
    each call of this and of :func:`make_allgather_bsr_apply` replays one
    CUDA graph (:func:`~..utils.scan.graphed`: the slabs read in place,
    ``psi`` copied in, one capture per partition); on a mesh whose group
    spans more than one rank the apply runs eagerly."""
    if pbsr.halo_blocks < 0:
        raise ValueError("pbsr was partitioned in all-gather mode")
    return _make_apply(mesh, banded_bsr_apply)


def make_allgather_bsr_apply(mesh: Mesh, pbsr: PartitionedBSR):
    """Distributed block SpMV (all-gather fallback)."""
    if pbsr.halo_blocks >= 0:
        raise ValueError("pbsr was partitioned in banded mode")
    return _make_apply(mesh, allgather_bsr_apply)


def make_sharded_bsr_cheby_step(
    mesh: Mesh,
    pbsr: PartitionedBSR,
    *,
    delta: float,
    e_min: float,
    dt: float,
    forward: bool = True,
):
    """Full Chebyshev step ``exp(-i H dt)`` over a block-partitioned BSR
    operator.  Returns ``step(pbsr, psi, coeffs) -> psi`` with ``psi`` a
    sharded vector of the mesh and ``coeffs`` a host array or a tensor
    on the card; each polynomial order costs one distributed block SpMV
    (two edge exchanges in banded mode).  On the card each call replays
    one CUDA graph (:func:`~..utils.scan.graphed`: the slabs read in
    place, ``psi`` and tensor coefficients copied in, one capture per
    partition and host coefficients); on a mesh whose group spans more
    than one rank the step runs eagerly."""
    inner = _inner_for(pbsr)

    def step(pb, psi, coeffs):
        out = cheby_apply(
            pb, mesh.local(psi), coeffs, delta, e_min, dt, forward=forward,
            apply_fn=lambda o, v: inner(o, v, mesh=mesh),
        )
        return out.reshape(psi.shape)

    return graphed(step, mesh=mesh, operators=("pb",))


def make_sharded_bsr_cheby_step_dd(
    mesh: Mesh,
    pbdd: PartitionedBSRdd,
    *,
    delta: float,
    e_min: float,
    dt: float,
    forward: bool = True,
):
    """Reference-accuracy Chebyshev step over a block-partitioned float64
    operator, in complex128.  Returns ``step(pbdd, state, coeffs_h,
    coeffs_l=0.0) -> state`` with ``state`` a complex128 sharded vector
    of the mesh and ``coeffs_h + coeffs_l`` the float64 Chebyshev
    coefficients (the JAX signature's double-float split; host arrays
    or tensors on the card).  On the card each call replays one CUDA
    graph (:func:`~..utils.scan.graphed`, as
    :func:`make_sharded_bsr_cheby_step`); on a mesh whose group spans
    more than one rank the step runs eagerly."""
    inner = _inner_for(pbdd)

    def step(pb, state, coeffs_h, coeffs_l=0.0):
        out = cheby_dd_recurrence(
            lambda v: inner(pb, v, mesh=mesh), mesh.local(state),
            coeffs_h, coeffs_l, delta, e_min, dt, forward,
        )
        return out.reshape(state.shape)

    return graphed(step, mesh=mesh, operators=("pb",))


@dataclass(frozen=True)
class DistributedBSR:
    """Operator-protocol wrapper around a partitioned BSR matrix on a
    shard-slot mesh (the JAX class's name and fields).

    ``shape`` is the global ``(N, N)``; ``apply(psi)`` takes this rank's
    ``(n_local, N/n)`` slots of a sharded state (with one rank, any
    tensor of all ``N`` entries) and returns ``H psi`` in the same
    layout, through the halo SpMV (``pbsr.halo_blocks >= 0``) or the
    all-gather one.  The wrapper carries ``mesh``, so the Krylov methods
    reduce over every slot (:func:`~..ops.operators.op_mesh`)."""

    mesh: Mesh
    pbsr: PartitionedBSR

    @property
    def shape(self):
        return self.pbsr.shape

    def apply(self, psi):
        inner = _inner_for(self.pbsr)
        return inner(self.pbsr, self.mesh.local(psi),
                     mesh=self.mesh).reshape(psi.shape)
