"""Sharded banded Chebyshev step at reference accuracy: PyTorch port of
:mod:`quantumpropagators.parallel.sharded_banded`.

The band planes of a :class:`~..ops.bsr_dd.BandedDD` are split by block
rows over the slots of a :class:`~.mesh.Mesh`, with the CROSS-SHARD
edge blocks zeroed out of each slot's planes and moved into small dense
``(wb·b, wb·b)`` edge matrices.  Each matvec then costs

1. one ``wb·b``-entry exchange per direction (the minimal halo,
   independent of the slot size),
2. the unmodified clamped-mode ``banded_spmv<double>`` kernel
   (:mod:`..ops.banded_spmv`) on each slot's interior: its reads past
   the slot's edges see zero rows, and the blocks that would have met
   them are zero, and
3. a dense edge correction ``y[:w] += E_L·left_halo``,
   ``y[−w:] += E_R·right_halo``: one complex128 ``torch.matmul`` each.

The names keep the JAX package's: ``"banded_pallas"`` in
:func:`make_sharded_dd_cheby_step` means ``banded_spmv<double>`` here,
and the ``*_dd`` objects hold float64 planes and complex128 states.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..ops.banded_spmv import banded_spmv
from ..ops.bsr_dd import BandedDD, banded_dd_from_bsr, banded_dd_from_scipy
from ..ops.df64_sparse import cheby_dd_recurrence
from ..ops.operators import BSROperator
from ..utils.scan import graphed
from .mesh import STATE_AXIS, Mesh

__all__ = [
    "PartitionedBandedDD",
    "partition_banded_dd",
    "banded_pallas_apply_dd",
    "banded_pallas_apply_cdd",
    "make_sharded_banded_cheby_step_dd",
    "make_sharded_dd_cheby_step",
]


@dataclass(frozen=True)
class PartitionedBandedDD:
    """Block-row split of a :class:`~..ops.bsr_dd.BandedDD` across the
    slots.

    ``planes``: ``(P, n_bands, b, R_local, b)`` float64 with the
    CROSS-SHARD edge blocks ZEROED, so each slot's product is the plain
    clamped-mode kernel.  The removed blocks live in ``edge_left`` /
    ``edge_right``, ``(P, wb·b, wb·b)`` float64: row ``o`` of the slot's
    first (last) ``wb·b`` rows, column ``i`` of the ``wb·b``-entry left
    (right) halo.  The JAX class holds hi/lo float32 pairs of each."""

    planes: Any
    edge_left: Any = None
    edge_right: Any = None
    offsets: tuple = ()
    R_local: int = 0
    n_devices: int = 0
    b: int = 128
    wb: int = 1
    tile_rows: int = 8
    shape: tuple = ()
    logical_nnz: int = 0


def partition_banded_dd(
    A, n_devices: int, *, tile_rows: int = 8, block: int = 128,
    max_bands: int = 9, device=None,
) -> PartitionedBandedDD:
    """Split a banded operator into per-slot band-plane slabs on the
    operator's device.

    ``A`` is a :class:`BandedDD` or a real :class:`BSROperator` of
    block size ``block`` (both split on their own device, no host copy;
    at 2^20 a host scipy matrix would need about 15 GB), or a scipy
    matrix (re-blocked to ``block`` on ``device``).  Cross-shard edge
    blocks move out of the planes into the edge matrices.

    Requires the global block-row count divisible by
    ``n_devices·tile_rows`` and every band offset within ``tile_rows``
    (the JAX kernel's tile; kept so that both packages accept the same
    operators); raises otherwise, and :func:`make_sharded_dd_cheby_step`
    falls back to the blocked-ELL chain."""
    if isinstance(A, BandedDD):
        op = A
    elif isinstance(A, BSROperator) and A.block_size == block:
        op = banded_dd_from_bsr(A, max_bands=max_bands)
    else:
        op = banded_dd_from_scipy(A, max_bands=max_bands, block=block,
                                  device=device)
    wb = max((abs(d) for d in op.offsets), default=0)
    if wb > tile_rows:
        raise ValueError(
            f"band offset {wb} exceeds tile_rows {tile_rows}: halo "
            "does not fit one edge tile"
        )
    if op.R % (n_devices * tile_rows):
        raise ValueError(
            f"{op.R} block rows not divisible by n_devices·tile_rows "
            f"= {n_devices}·{tile_rows}"
        )
    Rl, b, P_ = op.R // n_devices, op.b, n_devices
    nb = len(op.offsets)
    # (nb, b, R, b) -> (P, nb, b, Rl, b): one copy, the slots' planes
    planes = op.planes.reshape(nb, b, P_, Rl, b).permute(2, 0, 1, 3, 4) \
        .contiguous()
    w = max(wb, 1) * b
    EL = planes.new_zeros((P_, w, w))
    ER = planes.new_zeros((P_, w, w))
    for dev in range(P_):
        for k, d in enumerate(op.offsets):
            # block (r, r + d) of the slot sits at planes[dev, k, :, r, :]
            # as [i_col, o_row]; move the ones whose column block lies in
            # a neighbour's slab
            if d < 0:
                for r in range(min(-d, Rl)):
                    p = wb + r + d  # block position in the left halo
                    EL[dev, r * b:(r + 1) * b, p * b:(p + 1) * b] = \
                        planes[dev, k, :, r, :].T
                    planes[dev, k, :, r, :] = 0.0
            elif d > 0:
                for r in range(max(Rl - d, 0), Rl):
                    p = r + d - Rl  # block position in the right halo
                    rr = r - (Rl - wb)
                    ER[dev, rr * b:(rr + 1) * b, p * b:(p + 1) * b] = \
                        planes[dev, k, :, r, :].T
                    planes[dev, k, :, r, :] = 0.0
    return PartitionedBandedDD(
        planes=planes, edge_left=EL, edge_right=ER,
        offsets=op.offsets,
        R_local=Rl,
        n_devices=n_devices,
        b=b,
        wb=max(wb, 1),
        tile_rows=tile_rows,
        shape=op.shape,
        logical_nnz=op.logical_nnz,
    )


def _edge_correct(pb: PartitionedBandedDD, y, left_halo, right_halo,
                  mesh: Mesh):
    """``y[:, :w] += E_L·left_halo``; ``y[:, −w:] += E_R·right_halo`` for
    each local slot: one complex128 ``torch.matmul`` per side."""
    w = pb.wb * pb.b
    for E, halo, rows in ((pb.edge_left, left_halo, slice(0, w)),
                          (pb.edge_right, right_halo, slice(-w, None))):
        E = mesh.local_rows(E).to(y.dtype)
        y[:, rows] += torch.matmul(E, halo.unsqueeze(-1)).squeeze(-1)
    return y


def banded_pallas_apply_cdd(
    pb: PartitionedBandedDD, v, *, mesh: Mesh, axis_name=STATE_AXIS,
    interpret: bool = False,
):
    """Complex128 banded SpMV on this rank's slots ``v`` (``(n_local,
    R_local·b)``): the halo exchange, one clamped-mode
    ``banded_spmv<double>`` per slot over its planes, and the edge
    correction."""
    x = v.to(torch.complex128)
    # one exchange per direction; the ring wraps at the global edges,
    # where the edge matrices' rows are zero
    left, right = mesh.halos(x, pb.wb * pb.b)
    planes = mesh.local_rows(pb.planes)
    y = torch.stack([banded_spmv(planes[s], pb.offsets, x[s].contiguous())
                     for s in range(mesh.n_local)])
    return _edge_correct(pb, y, left, right, mesh)


def banded_pallas_apply_dd(
    pb: PartitionedBandedDD, x, *, mesh: Mesh, axis_name=STATE_AXIS,
    interpret: bool = False,
):
    """Banded SpMV of one real float64 plane (the JAX double-float
    vector) or of a complex128 state; returns ``x``'s dtype."""
    y = banded_pallas_apply_cdd(pb, x, mesh=mesh)
    return y if x.is_complex() else y.real.contiguous()


def make_sharded_banded_cheby_step_dd(
    mesh: Mesh,
    pb: PartitionedBandedDD,
    *,
    delta: float,
    e_min: float,
    dt: float,
    forward: bool = True,
    interpret: bool = None,
):
    """Reference-accuracy sharded banded Chebyshev step on
    ``banded_spmv<double>``.  Returns ``step(pb, state, coeffs_h,
    coeffs_l=0.0) -> state`` with ``state`` a complex128 sharded vector
    of the mesh and the coefficients host arrays or tensors on the card;
    each polynomial order costs one edge exchange per direction and one
    kernel launch per slot.  ``interpret`` is accepted for parity with
    the JAX package.

    On the card each call replays one CUDA graph of the step
    (:func:`~..utils.scan.graphed`: ``pb``'s planes read in place, the
    state and tensor coefficients copied in, one capture per partition
    and host coefficients); on a mesh whose group spans more than one
    rank the step runs eagerly."""

    def step(p, state, coeffs_h, coeffs_l=0.0):
        out = cheby_dd_recurrence(
            lambda v: banded_pallas_apply_cdd(p, v, mesh=mesh),
            mesh.local(state), coeffs_h, coeffs_l, delta, e_min, dt,
            forward,
        )
        return out.reshape(state.shape)

    return graphed(step, mesh=mesh, operators=("p",))


def make_sharded_dd_cheby_step(
    mesh: Mesh,
    A,
    n_devices: int,
    *,
    delta: float,
    e_min: float,
    dt: float,
    forward: bool = True,
    tile_rows: int = 8,
    block_size: int = None,
    kernel: str = "auto",
):
    """Partition a real-f64 operator and build the sharded
    reference-accuracy Chebyshev step for it.

    ``kernel='auto'`` picks the banded path (``"banded_pallas"``, on
    ``banded_spmv<double>``) when the operator is block-banded at
    ``block_size`` (default 128) with the halo inside one edge tile,
    else the blocked-ELL chain (``"bsr_xla"``,
    :func:`.sharded_bsr.make_sharded_bsr_cheby_step_dd`).  Returns
    ``(partitioned, step, kind)``."""
    from .sharded_bsr import make_sharded_bsr_cheby_step_dd, \
        partition_bsr_dd

    if kernel not in ("auto", "banded_pallas", "bsr_xla"):
        raise ValueError(f"unknown kernel={kernel!r}")
    if kernel in ("auto", "banded_pallas"):
        try:
            pb = partition_banded_dd(
                A, n_devices, tile_rows=tile_rows,
                block=(block_size or 128), device=mesh.device,
            )
            step = make_sharded_banded_cheby_step_dd(
                mesh, pb, delta=delta, e_min=e_min, dt=dt, forward=forward,
            )
            return pb, step, "banded_pallas"
        except ValueError:
            if kernel == "banded_pallas":
                raise
    pbdd = partition_bsr_dd(A, n_devices, block_size=block_size,
                            device=mesh.device)
    step = make_sharded_bsr_cheby_step_dd(
        mesh, pbdd, delta=delta, e_min=e_min, dt=dt, forward=forward,
    )
    return pbdd, step, "bsr_xla"
