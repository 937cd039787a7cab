"""Carrying objects between the JAX package and the port.

:func:`from_jax` turns the JAX package's states, dense arrays, operators
and generators, its double-float values and operators (as float64
or complex128 ``hi + lo``), and its sharded partitions (CSR, BSR,
banded, and ``ShardedSiteSum``) and ``DistributedBSR`` into the
port's, through numpy;
:func:`to_numpy` is the way back for tensors.  Nothing here imports jax: objects are recognized
by class name and attributes (``.diag``, ``.site_mats``, ``.L``,
``.active``, ``.ops``, ``.coeffs``, ``.amplitudes``), so the same code
also accepts the port's own objects.  Control callables and amplitude
objects pass through unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.generators import Generator, Operator, ScaledOperator
from .models.lattice import GroupedSiteSum, SiteOperatorSum
from .ops.bsr_dd import BandedDD
from .ops.dd_linalg import CDDOp, DenseDDOp, TermsDDOp
from .ops.operators import (
    BSROperator,
    CSROperator,
    DiagonalOperator,
    DIAOperator,
    StackedCSROperator,
    host_np,
    resolve_device,
)
from .parallel import sharded_csr
from .parallel.sharded_banded import PartitionedBandedDD
from .parallel.sharded_bsr import DistributedBSR, PartitionedBSR
from .parallel.sharded_chain import ShardedSiteSum

__all__ = ["from_jax", "to_numpy"]


def _tensor(x, device):
    return torch.as_tensor(np.array(host_np(x)), device=resolve_device(device))


def _index(x, device):
    return _tensor(x, device).to(torch.int64)


def _f64(x) -> np.ndarray:
    return np.asarray(host_np(x), dtype=np.float64)


def from_jax(obj, device=None, *, mesh=None):
    """The port's counterpart of ``obj`` (a JAX array, a numpy array, an
    operator, an :class:`Operator`/:class:`Generator`, or a tuple/list
    of these), with its tensors on ``device`` (default: the package's
    :func:`~.ops.operators.default_device`).  A JAX ``DistributedBSR``
    becomes the port's on ``mesh``, a :class:`~.parallel.mesh.Mesh` the
    caller builds (a JAX mesh has no port counterpart)."""
    name = type(obj).__name__
    # the JAX DD / CDD pairs are named tuples: matched before tuples
    if name == "DD":
        # a double-float pair: the float64 value hi + lo
        return _tensor(_f64(obj.hi) + _f64(obj.lo), device)
    if name == "CDD":
        return torch.complex(from_jax(obj.re, device), from_jax(obj.im, device))
    if isinstance(obj, (tuple, list)):
        return type(obj)(from_jax(o, device, mesh=mesh) for o in obj)
    if name in ("CSROperator", "StackedCSROperator"):
        cls = CSROperator if name == "CSROperator" else StackedCSROperator
        return cls(
            data=_tensor(obj.data, device),
            col=_index(obj.col, device),
            row=_index(obj.row, device),
            indptr=_index(obj.indptr, device),
            shape=tuple(int(n) for n in obj.shape),
        )
    if name == "DIAOperator":
        return DIAOperator(data=_tensor(obj.data, device),
                           offsets=tuple(int(o) for o in obj.offsets),
                           shape=tuple(int(n) for n in obj.shape))
    if name == "BSROperator":
        return BSROperator(blocks=_tensor(obj.blocks, device),
                           cols=_index(obj.cols, device),
                           shape=tuple(int(n) for n in obj.shape),
                           block_size=int(obj.block_size))
    if name == "BandedDD":
        # one float64 plane tensor in place of the hi/lo float32 pair
        planes = getattr(obj, "planes", None)
        if planes is None:
            planes = _f64(obj.planes_hi) + _f64(obj.planes_lo)
        return BandedDD(planes=_tensor(planes, device),
                        offsets=tuple(int(o) for o in obj.offsets),
                        R=int(obj.R), b=int(obj.b),
                        shape=tuple(int(n) for n in obj.shape),
                        logical_nnz=int(obj.logical_nnz))
    if name == "DenseDDOp":
        mat = getattr(obj, "mat", None)
        if mat is None:  # the JAX class: re/im × hi/lo f32 planes
            mat = _f64(obj.re_hi) + _f64(obj.re_lo) + 0j
            if obj.im_hi is not None:
                mat = mat + 1j * (_f64(obj.im_hi) + _f64(obj.im_lo))
        return DenseDDOp(_tensor(mat, device).to(torch.complex128))
    if name == "CDDOp":
        return CDDOp(from_jax(obj.re, device),
                     None if obj.im is None else from_jax(obj.im, device),
                     tuple(int(n) for n in obj.shape))
    if name == "TermsDDOp":
        c = np.asarray(host_np(obj.coeffs4))
        if c.ndim == 2:  # the JAX (4, n) hi/lo planes
            c = (c[0].astype(np.float64) + c[1]) + 1j * (
                c[2].astype(np.float64) + c[3])
        return TermsDDOp(from_jax(tuple(obj.terms), device, mesh=mesh),
                         c.astype(np.complex128),
                         tuple(int(n) for n in obj.shape))
    if name == "BSRdd":
        # float64 blocks of the padded (n_pad, n_pad) operator
        return BSROperator(
            blocks=_tensor(_f64(obj.blocks_hi) + _f64(obj.blocks_lo), device),
            cols=_index(obj.cols, device),
            shape=tuple(int(n) for n in obj.shape),
            block_size=int(obj.block_size))
    if name in ("PartitionedCSR", "BandedPartitionedCSR"):
        extra = {"halo": int(obj.halo)} if hasattr(obj, "halo") else {}
        return getattr(sharded_csr, name)(
            data=_tensor(obj.data, device), col=_index(obj.col, device),
            row=_index(obj.row, device), n_rows_local=int(obj.n_rows_local),
            n_devices=int(obj.n_devices),
            shape=tuple(int(n) for n in obj.shape), **extra)
    if name in ("PartitionedBSR", "PartitionedBSRdd"):
        blocks = (_f64(obj.blocks_hi) + _f64(obj.blocks_lo)
                  if name == "PartitionedBSRdd" else obj.blocks)
        return PartitionedBSR(
            blocks=_tensor(blocks, device), cols=_index(obj.cols, device),
            halo_blocks=int(obj.halo_blocks),
            n_block_rows_local=int(obj.n_block_rows_local),
            n_devices=int(obj.n_devices), block_size=int(obj.block_size),
            shape=tuple(int(n) for n in obj.shape))
    if name == "PartitionedBandedDD":
        def f64(field):
            return _tensor(_f64(getattr(obj, field + "_hi"))
                           + _f64(getattr(obj, field + "_lo")), device)

        return PartitionedBandedDD(
            planes=f64("planes"), edge_left=f64("edge_left"),
            edge_right=f64("edge_right"),
            offsets=tuple(int(o) for o in obj.offsets),
            R_local=int(obj.R_local), n_devices=int(obj.n_devices),
            b=int(obj.b), wb=int(obj.wb), tile_rows=int(obj.tile_rows),
            shape=tuple(int(n) for n in obj.shape),
            logical_nnz=int(obj.logical_nnz))
    if name == "DistributedBSR":
        if mesh is None:
            raise ValueError("from_jax: a DistributedBSR needs the port's "
                             "mesh (mesh=chain_mesh(...))")
        return DistributedBSR(mesh, from_jax(obj.pbsr, device))
    if name == "ShardedSiteSum":
        return ShardedSiteSum(
            device_mats=_tensor(obj.device_mats, device),
            local=from_jax(obj.local, device), p=int(obj.p), L=int(obj.L),
            device_active=tuple(bool(a) for a in obj.device_active))
    if name == "DiagonalOperator":
        return DiagonalOperator(_tensor(obj.diag, device))
    if name == "SiteOperatorSum":
        return SiteOperatorSum(_tensor(obj.site_mats, device), L=int(obj.L),
                               active=tuple(obj.active),
                               group_bits=int(obj.group_bits))
    if name == "GroupedSiteSum":
        return GroupedSiteSum(
            group_mats=tuple(_tensor(A, device) for A in obj.group_mats),
            dims=tuple(int(d) for d in obj.dims),
        )
    if name == "Generator":
        return Generator([from_jax(op, device, mesh=mesh) for op in obj.ops],
                         list(obj.amplitudes))
    if name == "Operator":
        return Operator([from_jax(op, device, mesh=mesh) for op in obj.ops],
                        np.array(host_np(obj.coeffs)))
    if name == "ScaledOperator":
        return ScaledOperator(obj.coeff,
                              from_jax(obj.operator, device, mesh=mesh))
    if isinstance(obj, torch.Tensor):
        return obj.to(resolve_device(device))
    if isinstance(obj, (int, float, complex, np.number)) or callable(obj):
        return obj
    if hasattr(obj, "__array__"):
        return _tensor(obj, device)
    raise TypeError(f"from_jax: no counterpart for {type(obj)}")


def to_numpy(obj):
    """Host numpy copy of a tensor (any device), recursively through
    tuples and lists; other objects pass through."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy(o) for o in obj)
    return obj
