"""Carrying objects between the JAX package and the port.

:func:`from_jax` turns the JAX package's states, dense arrays, operators
and generators into the port's, through numpy; :func:`to_numpy` is the
way back for tensors.  Nothing here imports jax: objects are recognized
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
from .ops.operators import (
    BSROperator,
    CSROperator,
    DiagonalOperator,
    DIAOperator,
    StackedCSROperator,
    host_np,
    resolve_device,
)

__all__ = ["from_jax", "to_numpy"]


def _tensor(x, device):
    return torch.as_tensor(np.array(host_np(x)), device=resolve_device(device))


def _index(x, device):
    return _tensor(x, device).to(torch.int64)


def from_jax(obj, device=None):
    """The port's counterpart of ``obj`` (a JAX array, a numpy array, an
    operator, an :class:`Operator`/:class:`Generator`, or a tuple/list
    of these), with its tensors on ``device`` (default: the package's
    :func:`~.ops.operators.default_device`)."""
    name = type(obj).__name__
    if isinstance(obj, (tuple, list)):
        return type(obj)(from_jax(o, device) for o in obj)
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
            planes = (np.asarray(host_np(obj.planes_hi), np.float64)
                      + np.asarray(host_np(obj.planes_lo), np.float64))
        return BandedDD(planes=_tensor(planes, device),
                        offsets=tuple(int(o) for o in obj.offsets),
                        R=int(obj.R), b=int(obj.b),
                        shape=tuple(int(n) for n in obj.shape),
                        logical_nnz=int(obj.logical_nnz))
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
        return Generator([from_jax(op, device) for op in obj.ops],
                         list(obj.amplitudes))
    if name == "Operator":
        return Operator([from_jax(op, device) for op in obj.ops],
                        np.array(host_np(obj.coeffs)))
    if name == "ScaledOperator":
        return ScaledOperator(obj.coeff, from_jax(obj.operator, device))
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
