"""Sharded application of structured chain operators: PyTorch port of
:mod:`quantumpropagators.parallel.sharded_chain`.

The state ``Ψ`` (dim ``2^L``) is split into ``P = 2^p`` contiguous slots
of a :class:`~.mesh.Mesh`, so the top ``p`` bits of the basis index
select the slot:

- *Diagonal* operators act on each slot alone (the diagonal is sliced
  like the state).
- A single-site operator on a low bit (``site ≥ p``) acts within the
  slot.
- A single-site operator on a slot bit (``site < p``) mixes each slot
  with one partner (slot index XOR one bit): one
  :meth:`~.mesh.Mesh.ppermute` and an axpy.

The Chebyshev recurrence needs no reduction, so a sharded step is
exchanges plus local work (:func:`make_sharded_cheby_step`).

:class:`ShardedChainOperator` (built by :func:`shard_chain_operator`)
puts such an operator behind the operator protocol together with its
mesh.  It is the port's counterpart of the JAX package's GSPMD path, in
which a plain ``Operator`` meets a sharded state and XLA inserts the
exchanges and reductions: here the operator carries the mesh, its
``apply`` is :func:`sharded_apply`, and the Krylov methods sum their
inner products over every slot (:func:`~..ops.operators.op_mesh`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import Any

import torch

from ..models.generators import Operator, ScaledOperator, _scalar
from ..models.lattice import GroupedSiteSum, SiteOperatorSum
from ..ops.cheby import cheby_apply
from ..ops.operators import DiagonalOperator, op_shape
from ..utils.scan import graphed
from .mesh import STATE_AXIS, Mesh, device_bits

__all__ = [
    "sharded_apply",
    "make_sharded_cheby_step",
    "operator_shard_spec",
    "ShardedSiteSum",
    "prepare_sharded_operator",
    "ShardedChainOperator",
    "shard_chain_operator",
]


@dataclass(frozen=True)
class ShardedSiteSum:
    """A :class:`SiteOperatorSum` pre-split for a ``2^p``-slot mesh: the
    top ``p`` (slot-index) sites as per-site ``(p, 2, 2)`` matrices
    (applied as pairwise slot exchanges) and the remaining sites as a
    precomputed local :class:`GroupedSiteSum`.  Built host-side by
    :func:`prepare_sharded_operator`."""

    device_mats: Any  # (p, 2, 2)
    local: GroupedSiteSum
    p: int = 0
    L: int = 0
    device_active: tuple = ()

    @property
    def shape(self):
        return (2 ** self.L, 2 ** self.L)


def prepare_sharded_operator(op, n_devices: int, *, group_bits: int = None):
    """Recursively convert :class:`SiteOperatorSum` terms inside ``op``
    into :class:`ShardedSiteSum` for an ``n_devices``-slot mesh (once
    per propagation)."""
    p = device_bits(n_devices)

    def _conv(term):
        if isinstance(term, SiteOperatorSum):
            active = term.active if term.active else (True,) * term.L
            local = SiteOperatorSum(
                term.site_mats[p:],
                L=term.L - p,
                active=tuple(active[p:]),
                group_bits=term.group_bits,
            ).grouped(group_bits)
            return ShardedSiteSum(
                device_mats=term.site_mats[:p],
                local=local,
                p=p,
                L=term.L,
                device_active=tuple(active[:p]),
            )
        if isinstance(term, Operator):
            return Operator([_conv(t) for t in term.ops], term.coeffs)
        if isinstance(term, ScaledOperator):
            return ScaledOperator(term.coeff, _conv(term.operator))
        return term

    return _conv(op)


def sharded_apply(op, psi_local, *, mesh: Mesh, axis_name: str = STATE_AXIS):
    """Apply ``op`` to this rank's slots ``psi_local`` (``(n_local,
    2^(L−p))``) of a sharded state.

    Supported terms: :class:`DiagonalOperator` (its ``diag`` sliced like
    the state, :func:`operator_shard_spec`), :class:`ShardedSiteSum`,
    :class:`SiteOperatorSum` (whole ``(L, 2, 2)`` site matrices), and
    :class:`Operator`/:class:`ScaledOperator` combinations thereof.
    ``axis_name`` is accepted for parity with the JAX package.
    """
    if isinstance(op, DiagonalOperator):
        return op.diag * psi_local  # diag is sliced to the local slots
    if isinstance(op, ShardedSiteSum):
        out = op.local.apply(psi_local)
        return _device_bit_terms(
            op.device_mats, op.device_active, op.p, psi_local, out, mesh
        )
    if isinstance(op, SiteOperatorSum):
        return _sharded_site_sum(op, psi_local, mesh)
    if isinstance(op, ScaledOperator):
        return _scalar(op.coeff) * sharded_apply(op.operator, psi_local,
                                                 mesh=mesh)
    if isinstance(op, Operator):
        off = op.drift_offset
        out = None
        for i, term in enumerate(op.ops):
            y = sharded_apply(term, psi_local, mesh=mesh)
            if i >= off:
                y = _scalar(op.coeffs[i - off]) * y
            out = y if out is None else out + y
        return out
    raise TypeError(
        f"sharded_apply does not support operator type {type(op)}; "
        "use DiagonalOperator / SiteOperatorSum / Operator of those"
    )


def _device_bit_terms(device_mats, device_active, p, psi_local, out,
                      mesh: Mesh):
    """Add the slot-index-bit site terms: one pairwise slot exchange per
    active slot bit."""
    active = device_active if device_active else (True,) * p
    slots = torch.arange(mesh.first_slot, mesh.first_slot + mesh.n_local,
                         device=psi_local.device)
    shape = (mesh.n_local,) + (1,) * (psi_local.dim() - 1)
    for b in range(p):
        if not active[b]:
            continue
        mask = 1 << (p - 1 - b)
        recv = mesh.ppermute(psi_local,
                             [(s, s ^ mask) for s in range(mesh.n_devices)])
        bit0 = (((slots >> (p - 1 - b)) & 1) == 0).reshape(shape)
        M = device_mats[b].to(dtype=psi_local.dtype)
        diag_c = torch.where(bit0, M[0, 0], M[1, 1])
        off_c = torch.where(bit0, M[0, 1], M[1, 0])
        out = out + diag_c * psi_local + off_c * recv
    return out


def _sharded_site_sum(op: SiteOperatorSum, psi_local, mesh: Mesh):
    p = device_bits(mesh.n_devices)
    active = op.active if op.active else (True,) * op.L
    local_op = SiteOperatorSum(
        op.site_mats[p:], L=op.L - p, active=tuple(active[p:])
    )
    out = local_op.apply(psi_local)
    return _device_bit_terms(
        op.site_mats[:p], tuple(active[:p]), p, psi_local, out, mesh
    )


def operator_shard_spec(op, mesh: Mesh):
    """This rank's part of ``op`` as :func:`sharded_apply` takes it:
    whole diagonals sliced to this rank's slots like the state (views,
    no copy), the slot-bit site matrices on the mesh's device (moved
    only when they are elsewhere), everything else shared.  (The JAX
    function returns the ``PartitionSpec`` tree that ``shard_map``
    slices by; here the slicing is done directly.)"""

    def _spec(term):
        if isinstance(term, DiagonalOperator):
            d = term.diag.view(mesh.n_devices, -1)
            return DiagonalOperator(mesh.local_rows(d))
        if isinstance(term, ShardedSiteSum):
            mats = term.device_mats
            if isinstance(mats, torch.Tensor) and mats.device != mesh.device:
                term = replace(term, device_mats=mats.to(mesh.device))
            return term
        if isinstance(term, SiteOperatorSum):
            return term
        if isinstance(term, ScaledOperator):
            return ScaledOperator(term.coeff, _spec(term.operator))
        if isinstance(term, Operator):
            return Operator([_spec(t) for t in term.ops], term.coeffs)
        raise TypeError(f"unsupported sharded operator type {type(term)}")

    return _spec(op)


def make_sharded_cheby_step(
    mesh: Mesh,
    op_example,
    *,
    delta: float,
    e_min: float,
    dt: float,
    forward: bool = True,
):
    """Build a sharded Chebyshev step.

    Returns ``step(op, psi, coeffs) -> psi`` where ``psi`` is a sharded
    vector of the mesh (this rank's slots, or with one rank the whole
    state; the result keeps its shape), ``op`` the whole operator and
    ``coeffs`` a host array or a tensor on the card; every polynomial
    order is one :func:`sharded_apply` with its slot exchanges.
    ``op_example`` is checked for supported terms.

    On the card each call replays one CUDA graph of the step
    (:func:`~..utils.scan.graphed`: ``op``'s tensors read in place,
    ``psi`` and tensor coefficients copied in, one capture per operator
    and host coefficients); on a mesh whose group spans more than one
    rank the step runs eagerly.
    """
    operator_shard_spec(op_example, mesh)
    apply_fn = partial(sharded_apply, mesh=mesh)

    def step(op, psi, coeffs):
        out = cheby_apply(operator_shard_spec(op, mesh), mesh.local(psi),
                          coeffs, delta, e_min, dt, forward=forward,
                          apply_fn=apply_fn)
        return out.reshape(psi.shape)

    return graphed(step, mesh=mesh, operators=("op",))


@dataclass(frozen=True)
class ShardedChainOperator:
    """A chain operator on a shard-slot mesh behind the operator
    protocol: ``shape`` is the global ``(2^L, 2^L)`` and ``apply(psi)``
    takes this rank's ``(n_local, 2^(L−p))`` slots of a sharded state
    (with one rank, any tensor of all ``2^L`` entries) and returns the
    product in the same layout.  ``op`` is the whole prepared operator,
    ``local`` this rank's part of it (:func:`operator_shard_spec`)."""

    mesh: Mesh
    op: Any
    local: Any

    @property
    def shape(self):
        return op_shape(self.op)

    def apply(self, psi):
        return sharded_apply(self.local, self.mesh.local(psi),
                             mesh=self.mesh).reshape(psi.shape)


def shard_chain_operator(op, mesh: Mesh, *, group_bits: int = None):
    """``op`` (:class:`DiagonalOperator` / :class:`SiteOperatorSum` terms
    and their :class:`Operator` / :class:`ScaledOperator` combinations)
    as a :class:`ShardedChainOperator` on ``mesh``: its site sums split
    by :func:`prepare_sharded_operator` (``group_bits`` as there) and its
    diagonals sliced to this rank's slots."""
    prepared = prepare_sharded_operator(op, mesh.n_devices,
                                        group_bits=group_bits)
    return ShardedChainOperator(mesh, prepared,
                                operator_shard_spec(prepared, mesh))
