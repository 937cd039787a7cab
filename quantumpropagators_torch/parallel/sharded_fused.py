"""Sharded fused Chebyshev step on diagonal-plus-site-flip Hamiltonians:
PyTorch port of :mod:`quantumpropagators.parallel.sharded_fused`.

The state of ``2^L`` amplitudes is split into ``2^p`` contiguous slots
of a :class:`~.mesh.Mesh`, so the top ``p`` index bits select the slot.
Each slot runs the flip kernels (:mod:`..ops.cheby_flip`) over its low
``L − p`` bits; a flip of a *slot bit* is the partner slot's whole
block, read by the kernels' high pass as a partner row at every
polynomial order: through ``partners_fn`` of
:func:`~..ops.fused_cheby.flip_cheby_step` (f32 tier) and
``extra_nb_fn``/``extra_nb_hi_fn``/``extra_gs`` of
:func:`~..ops.fused_cheby_dd.cheby_step_fused_dd` (reference tier,
complex128).  A slot bit inside this rank is the state's own stack
with ``slot_xor = 2^j`` (no copy); only a bit across ranks is
exchanged, one complex :meth:`~.mesh.Mesh.ppermute` per coupled bit,
its received rows read with ``slot_xor = 0``.  The Chebyshev
recurrence needs no reduction, so a step is exchanges plus kernel
launches, one per slot and pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cheby import cheby_coeffs
from ..ops.fused_cheby import flip_cheby_step, make_flip_plan, plan_coeffs
from ..ops.fused_cheby_dd import (
    cheby_step_fused_dd,
    dd_tile_rows,
    f32_tail_orders,
)
from ..utils.scan import graphed
from .mesh import STATE_AXIS, Mesh, device_bits

__all__ = [
    "make_sharded_fused_cheby_step",
    "make_sharded_fused_cheby_step_dd",
    "sharded_flip_plan",
    "weak_site_permutation",
    "permute_index_bits",
    "invert_bit_order",
]


def sharded_flip_plan(
    L: int, g, n_devices: int, *, tile_rows: int = 512
) -> tuple:
    """Split an ``L``-bit flip plan for a ``2^p``-slot mesh.

    Returns ``(plan_local, device_gs)``: the per-slot
    :class:`~..ops.fused_cheby.FlipPlan` over the low ``L − p`` bits,
    and the flip coefficients of the ``p`` slot-index bits
    (``device_gs[j]`` flips bit ``j`` of the slot index).
    """
    p = device_bits(n_devices)
    gs = np.broadcast_to(np.asarray(g, dtype=np.float64), (L,))
    L_local = L - p
    plan_local = make_flip_plan(L_local, gs[:L_local], tile_rows=tile_rows)
    device_gs = tuple(float(v) for v in gs[L_local:])
    return plan_local, device_gs


def weak_site_permutation(L: int, g, n_devices: int) -> tuple:
    """Slot-bit assignment to weak-coupling sites: choose the
    ``p = log2(n_devices)`` index bits with the SMALLEST |g| as slot
    bits and return the bit permutation that puts them on top.

    Returns ``(bit_order, g_permuted)``: ``bit_order[new]`` is the OLD
    index bit that lands at new position ``new`` (low ``L − p`` =
    slot-local, top ``p`` = slot bits); ``g_permuted`` the per-bit
    couplings in the new order.  Apply :func:`permute_index_bits` to the
    state and any diagonal BEFORE sharding; slot bits with ``g == 0``
    then cost no exchange at all."""
    p = device_bits(n_devices)
    gs = np.broadcast_to(np.asarray(g, dtype=np.float64), (L,))
    order = np.argsort(np.abs(gs), kind="stable")
    weak = sorted(order[:p].tolist())       # slot bits: weakest |g|
    strong = sorted(order[p:].tolist())     # slot-local bits
    bit_order = tuple(strong + weak)
    return bit_order, gs[list(bit_order)]


def permute_index_bits(v, bit_order):
    """Relabel the index bits of a ``(2^L,)`` vector: the new index has
    old bit ``bit_order[k]`` at position ``k``.  One gather over an
    index built bit by bit (no ``(2,)*L`` reshape, so no limit on the
    number of tensor dimensions); done once before (and inverted once
    after) a sharded propagation."""
    v = torch.as_tensor(v).reshape(-1)
    new = torch.arange(v.numel(), device=v.device)
    old = torch.zeros_like(new)
    for k, b in enumerate(bit_order):
        old |= ((new >> k) & 1) << b
    return v[old]


def invert_bit_order(bit_order):
    """The inverse relabeling for :func:`permute_index_bits`."""
    inv = [0] * len(bit_order)
    for new, old in enumerate(bit_order):
        inv[old] = new
    return tuple(inv)


def _flip_perm(mesh: Mesh, j: int):
    """Slot ``i`` receives slot ``i XOR 2^j``."""
    return [(i, i ^ (1 << j)) for i in range(mesh.n_devices)]


def _live_bits(device_gs) -> tuple:
    """The slot bits with nonzero coupling: only they are exchanged."""
    return tuple(j for j, gj in enumerate(device_gs) if gj != 0.0)


def _slot_neighbours(mesh: Mesh, live):
    """``v -> [(stack, slot_xor) for j in live]``, the flip partners of
    the coupled slot bits: ``(v, 2^j)`` for a bit inside this rank (row
    ``s ^ 2^j`` of the state itself), ``(received rows, 0)`` for a bit
    across ranks (one exchange of the complex stack)."""

    def fn(v):
        return [(v, 1 << j) if 1 << j < mesh.n_local
                else (mesh.ppermute(v, _flip_perm(mesh, j)), 0)
                for j in live]

    return fn


def make_sharded_fused_cheby_step(
    mesh: Mesh,
    L: int,
    g,
    *,
    delta: float,
    e_min: float,
    dt: float,
    tile_rows: int = 512,
    forward: bool = True,
    interpret: bool = False,
    axis_name: str = STATE_AXIS,
):
    """Build a sharded fused Chebyshev step in the state's precision.

    Returns ``step(diag, re, im, coeffs[, flip_scale]) -> (re, im)``
    where ``diag``/``re``/``im`` are sharded vectors of the mesh (this
    rank's ``(n_local, 2^(L−p))`` slots, or with one rank the whole
    ``(2^L,)`` vector) and ``coeffs`` the host Chebyshev coefficients;
    the outputs keep ``re``'s shape.  ``flip_scale`` (a Python number or
    a 0-d tensor) scales every flip, slot bits included; slot bits with
    zero coupling skip their exchange.  ``interpret`` and ``axis_name``
    are accepted for parity with the JAX package and ignored.

    On the card each call replays one CUDA graph of the step
    (:func:`~..utils.scan.graphed`: ``diag`` read in place, ``re``,
    ``im`` and ``flip_scale`` copied in, one capture per ``diag`` and
    ``coeffs``); on a mesh whose group spans more than one rank the step
    runs eagerly.
    """
    del interpret, axis_name
    plan_local, device_gs = sharded_flip_plan(
        L, g, mesh.n_devices, tile_rows=tile_rows
    )
    live = _live_bits(device_gs)
    neighbours = _slot_neighbours(mesh, live)
    beta = float(delta) / 2.0 + float(e_min)

    def step(diag, re, im, coeffs, flip_scale=1.0):
        rdtype = re.dtype
        scale = flip_scale.to(rdtype) if isinstance(
            flip_scale, torch.Tensor) else flip_scale
        # the plan's flip coefficients, slot bits last, made once per
        # dtype and device
        G_all = plan_coeffs(plan_local, rdtype, re.device,
                            [device_gs[j] for j in live]) * scale
        psi = mesh.local(torch.complex(re, im))
        dmb = (mesh.local(diag).to(rdtype) - beta).contiguous()
        out = flip_cheby_step(psi, dmb, G_all, coeffs, delta, e_min, dt,
                              forward=forward,
                              partners_fn=neighbours if live else None)
        return out.real.reshape(re.shape), out.imag.reshape(im.shape)

    return graphed(step, mesh=mesh, operators=("diag",),
                   controls=("flip_scale",))


def make_sharded_fused_cheby_step_dd(
    mesh: Mesh,
    L: int,
    g,
    *,
    delta: float,
    e_min: float,
    dt: float,
    tile_rows: int | None = None,
    forward: bool = True,
    interpret: bool = False,
    axis_name: str = STATE_AXIS,
    f32_tail="auto",
    fast="lomxu",
):
    """Build a sharded reference-accuracy fused Chebyshev step
    (complex128; the JAX package's double-float step).

    Returns ``step(dmb, state, coeffs[, flip_scale]) -> state`` where
    ``state`` is a complex128 sharded vector and ``dmb`` the float64
    ``diag − β`` sharded alike (see :func:`make_sharded_fused_cheby_step`
    for the layout), ``coeffs`` the float64 Chebyshev coefficients.
    ``flip_scale`` is ``None``, a scalar, or a per-bit vector of length
    ``L``; the step keeps the slot-local bits and the coupled slot bits
    of it.  Slot bits with zero coupling skip their exchange.

    ``f32_tail``: ``"auto"`` runs the last
    :func:`~..ops.fused_cheby_dd.f32_tail_orders` of
    ``cheby_coeffs(delta, dt)`` in complex64, their slot-bit exchanges
    moving complex64 (half the bytes); an int sets the count.
    ``tile_rows``, ``interpret``, ``axis_name`` and ``fast`` are accepted
    for parity with the JAX package.

    ``step.exchange_plan`` counts the exchange: bytes per local element
    per order, 16 (complex128) per coupled slot bit in the complex128
    orders and 8 (complex64) in the tail orders.

    On the card each call replays one CUDA graph of the step
    (:func:`~..utils.scan.graphed`: ``dmb`` read in place, ``state`` and
    ``flip_scale`` copied in, one capture per ``dmb`` and ``coeffs``);
    on a mesh whose group spans more than one rank the step runs
    eagerly.
    """
    del interpret, axis_name
    p = device_bits(mesh.n_devices)
    L_local = L - p
    plan_local, device_gs = sharded_flip_plan(
        L, g, mesh.n_devices, tile_rows=tile_rows or dd_tile_rows(L_local)
    )
    live = _live_bits(device_gs)
    live_gs = tuple(device_gs[j] for j in live)
    extra_nb = _slot_neighbours(mesh, live)

    if f32_tail == "auto":
        tail = f32_tail_orders(cheby_coeffs(delta, dt))
    else:
        tail = int(f32_tail)

    def step(dmb, state, coeffs, flip_scale=None):
        """``flip_scale``: ``None`` (1), a scalar scaling every flip (one
        time-dependent transverse field), or a per-bit vector of length
        ``L`` (bit ``j`` carries its own control)."""
        if flip_scale is not None and not isinstance(flip_scale,
                                                     (int, float)):
            fs = torch.as_tensor(flip_scale, dtype=torch.float64,
                                 device=state.device)
            if fs.ndim > 0:
                if tuple(fs.shape) != (L,):
                    raise ValueError(
                        f"per-bit flip_scale must have shape ({L},), "
                        f"got {tuple(fs.shape)}"
                    )
                # slices, not a list index: no host-to-device copy
                fs = torch.cat([fs[:L_local]] + [fs[L_local + j:][:1]
                                                 for j in live])
            flip_scale = fs
        out = cheby_step_fused_dd(
            plan_local, mesh.local(dmb), mesh.local(state), coeffs, delta,
            e_min, dt, forward=forward, flip_scale=flip_scale,
            f32_tail=tail, extra_nb_fn=extra_nb, extra_nb_hi_fn=extra_nb,
            extra_gs=live_gs, fast=fast,
        )
        return out.reshape(state.shape)

    step = graphed(step, mesh=mesh, operators=("dmb",),
                   controls=("flip_scale",))
    step.exchange_plan = {
        "device_bits": p,
        "live_device_bits": len(live),
        "skipped_zero_coupling_bits": p - len(live),
        "bytes_per_elem_per_order_dd": 16 * len(live),
        "bytes_per_elem_per_order_tail": 8 * len(live),
        "f32_tail_orders": tail,
    }
    return step
