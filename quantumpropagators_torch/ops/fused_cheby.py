"""Fused Chebyshev step on diagonal-plus-site-flip Hamiltonians (the TFIM
family, any lattice dimension): PyTorch port of
:mod:`quantumpropagators.ops.fused_cheby`.

``H = diag(d) + flip_scale·Σⱼ gⱼ·Xⱼ`` with ``Xⱼ`` the flip of index bit
``j``.  Each polynomial order of the Chebyshev recurrence (reference
``src/cheby.jl:150-213``) is one call of
:func:`~.cheby_flip.cheby_flip_first` / :func:`~.cheby_flip.cheby_flip_iter`
— on the card a high pass over the top index bits and a tiled pass over
the rest — whose device-memory traffic is: read v₀, v₁, Φ, dmb; write
v₂, Φ; plus the high pass's scratch vector.  This module keeps the JAX
package's planning and structure detection; the TPU's three-way split
of the flips (lane matmul, row rolls, cross-tile matmul) has no
counterpart, every flip is an index XOR.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .cheby_flip import cheby_flip_first, cheby_flip_iter

__all__ = [
    "FlipPlan",
    "make_flip_plan",
    "cheby_step_fused",
    "flip_structure",
    "flip_structure_multi",
    "flip_cheby_step",
    "plan_coeffs",
]

_LANE_BITS = 7


def _flip_adjacency(bits: np.ndarray, gs: np.ndarray) -> np.ndarray:
    """Σⱼ gⱼ·(flip of local bit j) adjacency over ``len(bits)`` bits."""
    n = 1 << len(bits)
    A = np.zeros((n, n), dtype=np.float64)
    for j, g in enumerate(gs):
        idx = np.arange(n)
        A[idx ^ (1 << j), idx] += g
    return A


@dataclass(frozen=True)
class FlipPlan:
    """Static plan for one ``(L, g)`` flip-Hamiltonian.  The tiling
    fields are kept from the JAX package's TPU plan for API parity; the
    CUDA kernels use only ``L`` and ``gs``."""

    L: int
    tile_rows: int
    n_row_bits: int
    n_cross: int
    gs: tuple               # per-bit flip coefficient, length L
    # plan_coeffs's device vectors, owned by the plan: a captured step
    # reads them for as long as its graph (which holds the plan) lives
    device_gs: dict = field(default_factory=dict, init=False, repr=False,
                            compare=False)

    @property
    def lane_mat(self) -> np.ndarray:
        """(128, 128) Σ_{j<7} g_j flip_j adjacency."""
        return _flip_adjacency(
            np.arange(_LANE_BITS), np.asarray(self.gs[:_LANE_BITS])
        )

    @property
    def cross_mat(self) -> np.ndarray | None:
        """(T, T) top-bit adjacency, T = 2^n_cross."""
        if not self.n_cross:
            return None
        return _flip_adjacency(
            np.arange(self.n_cross), np.asarray(self.gs[-self.n_cross:])
        )

    @property
    def row_gs(self) -> tuple:
        return self.gs[_LANE_BITS:_LANE_BITS + self.n_row_bits]


def make_flip_plan(L: int, g, tile_rows: int = 512) -> FlipPlan:
    """Plan for ``H_x = Σ_j g_j X_j`` on ``2^L`` states.

    ``g`` is a scalar (uniform transverse field) or a length-``L``
    per-bit vector; bit ``j`` is flipped by ``X_j``.
    """
    if L < _LANE_BITS + 3:
        raise ValueError(f"fused kernel needs L >= {_LANE_BITS + 3}, got {L}")
    gs = np.broadcast_to(np.asarray(g, dtype=np.float64), (L,))
    rows = 1 << (L - _LANE_BITS)
    tile_rows = min(tile_rows, rows)
    n_row_bits = int(np.log2(tile_rows))
    if (1 << n_row_bits) != tile_rows:
        raise ValueError("tile_rows must be a power of two")
    n_cross = L - _LANE_BITS - n_row_bits
    return FlipPlan(
        L=L,
        tile_rows=tile_rows,
        n_row_bits=n_row_bits,
        n_cross=n_cross,
        gs=tuple(float(v) for v in gs),
    )


def plan_coeffs(plan: FlipPlan, dtype, device, extra_gs=()) -> torch.Tensor:
    """``plan.gs`` followed by ``extra_gs`` as a ``dtype`` tensor on
    ``device``, made once (a host-to-device copy), kept by the plan and
    shared by every later step; callers must not write to it.  A step
    that reads it after its first call reads nothing from the host."""
    extra_gs = tuple(float(g) for g in extra_gs)
    key = (extra_gs, dtype, torch.device(device))
    if key not in plan.device_gs:
        plan.device_gs[key] = torch.as_tensor(plan.gs + extra_gs,
                                              dtype=dtype, device=device)
    return plan.device_gs[key]


def _xtype_site_gs(op) -> "np.ndarray | None":
    """Per-BIT flip coefficients of an X-type SiteOperatorSum, or None
    if the term is not pure-real site-flip structure."""
    mats = op.site_mats.detach().cpu().numpy()
    if np.iscomplexobj(mats) and np.abs(mats.imag).max() > 0:
        return None
    mats = mats.real
    L = op.L
    active = op.active if op.active else (True,) * L
    gs_site = np.zeros(L, dtype=np.float64)
    for i in range(L):
        if not active[i]:
            continue
        M = mats[i]
        if M[0, 0] != 0 or M[1, 1] != 0 or M[0, 1] != M[1, 0]:
            return None
        gs_site[i] = M[0, 1]
    return gs_site[::-1].copy()  # site i (MSB-first) = bit L-1-i


def _real_diag(op):
    """The diagonal of a DiagonalOperator as a real tensor, or None if
    it has an imaginary part."""
    d = op.diag
    if d.is_complex():
        if bool((d.imag != 0).any()):
            return None
        d = d.real
    return d


def flip_structure(ops, tile_rows: int = 512):
    """Detect the diagonal-plus-site-flip structure the fused kernel
    accepts: exactly one :class:`~.operators.DiagonalOperator` and one
    X-type :class:`~..models.lattice.SiteOperatorSum` (every per-site
    matrix real ``[[0, a], [a, 0]]``).  Returns
    ``(plan, diag, diag_pos, flip_pos)`` or ``None``.

    Site ``i`` in the MSB-first kron convention maps to index bit
    ``L-1-i`` in the plan.
    """
    from ..models.lattice import SiteOperatorSum
    from .operators import DiagonalOperator

    if len(ops) != 2:
        return None
    diag_pos = flip_pos = None
    for k, op in enumerate(ops):
        if isinstance(op, DiagonalOperator):
            diag_pos = k
        elif isinstance(op, SiteOperatorSum):
            flip_pos = k
    if diag_pos is None or flip_pos is None:
        return None
    gs_bits = _xtype_site_gs(ops[flip_pos])
    if gs_bits is None or ops[flip_pos].L < _LANE_BITS + 3:
        return None
    diag = _real_diag(ops[diag_pos])
    if diag is None:
        return None
    plan = make_flip_plan(ops[flip_pos].L, gs_bits, tile_rows=tile_rows)
    return plan, diag, diag_pos, flip_pos


def flip_structure_multi(ops):
    """Multi-amplitude generalization of :func:`flip_structure` — the
    reference's ``Ĥ₀ + Σₗ aₗ(t)Ĥₗ`` with any number of diagonal terms
    and any number of independently driven site-flip groups (groups may
    overlap — a bit's coefficient is the coefficient-weighted sum).

    Returns ``(L, diag_terms, flip_terms)`` with
    ``diag_terms = [(pos, diag float64 tensor)]`` and
    ``flip_terms = [(pos, gs_bits float64 numpy (L,))]`` (``pos``
    indexes ``ops``), or ``None`` if any term does not fit.
    """
    from ..models.lattice import SiteOperatorSum
    from .operators import DiagonalOperator

    diag_terms, flip_terms = [], []
    L = None
    for k, op in enumerate(ops):
        if isinstance(op, DiagonalOperator):
            d = _real_diag(op)
            if d is None:
                return None
            diag_terms.append((k, d.to(torch.float64)))
        elif isinstance(op, SiteOperatorSum):
            gs_bits = _xtype_site_gs(op)
            if gs_bits is None:
                return None
            if L is None:
                L = op.L
            elif op.L != L:
                return None
            flip_terms.append((k, gs_bits))
        else:
            return None
    if not flip_terms or L < _LANE_BITS + 3:
        return None
    return L, diag_terms, flip_terms


def flip_cheby_step(psi, dmb, G, coeffs, delta, e_min, dt, *,
                    forward: bool = True, partners_fn=None, out=None):
    """One Chebyshev step ``exp(-i H dt)·psi`` for
    ``H − β = diag(dmb) + Σ_j G_j X_j`` on a flat ``2^L`` complex state
    or a ``(slots, 2^L)`` stack of them, one :mod:`.cheby_flip` call per
    polynomial order.  ``psi`` is not modified.  ``out`` (optional, shaped
    like ``psi``) receives the new state, which is then returned.

    ``partners_fn(v) -> [(stack, slot_xor), ...]`` (optional) gives, at
    every order, the flips of bits held outside the state as
    :mod:`.cheby_flip` partners, summed inside the kernels' high pass;
    ``G`` then holds ``L`` local coefficients and one per partner.
    ``coeffs``: a host array (kernel arguments) or a tensor (read on the
    device: a replayed graph takes new coefficients).
    """
    if isinstance(coeffs, torch.Tensor):
        # data on the device: 0-d rows the kernels read there
        c = coeffs.to(device=psi.device, dtype=dmb.dtype)
        a = [c[k] for k in range(c.shape[0])]
    else:
        a = [float(x) for x in np.asarray(coeffs, dtype=np.float64)]
    beta = float(delta) / 2.0 + float(e_min)
    s = (-1.0 if forward else 1.0) * 2.0 / float(delta)

    def partners(v):
        return () if partners_fn is None else partners_fn(v)

    v0 = psi
    v1, phi = cheby_flip_first(v0, dmb, G, s, a[0], a[1],
                               partners=partners(v0))
    for k, ak in enumerate(a[2:]):
        # order 2 writes a fresh buffer (psi stays intact); later orders
        # overwrite v0 in place
        v2 = cheby_flip_iter(v0, v1, phi, dmb, G, 2.0 * s, ak,
                             out=torch.empty_like(v1) if k == 0 else None,
                             partners=partners(v1))
        v0, v1 = v1, v2
    return torch.mul(phi, complex(np.exp(-1j * beta * float(dt))), out=out)


def cheby_step_fused(
    plan: FlipPlan,
    diag,
    re,
    im,
    coeffs,
    delta,
    e_min,
    dt,
    *,
    flip_scale=None,
    forward: bool = True,
    extra_w_fn=None,
):
    """One Chebyshev step ``exp(-i H dt)`` with
    ``H = diag + flip_scale·Σ g_j X_j`` on the planar state ``(re, im)``
    (the JAX package's public face); returns the new ``(re, im)``.

    ``re``/``im``/``diag`` hold one ``2^plan.L`` state or a stack of
    them (shard slots).  ``flip_scale`` is a scalar (float or 0-d
    tensor) or ``None`` (1); ``extra_w_fn(vr, vi) -> (wr, wi)``, called
    with ``re``'s shape, injects an additional contribution to ``H·v``
    computed outside the kernel, scaled by ``flip_scale`` like the
    flips.
    """
    shape = re.shape
    # one row per state: several rows are the shard slots of one process
    psi = torch.complex(re, im).reshape(-1, 1 << plan.L)
    rdtype = re.dtype
    scale = 1.0 if flip_scale is None else flip_scale
    beta = float(delta) / 2.0 + float(e_min)
    dmb = (diag.reshape(psi.shape).to(rdtype) - beta).contiguous()
    partners_fn = None
    if extra_w_fn is None:
        G = plan_coeffs(plan, rdtype, re.device) * scale
    else:
        # the hook's plane enters as one partner weighted by the scale
        G = plan_coeffs(plan, rdtype, re.device, (1.0,)) * scale

        def partners_fn(v):
            wr, wi = extra_w_fn(v.real.reshape(shape), v.imag.reshape(shape))
            return [(torch.complex(wr.to(rdtype), wi.to(rdtype)
                                   ).reshape(v.shape), 0)]
    out = flip_cheby_step(psi, dmb, G, coeffs, delta, e_min, dt,
                          forward=forward, partners_fn=partners_fn)
    return out.real.reshape(shape), out.imag.reshape(shape)
