"""Reference-accuracy fused Chebyshev step: PyTorch port of
:mod:`quantumpropagators.ops.fused_cheby_dd`.

The JAX package emulates float64 on f32-only TPUs with double-float
(hi/lo f32) planes.  The H100 has native FP64, and a complex128 element
is the same 16 bytes as the four dd planes, so this tier is plain
complex128: the state is a complex128 tensor, ``dmb``/``coeffs`` are
float64, and every polynomial order is one call of the ``double``
instance of :mod:`.cheby_flip`.  The names (``cheby_step_fused_dd``,
``f32_tail``, ``fast=``) stay so that the JAX package's callers have a
counterpart.

The mixed-precision tail is kept: the last :func:`f32_tail_orders`
orders run in complex64 (the ``float`` kernel instance) on copies of
``v0``/``v1``, their Φ contribution is accumulated separately and added
in complex128 at the end — the JAX package's
``_tail_component_kernel`` scheme.
"""

from __future__ import annotations

import numpy as np
import torch

from .cheby_flip import cheby_flip_first, cheby_flip_iter
from .fused_cheby import FlipPlan, make_flip_plan, plan_coeffs

__all__ = [
    "cheby_step_fused_dd", "make_flip_plan", "dd_tile_rows",
    "f32_tail_orders",
]

# the JAX package's TPU variants of the dd kernel; all compute the same
# operator and map to the one CUDA kernel here
_VARIANTS = ("lomxu", "twosum", "sigma", "rows", "tlane", "xcross", "mxq")


def f32_tail_orders(coeffs, per_step_budget: float = 3e-14,
                    eps32: float = 3e-7) -> int:
    """Number of TAIL polynomial orders safe to run in pure f32.

    The f32 iteration perturbs ``v_k`` by ~``eps32`` relative per
    order.  A perturbation injected at order ``k`` propagates through
    the three-term recurrence with second-kind-Chebyshev sensitivity —
    it reaches order ``j ≥ k`` with norm up to ``U_{j-k} ≤ j-k+1`` —
    so its Φ weight is ``W(k) = Σ_{j≥k}|a_j|·(j-k+1)``, NOT the plain
    tail sum.  The tail as a whole therefore contributes up to
    ``eps32·(W(k0) + Σ_{k≥k0} W(k))``: one ``W(k0)`` for the one-time
    f32 merge of the carry planes at the entry order ``k0``, plus one
    ``W(k)`` per f32 iteration.  Returns the largest ``m = n - k0``
    such that that bound stays under ``per_step_budget`` — the dd
    kernels handle orders below ``k0``, the f32 tail kernel the rest.
    (The Bessel tail decays superexponentially, so the quadratic
    weights move ``k0`` by at most an order or two vs the plain sum.)
    Mirrors the truncation logic of the reference's coefficient loop
    (``src/cheby.jl:22-48``) one precision tier down."""
    a = np.abs(np.asarray(coeffs, dtype=np.float64))
    n = len(a)
    j = np.arange(n, dtype=np.float64)

    def bound(k0: int) -> float:
        # W(k) = Σ_{j≥k} |a_j|·(j-k+1);  Σ_{k0≤k} W(k) telescopes to
        # Σ_{j≥k0} |a_j|·(j-k0+1)(j-k0+2)/2.  Merge term adds W(k0).
        d = j[k0:] - k0 + 1.0
        aj = a[k0:]
        return float((aj * (d + d * (d + 1.0) / 2.0)).sum())

    k0 = n
    while k0 > 2 and bound(k0 - 1) * eps32 < per_step_budget:
        k0 -= 1
    return n - k0


def dd_tile_rows(L: int, budget_bytes: int = 100 * 2 ** 20) -> int:
    """Tile height of the JAX package's TPU plan, kept for API parity;
    it only feeds :func:`make_flip_plan`.  The CUDA iteration picks its
    own tiles (``ops/cheby_flip.py:flip_split``)."""
    return min(1024, 1 << (L - 7))


def _flip_coeffs(plan: FlipPlan, flip_scale, extra_gs, device):
    """Per-bit float64 flip coefficients ``g_j·flip_scale_j`` for the L
    local bits and the extra (remote) bits.  The ``g_j`` vector is made
    once per plan and device; a tensor ``flip_scale`` on the device and a
    Python number read nothing from the host, so a scan can capture the
    step."""
    base = plan_coeffs(plan, torch.float64, device, extra_gs)
    if flip_scale is None:
        return base
    if isinstance(flip_scale, (int, float)):
        return base * float(flip_scale)
    fs = torch.as_tensor(flip_scale, dtype=torch.float64, device=device)
    if fs.ndim > 0 and tuple(fs.shape) != tuple(base.shape):
        raise ValueError(
            f"per-bit flip_scale must have shape ({base.shape[0]},) = "
            f"(local bits + extra bits), got {tuple(fs.shape)}"
        )
    return base * fs


def _partners(v, fn):
    """``fn(v)``'s planes as :mod:`.cheby_flip` partners: a pair
    ``(stack, slot_xor)`` as it is, a whole plane as ``(plane, 0)``."""
    if fn is None:
        return []
    return [nb if isinstance(nb, tuple) else (nb.reshape(v.shape), 0)
            for nb in fn(v)]


def cheby_step_fused_dd(
    plan: FlipPlan,
    dmb,
    state,
    coeffs,
    delta,
    e_min,
    dt,
    *,
    forward: bool = True,
    flip_scale=None,
    f32_tail: int = 0,
    extra_nb_fn=None,
    extra_nb_hi_fn=None,
    extra_gs: tuple = (),
    fast="lomxu",
    out=None,
):
    """One reference-accuracy Chebyshev step ``exp(-i H dt)·state``,
    ``H = diag + Σ_j g_j·flip_scale_j·X_j``.

    ``state`` is a flat complex128 ``2^L`` tensor or a ``(slots, 2^L)``
    stack of them, the shard slots of one process (not modified);
    ``dmb`` the float64 ``diag − β`` (β = Δ/2 + E_min); ``coeffs`` the
    float64 Chebyshev coefficients.  ``flip_scale`` is ``None``, a
    scalar, or a per-bit vector of length ``L + len(extra_gs)``.

    ``extra_nb_fn(v) -> [v_r, ...]`` (optional) delivers, for each extra
    bit ``r`` held outside this state (e.g. on another device), the
    state with that bit flipped: a tensor in ``v``'s ``(slots, 2^L)``
    shape, or a pair ``(stack, slot_xor)`` whose row ``s ^ slot_xor``
    is slot ``s``'s flip (:mod:`.cheby_flip`'s partners; the sharded
    step hands in ``v`` itself for a slot bit inside this process).  It
    enters with coefficient ``extra_gs[r]·flip_scale[L+r]``, summed
    inside the kernels' high pass.  ``extra_nb_hi_fn`` is its complex64
    companion for the f32 tail; without it the tail is disabled so that
    accuracy never silently degrades.

    ``f32_tail`` runs the last orders in complex64 (see
    :func:`f32_tail_orders`), capped at ``len(coeffs) − 3``.  ``fast``
    accepts the JAX package's variant names; all map to the one kernel.
    ``out`` (optional, shaped like ``state``) receives the new state,
    which is then returned.
    """
    if fast not in (True, False, None) and fast not in _VARIANTS:
        raise ValueError(f"unknown dd variant fast={fast!r}")
    c64 = np.asarray(coeffs, dtype=np.float64)
    n_orders = len(c64)
    f32_tail = int(f32_tail)
    if extra_nb_fn is not None and extra_nb_hi_fn is None:
        f32_tail = 0
    f32_tail = max(0, min(f32_tail, n_orders - 3))

    device = state.device
    # the L local bits' coefficients, then the extra bits': the kernels
    # read a partner's weight from G_all, so a captured step reads the
    # flip scale of each replay
    G_all = _flip_coeffs(plan, flip_scale, extra_gs, device)
    beta = float(delta) / 2.0 + float(e_min)
    s = (-1.0 if forward else 1.0) * 2.0 / float(delta)
    v0 = state.reshape(-1, 1 << plan.L)
    dmb = dmb.reshape(v0.shape).to(torch.float64).contiguous()

    def coeffs_for(partners, G):
        """``G``'s local bits and one entry per partner."""
        if len(partners) > len(G) - plan.L:
            raise ValueError(f"{len(partners)} extra planes for "
                             f"{len(G) - plan.L} extra bits")
        return G[: plan.L + len(partners)]

    k_dd_end = n_orders - f32_tail  # complex128 handles orders [0, k_dd_end)
    parts = _partners(v0, extra_nb_fn)
    v1, phi = cheby_flip_first(v0, dmb, coeffs_for(parts, G_all), s, c64[0],
                               c64[1], partners=parts)
    for k in range(2, k_dd_end):
        parts = _partners(v1, extra_nb_fn)
        v2 = cheby_flip_iter(v0, v1, phi, dmb, coeffs_for(parts, G_all),
                             2.0 * s, c64[k], partners=parts,
                             out=torch.empty_like(v1) if k == 2 else None)
        v0, v1 = v1, v2

    if f32_tail:
        t0 = v0.to(torch.complex64)
        t1 = v1.to(torch.complex64)
        pht = torch.zeros_like(t0)
        dmb32 = dmb.to(torch.float32)
        G32 = G_all.to(torch.float32)
        for k in range(k_dd_end, n_orders):
            parts = _partners(t1, extra_nb_hi_fn)
            t2 = cheby_flip_iter(t0, t1, pht, dmb32, coeffs_for(parts, G32),
                                 2.0 * s, c64[k], partners=parts)
            t0, t1 = t1, t2
        phi = phi + pht.to(torch.complex128)

    phase = complex(np.exp(-1j * beta * float(dt)))
    if out is None:
        return torch.mul(phi, phase).reshape(state.shape)
    torch.mul(phi, phase, out=out.view(phi.shape))
    return out
