"""Planar ``(re, im)`` real-plane Chebyshev path (PyTorch port of
:mod:`quantumpropagators.ops.planar`).

The state is kept as a pair of real planes ``(re, im)`` through the
whole recurrence.  For a *real-linear* operator (real diagonal, real
site groups, real sparse or dense matrices, real-coefficient sums)
``H v`` acts on each plane independently; the recurrence scalar
``c = ∓2i/Δ`` is purely imaginary, so ``c·u`` is a swap of the two
planes with one real scale, ``(re, im) ← (∓s·u_im, ±s·u_re)``; the
coefficients ``a_k`` are real.  The one complex operation is the final
global phase ``exp(-iβdt)``, applied once (reference
``src/cheby.jl:150-213`` for the algorithm).

:func:`apply_planar` is the planar form of the ``apply`` protocol.
Operators that are not real-linear go through the complex ``apply``
with a round trip through one complex state: that is what the function
means for such an operator, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .operators import (
    CSROperator,
    DIAOperator,
    DiagonalOperator,
    _is_dense,
    apply,
    as_tensor,
    host_np,
)

__all__ = ["apply_planar", "cheby_apply_planar", "is_real_linear"]


def _kind(x) -> str:
    """The numpy dtype kind of a tensor, array or scalar ("f" real
    floating, "c" complex, "i"/"u" integer, "b" bool)."""
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            return "c"
        if x.is_floating_point():
            return "f"
        return "b" if x.dtype == torch.bool else "i"
    return np.asarray(x).dtype.kind


def _is_real(x) -> bool:
    return _kind(x) == "f"


def is_real_linear(op) -> bool:
    """True if ``op`` maps real states to real states (so it acts on the
    re/im planes independently)."""
    from ..models.generators import Operator, ScaledOperator
    from ..models.lattice import GroupedSiteSum, SiteOperatorSum

    if _is_dense(op):
        return _is_real(op)
    if isinstance(op, DiagonalOperator):
        return _is_real(op.diag)
    if isinstance(op, (CSROperator, DIAOperator)):
        return _is_real(op.data)
    if isinstance(op, GroupedSiteSum):
        return all(_is_real(A) for A in op.group_mats)
    if isinstance(op, SiteOperatorSum):
        return _is_real(op.site_mats)
    if isinstance(op, ScaledOperator):
        return _kind(op.coeff) in "if" and is_real_linear(op.operator)
    if isinstance(op, Operator):
        return _kind(op.coeffs) in "if" and all(
            is_real_linear(o) for o in op.ops)
    return False


def apply_planar(op, re, im):
    """``(re', im') = op @ (re + i·im)`` for real-linear ``op``, applied
    per plane with no complex intermediates.

    Operators that are not real-linear are applied through the complex
    ``apply`` protocol (forming ``re + i·im`` and splitting the result).
    """
    from ..models.generators import Operator, ScaledOperator, _scalar
    from ..models.lattice import GroupedSiteSum, SiteOperatorSum

    if _is_dense(op) and _is_real(op):
        A = as_tensor(op, device=re.device)
        A = A.to(torch.promote_types(A.dtype, re.dtype))
        return re.to(A.dtype) @ A.T, im.to(A.dtype) @ A.T
    if isinstance(op, DiagonalOperator) and _is_real(op.diag):
        return op.diag * re, op.diag * im
    if isinstance(op, GroupedSiteSum) and all(
        _is_real(A) for A in op.group_mats
    ):
        return _grouped_planar(op, re), _grouped_planar(op, im)
    if isinstance(op, SiteOperatorSum) and _is_real(op.site_mats):
        return op.apply(re), op.apply(im)
    if isinstance(op, (CSROperator, DIAOperator)) and _is_real(op.data):
        return op.apply(re), op.apply(im)
    if isinstance(op, ScaledOperator) and is_real_linear(op):
        r, i = apply_planar(op.operator, re, im)
        c = _scalar(op.coeff)
        return c * r, c * i
    if isinstance(op, Operator) and is_real_linear(op):
        off = op.drift_offset
        out_r = out_i = None
        for k, term_op in enumerate(op.ops):
            tr, ti = apply_planar(term_op, re, im)
            if k >= off:
                c = _scalar(op.coeffs[k - off])
                tr, ti = c * tr, c * ti
            out_r = tr if out_r is None else out_r + tr
            out_i = ti if out_i is None else out_i + ti
        return out_r, out_i
    out = apply(op, torch.complex(re, im))
    return out.real, out.imag


def _grouped_planar(op, plane):
    """One real plane through a :class:`GroupedSiteSum` (one matmul per
    site group)."""
    N = int(np.prod(op.dims))
    lead = plane.shape[:-1]
    out = None
    pre = 1
    for g, A in enumerate(op.group_mats):
        F = op.dims[g]
        post = N // (pre * F)
        resh = plane.reshape(lead + (pre, F, post))
        term = torch.einsum("ab,...xbz->...xaz", A.to(plane.dtype), resh)
        term = term.reshape(lead + (N,))
        out = term if out is None else out + term
        pre *= F
    if out is None:
        out = torch.zeros_like(plane)
    return out


def cheby_apply_planar(
    op,
    re,
    im,
    coeffs,
    delta,
    e_min,
    dt,
    *,
    forward: bool = True,
    apply_planar_fn=None,
):
    """Chebyshev step ``exp(-i H dt)`` on the real planes ``(re, im)``.

    Mathematically identical to :func:`.cheby.cheby_apply` (reference
    algorithm ``src/cheby.jl:150-213``) for real-linear ``op``; returns
    the propagated ``(re, im)`` planes.  Every operation of the
    recurrence is real, in the planes' dtype.
    """
    if apply_planar_fn is None:
        apply_planar_fn = apply_planar
    np_real = np.float32 if re.dtype == torch.float32 else np.float64
    # the scalars rounded to the planes' dtype, as the JAX function
    # casts them
    delta = float(delta)
    beta = float(np_real(delta / 2.0 + float(e_min)))
    # c = sign·2i/Δ with sign = -1 forward: c·u = s·(i·u), s = sign·2/Δ,
    # so (c·u)_re = -s·u_im and (c·u)_im = s·u_re
    sign = -1.0 if forward else 1.0
    s = float(np_real(sign * 2.0) / np_real(delta))
    a = host_np(coeffs).astype(np_real).tolist()

    v0r, v0i = re, im
    phi_r = a[0] * v0r
    phi_i = a[0] * v0i
    ur, ui = apply_planar_fn(op, v0r, v0i)
    v1r = -s * (ui - beta * v0i)
    v1i = s * (ur - beta * v0r)
    phi_r = phi_r + a[1] * v1r
    phi_i = phi_i + a[1] * v1i
    s2 = 2.0 * s
    for ak in a[2:]:
        ur, ui = apply_planar_fn(op, v1r, v1i)
        v2r = -s2 * (ui - beta * v1i) + v0r
        v2i = s2 * (ur - beta * v1r) + v0i
        phi_r = phi_r + ak * v2r
        phi_i = phi_i + ak * v2i
        v0r, v0i, v1r, v1i = v1r, v1i, v2r, v2i

    # the final global phase exp(-iβdt): the one complex scalar
    ang = float(np_real(-float(dt)) * np_real(beta))
    pr, pi = math.cos(ang), math.sin(ang)
    return pr * phi_r - pi * phi_i, pr * phi_i + pi * phi_r
