"""Chebyshev polynomial propagation kernel (PyTorch port of
:mod:`quantumpropagators.ops.cheby`).

Evaluates ``Ψ ← exp(-i H dt) Ψ`` by a Chebyshev expansion of the
normalized Hamiltonian (reference ``src/cheby.jl``): coefficients
``a_k = (2 - δ_k0) · J_k(Δ·dt/2)`` truncated below ``limit``, the
three-vector recurrence ``v₂ = c (H v₁ − β v₁) + v₀`` with
``β = Δ/2 + E_min`` and ``c = ∓2i/Δ``, and a final global phase
``exp(-i β dt)``.  The recurrence is a plain Python loop over ``apply``
calls that never reads the host: ``Δ``, ``E_min``, ``dt`` and the
normalization check are 0-d tensors on the state's device, so one call
is captured whole as a CUDA graph (the JAX package jits it with those
values traced; ``propagators/cheby.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from scipy.special import jv as _besselj

from .operators import apply, device_scalar, vdot

__all__ = ["cheby_coeffs", "n_cheby_coeffs", "ChebyWorkspace", "cheby_apply"]


def cheby_coeffs(delta: float, dt: float, limit: float = 1e-12) -> np.ndarray:
    """Chebyshev coefficients for ``exp(-i H dt)`` with spectral radius
    ``delta``.

    Returns ``[J₀(α), 2J₁(α), 2J₂(α), ...]`` with ``α = |Δ·dt/2|``,
    including the first coefficient whose magnitude drops to ``limit``
    or below (reference ``src/cheby.jl:25-39``).
    """
    alpha = abs(0.5 * float(delta) * float(dt))
    chunk = max(64, int(alpha + 1.5 * max(1.0, np.log10(1.0 / max(limit, 1e-300))) * 40))
    coeffs = [float(_besselj(0, alpha))]
    eps = abs(coeffs[0])
    n = 1
    while eps > limit:
        ks = np.arange(n, n + chunk)
        vals = 2.0 * _besselj(ks, alpha)
        below = np.nonzero(np.abs(vals) <= limit)[0]
        if below.size:
            stop = int(below[0]) + 1
            coeffs.extend(vals[:stop].tolist())
            eps = abs(vals[stop - 1])
            n += stop
            break
        coeffs.extend(vals.tolist())
        eps = abs(vals[-1])
        n += chunk
    return np.asarray(coeffs, dtype=np.float64)


def n_cheby_coeffs(delta: float, dt: float, limit: float = 1e-12) -> int:
    return len(cheby_coeffs(delta, dt, limit))


@dataclass(frozen=True)
class ChebyWorkspace:
    """Static per-``(Δ, E_min, dt)`` data for Chebyshev propagation
    (the analogue of the reference's ``ChebyWrk``,
    ``src/cheby.jl:87-124``).  ``coeffs`` is a host float64 array;
    ``pad_to`` rounds the coefficient count up with zeros, so that the
    matvec count per step matches the JAX package's."""

    coeffs: Any  # (n_coeffs,) numpy array (possibly zero-padded)
    n_coeffs: int
    delta: float
    e_min: float
    dt: float
    limit: float = 1e-12

    @classmethod
    def create(
        cls,
        delta: float,
        e_min: float,
        dt: float,
        *,
        limit: float = 1e-12,
        pad_to: int = 1,
        dtype=None,
    ) -> "ChebyWorkspace":
        a = cheby_coeffs(delta, dt, limit)
        n = len(a)
        if pad_to > 1:
            padded = ((n + pad_to - 1) // pad_to) * pad_to
            a = np.pad(a, (0, padded - n))
        if dtype is not None:
            a = a.astype(dtype)
        return cls(
            coeffs=a,
            n_coeffs=n,
            delta=float(delta),
            e_min=float(e_min),
            dt=float(dt),
            limit=float(limit),
        )


def cheby_apply(
    op,
    psi,
    coeffs,
    delta,
    e_min,
    dt,
    *,
    forward: bool = True,
    check_normalization: bool = False,
    apply_fn=None,
    out=None,
):
    """Evaluate ``exp(-i H dt) |psi⟩`` via the Chebyshev recurrence.

    ``op`` is any operator implementing the ``apply`` protocol,
    ``coeffs`` the coefficient array: a host array (each order multiplies
    by a Python number) or a tensor (each order multiplies by its 0-d
    row, so coefficients on the card are never read back).
    ``delta``/``e_min``/``dt`` are numbers or 0-d tensors (as JAX traces
    them); either way they become 0-d float64 tensors on ``psi``'s
    device, so both give the same bits.  ``dt`` is the *signed* time
    step and ``forward`` must match its sign (it selects ``c = ∓2i/Δ``,
    reference ``src/cheby.jl:158-162``).

    With ``check_normalization=True``, additionally returns the maximum
    over the recurrence of ``|⟨v₁, H_norm v₁⟩| / ‖v₁‖²`` (reference
    ``src/cheby.jl:194-200``) as a 0-d tensor on the device, kept with
    ``torch.maximum`` as the JAX scan keeps it.  ``out`` (optional,
    ``psi``'s shape in the complex dtype) receives the result, which is
    then returned.
    """
    if apply_fn is None:
        apply_fn = apply
    cdtype = torch.promote_types(psi.dtype, torch.complex64)
    psi = psi.to(cdtype)
    delta = device_scalar(delta, psi.device)
    beta = delta / 2.0 + device_scalar(e_min, psi.device)
    s = (-2.0 if forward else 2.0) / delta
    c = torch.complex(torch.zeros_like(s), s)
    a = coeffs if isinstance(coeffs, torch.Tensor) \
        else np.asarray(coeffs).tolist()

    v0 = psi
    phi = a[0] * v0
    v1 = c * (apply_fn(op, v0) - beta * v0)
    phi = phi + a[1] * v1
    c2 = 2.0 * c
    max_norm = torch.zeros((), dtype=psi.real.dtype, device=psi.device)
    for ak in a[2:]:
        hv = c2 * (apply_fn(op, v1) - beta * v1)
        if check_normalization:
            map_norm = vdot(v1, hv).abs() / (2.0 * vdot(v1, v1).real)
            max_norm = torch.maximum(max_norm, map_norm)
        v2 = hv + v0
        phi = phi + ak * v2
        v0, v1 = v1, v2

    theta = beta * device_scalar(dt, psi.device)
    phase = torch.polar(torch.ones_like(theta), -theta)
    result = torch.mul(phi, phase, out=out)
    if check_normalization:
        return result, max_norm
    return result
