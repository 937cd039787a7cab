"""The reference-accuracy value types in complex128 (PyTorch port of
:mod:`quantumpropagators.ops.df64`).

The JAX package carries a float64 value as a double-float pair of f32
planes (``DD = (hi, lo)``, ``CDD = (re, im)`` of those) because the TPU
has no float64, and computes on the pairs with error-free
transformations.  The H100 has native FP64, so here a ``DD`` value is a
float64 tensor and a ``CDD`` value a complex128 tensor; the names below
are thin converters that keep the JAX package's callers readable.  The
dd arithmetic helpers (``dd_add``, ``cdd_scale``, ...) have no
counterpart: they are ``+`` and ``*`` on these tensors.

:func:`cheby_apply_dd` is one Chebyshev step over a diagonal-plus-flip
Hamiltonian; it runs :func:`~.fused_cheby.flip_cheby_step` in complex128,
so on the card every order is one ``cheby_flip_first<double>`` /
``cheby_flip_iter<double>`` call.  It is a graphed site, the port of the
JAX ``jax.jit`` of ``_cheby_dd_impl`` (:func:`_cheby_dd_impl`): inside
an :func:`~.arnoldi.arnoldi_sites` scope a call replays the scope's
graph of it, keyed on ``delta``, ``e_min``, ``dt``, ``L``, the flip
coefficients, the direction and the coefficient count, with the
diagonal read in place and the state and Chebyshev coefficients as
data; outside every scope it runs the body.
"""

from __future__ import annotations

import numpy as np
import torch

from .arnoldi import _SCOPE, graphed_call
from .fused_cheby import flip_cheby_step
from .operators import as_tensor, host_np

__all__ = [
    "DD",
    "CDD",
    "dd_from_f64",
    "dd_to_f64",
    "cdd_from_c128",
    "cdd_to_c128",
    "cheby_apply_dd",
]


def DD(hi, lo=None, *, device=None) -> torch.Tensor:
    """A float64 tensor ``hi + lo`` (``lo`` optional): the value a JAX
    ``DD`` pair stands for."""
    x = as_tensor(hi, device=device).to(torch.float64)
    if lo is not None:
        x = x + as_tensor(lo, device=x.device).to(torch.float64)
    return x


def CDD(re, im=None, *, device=None) -> torch.Tensor:
    """A complex128 tensor ``re + i·im`` (``im`` optional)."""
    re = DD(re, device=device)
    im = torch.zeros_like(re) if im is None else DD(im, device=re.device)
    return torch.complex(re, im)


def dd_from_f64(x, *, device=None) -> torch.Tensor:
    """Host or device float64 data as a float64 tensor."""
    return DD(x, device=device)


def dd_to_f64(x) -> np.ndarray:
    return np.asarray(host_np(x), dtype=np.float64)


def cdd_from_c128(z, *, device=None) -> torch.Tensor:
    """Host or device complex data as a complex128 tensor (on
    ``device``, default: a tensor's own device, else the package
    default)."""
    return as_tensor(z, device=device).to(torch.complex128)


def cdd_to_c128(z) -> np.ndarray:
    return np.asarray(host_np(z), dtype=np.complex128)


def _cheby_dd_impl(psi, diag, coeffs, delta, e_min, dt, L, flip_coeffs,
                   forward):
    """The body of :func:`cheby_apply_dd` (the JAX ``_cheby_dd_impl``,
    jitted with ``delta``, ``e_min``, ``dt``, ``L``, ``flip_coeffs`` and
    ``forward`` static).  ``dmb`` and the per-bit flip table are made
    here, from the diagonal and the key's flip coefficients, so that a
    replay makes them at the graph's own addresses."""
    beta = float(delta) / 2.0 + float(e_min)
    dmb = (diag.to(torch.float64).reshape(-1) - beta).contiguous()
    # site k flips index bit L-1-k: the per-bit table is reversed, filled
    # a run of equal entries at a time (no copy from the host)
    G = torch.empty(L, dtype=torch.float64, device=psi.device)
    table = flip_coeffs[::-1]
    start = 0
    for j in range(1, L + 1):
        if j == L or table[j] != table[start]:
            G[start:j].fill_(table[start])
            start = j
    coeffs = torch.as_tensor(coeffs).to(psi.device, torch.float64)
    return flip_cheby_step(psi, dmb, G, coeffs, delta, e_min, dt,
                           forward=forward)


#: the site of :func:`cheby_apply_dd`: the diagonal read in place, the
#: coefficients data, a result of its own (the caller keeps it)
_APPLY = {"operators": ("diag",), "controls": ("coeffs",), "lend": False}


def cheby_apply_dd(psi, diag, flip_coeffs, coeffs, delta: float,
                   e_min: float, dt: float, *, L: int):
    """``exp(-i H dt)|psi⟩`` in complex128 for
    ``H = diag + Σ_k flip_coeffs[k]·X_k`` on ``2^L`` states (site
    ``k = 0`` is the most significant index bit, as in the JAX package).

    ``psi`` is a complex128 state, ``diag`` its float64 diagonal (on the
    state's device; a host diagonal is copied there once a scope),
    ``coeffs`` the host float64 Chebyshev coefficients."""
    psi = cdd_from_c128(psi).reshape(-1).contiguous()
    L = int(L)
    if psi.numel() != 2 ** L:
        raise ValueError(f"state has {psi.numel()} entries, expected 2^{L}")
    flip_coeffs = tuple(float(c) for c in np.asarray(flip_coeffs,
                                                      np.float64))
    if len(flip_coeffs) != L:
        raise ValueError(f"{len(flip_coeffs)} flip coefficients for L = {L}")
    sites = _SCOPE.get()
    diag = sites.copies(diag, psi.device) if sites is not None \
        else DD(diag, device=psi.device)
    return graphed_call(_cheby_dd_impl, _APPLY, None, psi, diag,
                        np.asarray(coeffs, np.float64), float(delta),
                        float(e_min), float(dt), L, flip_coeffs, dt > 0)
