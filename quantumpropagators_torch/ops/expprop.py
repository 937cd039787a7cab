"""Dense matrix-exponential propagation (PyTorch port of
:mod:`quantumpropagators.ops.expprop`; reference ``src/expprop.jl``).

Forms ``U = f(H·dt)`` by a dense matrix function and applies it: the
cross-check oracle for the polynomial methods and a practical
propagator for small systems.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .operators import apply, to_dense

__all__ = ["expprop_matrix", "expprop_apply"]


def expprop_matrix(op, dt: float, func: Optional[Callable] = None):
    """The dense step matrix ``U = func(H·dt)``.

    The default ``func`` is the Schrödinger time evolution
    ``U = exp(-i H dt)`` (reference ``src/expprop.jl:41-49``,
    ``torch.linalg.matrix_exp``).  A custom ``func`` receives the dense
    tensor ``H·dt`` and returns a matrix."""
    M = to_dense(op) * dt
    if func is None:
        cdtype = torch.promote_types(M.dtype, torch.complex64)
        return torch.linalg.matrix_exp(-1j * M.to(cdtype))
    return func(M)


def expprop_apply(op, psi, dt: float, func: Optional[Callable] = None, U=None):
    """``psi' = func(H·dt) psi`` (default ``exp(-i H dt) psi``); pass a
    precomputed ``U`` (from :func:`expprop_matrix`) to reuse it."""
    if U is None:
        U = expprop_matrix(op, dt, func)
    return apply(U, psi)
