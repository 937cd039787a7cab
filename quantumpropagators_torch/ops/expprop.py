"""Dense matrix-exponential propagation (PyTorch port of
:mod:`quantumpropagators.ops.expprop`; reference ``src/expprop.jl``).

Forms ``U = f(H·dt)`` by a dense matrix function and applies it: the
cross-check oracle for the polynomial methods and a practical
propagator for small systems.  The exponential is :func:`expm`, the
scaling-and-squaring Padé algorithm of ``jax.scipy.linalg.expm`` (Higham
2005): ``torch.linalg.matrix_exp`` loses up to 2e-11 at some norms in
complex128 (a 2 × 2 step of 1-norm 0.03).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .operators import apply, to_dense

__all__ = ["expm", "expprop_matrix", "expprop_apply"]

# Padé numerator coefficients b_0 .. b_m (Higham 2005, table 2.3) and
# the 1-norm up to which each degree reaches double accuracy
_PADE = {
    3: (120.0, 60.0, 12.0, 1.0),
    5: (30240.0, 15120.0, 3360.0, 420.0, 30.0, 1.0),
    7: (17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0, 56.0,
        1.0),
    9: (17643225600.0, 8821612800.0, 2075673600.0, 302702400.0, 30270240.0,
        2162160.0, 110880.0, 3960.0, 90.0, 1.0),
    13: (64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
         1187353796428800.0, 129060195264000.0, 10559470521600.0,
         670442572800.0, 33522128640.0, 1323241920.0, 40840800.0, 960960.0,
         16380.0, 182.0, 1.0),
}
_THETA = ((3, 1.495585217958292e-2), (5, 2.539398330063230e-1),
          (7, 9.504178996162932e-1), (9, 2.097847961257068e0))
_THETA_13 = 5.371920351148152e0


def expm(A: torch.Tensor) -> torch.Tensor:
    """The matrix exponential of a square ``A`` by scaling and squaring
    with a Padé approximant of degree 3, 5, 7, 9 or 13 chosen from the
    1-norm, as ``jax.scipy.linalg.expm`` and ``scipy.linalg.expm``
    compute it."""
    norm = float(torch.linalg.matrix_norm(A, ord=1))
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A2 = A @ A
    for m, theta in _THETA:
        if norm <= theta:
            b = _PADE[m]
            powers = [eye, A2]
            while len(powers) < (m + 1) // 2:
                powers.append(powers[-1] @ A2)
            U = A @ sum(b[2 * k + 1] * P for k, P in enumerate(powers))
            V = sum(b[2 * k] * P for k, P in enumerate(powers))
            return torch.linalg.solve(V - U, V + U)
    s = max(0, math.ceil(math.log2(norm / _THETA_13)))
    A = A / 2.0 ** s
    A2 = A2 / 4.0 ** s
    A4 = A2 @ A2
    A6 = A4 @ A2
    b = _PADE[13]
    U = A @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
             + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye)
    V = (A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
         + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye)
    R = torch.linalg.solve(V - U, V + U)
    for _ in range(s):
        R = R @ R
    return R


def expprop_matrix(op, dt: float, func: Optional[Callable] = None):
    """The dense step matrix ``U = func(H·dt)``.

    The default ``func`` is the Schrödinger time evolution
    ``U = exp(-i H dt)`` (reference ``src/expprop.jl:41-49``,
    :func:`expm`).  A custom ``func`` receives the dense
    tensor ``H·dt`` and returns a matrix."""
    M = to_dense(op) * dt
    if func is None:
        cdtype = torch.promote_types(M.dtype, torch.complex64)
        return expm(-1j * M.to(cdtype))
    return func(M)


def expprop_apply(op, psi, dt: float, func: Optional[Callable] = None, U=None):
    """``psi' = func(H·dt) psi`` (default ``exp(-i H dt) psi``); pass a
    precomputed ``U`` (from :func:`expprop_matrix`) to reuse it."""
    if U is None:
        U = expprop_matrix(op, dt, func)
    return apply(U, psi)
