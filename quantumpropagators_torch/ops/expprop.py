"""Dense matrix-exponential propagation (PyTorch port of
:mod:`quantumpropagators.ops.expprop`; reference ``src/expprop.jl``).

Forms ``U = f(H·dt)`` by a dense matrix function and applies it: the
cross-check oracle for the polynomial methods and a practical
propagator for small systems.  The exponential is :func:`expm`, the
scaling-and-squaring Padé algorithm of ``jax.scipy.linalg.expm`` (Higham
2005): ``torch.linalg.matrix_exp`` loses up to 2e-11 at some norms in
complex128 (a 2 × 2 step of 1-norm 0.03).  :func:`expm` makes its
choices on the matrix's device, as the JAX function does: it reads
nothing from the host, so a CUDA graph captures it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .operators import apply, to_dense

__all__ = ["expm", "expprop_matrix", "expprop_apply"]

# Padé numerator coefficients b_0 .. b_m (Higham 2005, table 2.3)
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
# jax.scipy.linalg.expm's choices (jax/_src/scipy/linalg.py:_calc_P_Q) by
# precision: the degrees, the 1-norms that bound each degree but the
# last, and the 1-norm that a scaled matrix stays under
_DEGREES = {
    True: ((3, 5, 7, 9, 13), (1.495585217958292e-2, 2.539398330063230e-1,
                              9.504178996162932e-1, 2.097847961257068e0),
           5.371920351148152),
    False: ((3, 5, 7), (4.258730016922831e-1, 1.880152677804762e0),
            3.925724783138660),
}
MAX_SQUARINGS = 16  # jax.scipy.linalg.expm's max_squarings


def _row(m):
    """Degree ``m``'s Padé pair in one form for every degree,
    ``U = A·(A6·(u13·A6 + u11·A4 + u9·A2) + c9·A8 + c7·A6 + c5·A4 + c3·A2
    + c1·I)`` and ``V = A6·(v12·A6 + v10·A4 + v8·A2) + d8·A8 + d6·A6 +
    d4·A4 + d2·A2 + d0·I``: the coefficients
    ``(u13, u11, u9, c9, c7, c5, c3, c1, v12, v10, v8, d8, d6, d4, d2,
    d0)``, zero where degree ``m`` has no such term.  Each sum adds its
    terms in the JAX function's order (a zero term first adds nothing)."""
    b = _PADE[m]
    if m == 13:
        return (b[13], b[11], b[9], 0.0, b[7], b[5], b[3], b[1],
                b[12], b[10], b[8], 0.0, b[6], b[4], b[2], b[0])
    odd = [b[k] if k <= m else 0.0 for k in (9, 7, 5, 3, 1)]
    even = [b[k] if k < m else 0.0 for k in (8, 6, 4, 2, 0)]
    return (0.0, 0.0, 0.0, *odd, 0.0, 0.0, 0.0, *even)


_TABLES: dict = {}


def _tables(device, double: bool):
    """The degree bounds and the rows of :func:`_row` on ``device``, made
    once (an eager call makes them before a capture reads them: a copy
    from the host cannot be captured)."""
    key = (torch.device(device), double)
    if key not in _TABLES:
        degrees, bounds, _ = _DEGREES[double]
        _TABLES[key] = (
            torch.tensor(bounds, dtype=torch.float64, device=device),
            torch.tensor([_row(m) for m in degrees], dtype=torch.float64,
                         device=device))
    return _TABLES[key]


def expm(A: torch.Tensor) -> torch.Tensor:
    """The matrix exponential of a square ``A`` by scaling and squaring,
    as ``jax.scipy.linalg.expm`` computes it: the 1-norm picks the Padé
    degree (3, 5, 7, 9 or 13 in double precision; 3, 5 or 7 in single)
    and the number of squarings ``s = max(0, floor(log2(‖A‖₁ / θ)))``;
    more than 16 squarings give NaN.

    Every choice is made on ``A``'s device: the degree selects a row of
    coefficients of one form that covers them all (:func:`_row`), and
    the 16 squarings are each kept or not by a mask, so the call reads
    nothing from the host and a CUDA graph captures it.  The solve does
    not check for singularity on the host (``solve_ex``)."""
    n = A.shape[-1]
    double = A.dtype in (torch.float64, torch.complex128)
    bounds, table = _tables(A.device, double)
    theta = _DEGREES[double][2]
    norm = torch.linalg.matrix_norm(A, ord=1)
    s = torch.clamp(torch.floor(torch.log2(norm / theta)), min=0.0)
    # jnp.digitize; index_select, as a 0-d index tensor would be read
    row = table.index_select(0, (bounds <= norm).sum().reshape(1))[0]
    A = A / torch.exp2(s)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A4 @ A2
    if double:
        A8 = A6 @ A2
        W = A6 @ (row[0] * A6 + row[1] * A4 + row[2] * A2) + row[3] * A8
        Z = A6 @ (row[8] * A6 + row[9] * A4 + row[10] * A2) + row[11] * A8
    else:
        W = Z = 0.0
    U = A @ (W + row[4] * A6 + row[5] * A4 + row[6] * A2 + row[7] * eye)
    V = Z + row[12] * A6 + row[13] * A4 + row[14] * A2 + row[15] * eye
    R = torch.linalg.solve_ex(V - U, U + V, check_errors=False)[0]
    squarings = torch.arange(MAX_SQUARINGS, device=A.device) < s
    for i in range(MAX_SQUARINGS):
        R = torch.where(squarings[i], R @ R, R)
    return R.masked_fill(s > MAX_SQUARINGS, float("nan"))


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
