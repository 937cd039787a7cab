"""Spectral-range estimation (PyTorch port of
:mod:`quantumpropagators.ops.specrange`).

Mirrors reference ``src/specrad.jl``: exact diagonalization for small
systems, Arnoldi/Ritz values otherwise, with the "enlarge" heuristic
that over-estimates the spectral radius using the distance to the
second-extremal Ritz value (``src/specrad.jl:88-112``).  One Arnoldi
run at ``m_max`` provides all leading sub-factorizations.  With an
operator that carries a shard-slot mesh, the Arnoldi run takes a sharded
state (see :mod:`.arnoldi`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .arnoldi import _arnoldi, diagonalize_hessenberg_matrix
from .operators import (as_tensor, host_np, op_device, op_mesh, op_shape,
                        sharded_norm, to_dense)

__all__ = ["specrange", "ritzvals", "random_state"]


def random_state(op, *, rng: Optional[np.random.Generator] = None, dtype=np.complex128):
    """Random normalized host state compatible with ``op`` — random
    amplitudes with random phases (reference ``src/specrad.jl:153-158``).
    Unseeded unless ``rng`` is given.  For an operator that carries a
    mesh, the same host vector sharded on it (this rank's slots)."""
    if rng is None:
        rng = np.random.default_rng()
    N = op_shape(op)[1]
    psi = rng.random(N) * np.exp(2j * np.pi * rng.random(N))
    psi /= np.linalg.norm(psi)
    psi = psi.astype(dtype)
    mesh = op_mesh(op)
    return psi if mesh is None else mesh.shard(psi)


def ritzvals(
    op,
    state,
    m_min: int,
    m_max: Optional[int] = None,
    *,
    prec: float = 1e-5,
    norm_min: float = 1e-15,
):
    """Ritz values of ``op``, converged in extremal real part (and max
    imaginary magnitude) to relative precision ``prec``, over the leading
    sub-blocks of one order-``m_max`` Arnoldi factorization (reference
    ``src/specrad.jl:170-220``).  The Arnoldi run happens on ``op``'s
    device."""
    if m_max is None:
        m_max = 2 * m_min
    if m_max <= m_min:
        raise ValueError(f"m_max={m_max} must be larger than m_min={m_min}")
    m = max(5, min(m_min, m_max - 1))

    psi0 = as_tensor(state, device=op_device(op))
    psi0 = psi0 / sharded_norm(psi0, op_mesh(op))
    # the basis stays inside the call: only Hess and m_eff come out
    Hess, _, m_eff = _arnoldi(op, psi0, m_max, 1.0, extended=False,
                              norm_min=norm_min, basis=False)
    m_cap = min(m_eff, m_max)

    def _extremes(j):
        ev = diagonalize_hessenberg_matrix(Hess, j)
        return ev, ev.real.min(), ev.real.max(), np.abs(ev.imag).max()

    m0 = min(m - 1, m_cap)
    ev, lo0, hi0, im0 = _extremes(m0)
    if m0 < m - 1:
        return ev  # Krylov dimension exhausted below m-1
    m_cur = min(m, m_cap)
    ev, lo, hi, im = _extremes(m_cur)
    while m_cur < m_cap:
        e_lo = abs(1.0 - lo / lo0) if lo0 != 0.0 else 0.0
        e_hi = abs(1.0 - hi / hi0) if hi0 != 0.0 else 0.0
        e_im = abs(1.0 - im / im0) if im0 != 0.0 else 0.0
        converged = (
            (e_lo <= prec)
            and (e_hi <= prec)
            and ((im0 <= 1e-14) or (e_im <= prec))
        )
        if converged:
            break
        lo0, hi0, im0 = lo, hi, im
        m_cur += 1
        ev, lo, hi, im = _extremes(m_cur)
    return ev


def specrange(H, method: str = "auto", **kwargs):
    """Approximate ``(E_min, E_max)`` of ``H`` on the real axis.

    Methods (reference ``src/specrad.jl:36-140``):

    - ``'auto'``: ``'manual'`` if both bounds given; ``'diag'`` for
      dimension ≤ 32; else ``'arnoldi'``.
    - ``'diag'``: exact dense eigenvalues.
    - ``'arnoldi'``: Ritz values from a random start state
      (kwargs: ``state``, ``rng``, ``m_min=25``, ``m_max=60``,
      ``prec=1e-3``, ``norm_min=1e-15``, ``enlarge=True``).
    - ``'manual'``: return given ``E_min``/``E_max``.
    """
    if method == "auto":
        if "E_min" in kwargs and "E_max" in kwargs:
            return specrange(H, "manual", **kwargs)
        try:
            N = op_shape(H)[0]
        except Exception:
            N = None
        if N is not None and N <= 32:
            return specrange(H, "diag", **kwargs)
        return specrange(H, "arnoldi", **kwargs)

    if method == "manual":
        return float(kwargs["E_min"]), float(kwargs["E_max"])

    if method == "diag":
        evals = np.sort(np.real(np.linalg.eigvals(host_np(to_dense(H)))))
        return float(evals[0]), float(evals[-1])

    if method == "arnoldi":
        rng = kwargs.get("rng")
        state = kwargs.get("state")
        if state is None:
            state = random_state(H, rng=rng)
        m_max = int(kwargs.get("m_max", 60))
        m_min = max(5, min(int(kwargs.get("m_min", 25)), m_max - 1))
        prec = float(kwargs.get("prec", 1e-3))
        norm_min = float(kwargs.get("norm_min", 1e-15))
        enlarge = bool(kwargs.get("enlarge", True))
        R = np.sort_complex(
            ritzvals(H, state, m_min, m_max, prec=prec, norm_min=norm_min)
        )
        E_min = float(R[0].real)
        E_max = float(R[-1].real)
        if enlarge and len(R) > 1:
            E_min = 2 * E_min - float(R[1].real)
            E_max = 2 * E_max - float(R[-2].real)
        return E_min, E_max

    raise ValueError(f"Unknown specrange method {method!r}")
