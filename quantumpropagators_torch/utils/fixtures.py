"""Random test fixtures (PyTorch port of
:mod:`quantumpropagators.utils.fixtures`).

Equivalent of the reference's shared ``QuantumControlTestUtils.RandomObjects``
(used throughout ``/root/reference/test/``): seeded random matrices with
prescribed spectral radius / density / hermiticity, random state
vectors, and random dynamic generators.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.generators import Generator, hamiltonian
from ..ops.operators import csr_from_dense

__all__ = ["random_matrix", "random_state_vector", "random_dynamic_generator"]


def random_matrix(
    N: int,
    *,
    spectral_radius: float = 1.0,
    hermitian: bool = False,
    density: float = 1.0,
    rng: Optional[np.random.Generator] = None,
    sparse: bool = False,
):
    """Random ``N×N`` complex matrix with approximately the given
    spectral radius.

    For ``hermitian=True`` the matrix is exactly Hermitian with spectral
    radius equal to ``spectral_radius`` (eigenvalues rescaled); for
    ``density < 1`` entries are randomly zeroed (sparsity pattern kept
    Hermitian when requested).  With ``sparse=True`` the result is a
    :class:`~quantumpropagators_torch.ops.operators.CSROperator` (on the
    package's default device).
    """
    if rng is None:
        rng = np.random.default_rng()
    X = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    if density < 1.0:
        mask = rng.random((N, N)) < density
        if hermitian:
            mask = np.triu(mask) | np.triu(mask, 1).T
        X = X * mask
    if hermitian:
        X = (X + X.conj().T) / 2
        evals = np.linalg.eigvalsh(X)
        rho = max(abs(evals[0]), abs(evals[-1]))
    else:
        rho = np.max(np.abs(np.linalg.eigvals(X)))
    if rho > 0:
        X = X * (spectral_radius / rho)
    if sparse:
        return csr_from_dense(X)
    return X


def random_state_vector(
    N: int, *, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Random normalized complex state vector."""
    if rng is None:
        rng = np.random.default_rng()
    psi = rng.random(N) * np.exp(2j * np.pi * rng.random(N))
    return psi / np.linalg.norm(psi)


def random_dynamic_generator(
    N: int,
    tlist,
    *,
    number_of_controls: int = 1,
    hermitian: bool = True,
    density: float = 1.0,
    spectral_radius: float = 1.0,
    rng: Optional[np.random.Generator] = None,
) -> Generator:
    """Random generator ``H₀ + Σ ϵₗ(t) Hₗ`` with smooth random pulse
    controls discretized on the midpoints of ``tlist``."""
    if rng is None:
        rng = np.random.default_rng()
    tlist = np.asarray(tlist, dtype=np.float64)
    T = tlist[-1] - tlist[0]
    H0 = random_matrix(
        N,
        hermitian=hermitian,
        density=density,
        spectral_radius=spectral_radius,
        rng=rng,
    )
    terms = [H0]
    for _ in range(number_of_controls):
        Hl = random_matrix(
            N,
            hermitian=hermitian,
            density=density,
            spectral_radius=spectral_radius,
            rng=rng,
        )
        a = rng.uniform(0.5, 1.5)
        w = rng.uniform(1.0, 3.0) * 2 * np.pi / max(T, 1e-30)
        phi = rng.uniform(0, 2 * np.pi)

        def eps(t, a=a, w=w, phi=phi, t0=tlist[0], T=T):
            return a * np.sin(w * (t - t0) + phi) * np.sin(
                np.pi * (t - t0) / T
            ) ** 2

        terms.append((Hl, eps))
    return hamiltonian(*terms, check=False)
