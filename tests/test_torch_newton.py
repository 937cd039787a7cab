"""Port vs JAX package: the restarted Newton kernel (``ops/newton.py``)
in the state's precision (``newton_apply``) and at reference accuracy
(``newton_apply_dd``), on the cases of ``tests/test_newton.py`` and
``tests/test_dd_linalg.py:196-252``: the port is within 1e-10 of both
scipy ``expm`` and the JAX result, and the host Leja ordering and
divided differences equal the JAX functions exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.linalg import expm

from quantumpropagators.ops import newton as jnewton
from quantumpropagators.utils.fixtures import random_matrix, random_state_vector
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.ops import newton as tnewton
from quantumpropagators_torch.ops.dd_linalg import cdd_op_from_matrix

set_default_device("cpu")

# (seed, N, spectral radius, hermitian, density, dt, kwargs, func) of
# tests/test_newton.py
_CASES = {
    "hermitian": (100, 1000, 10.0, True, 1.0, 0.5,
                  dict(m_max=5, max_restarts=200), None),
    "non_hermitian": (101, 1000, 10.0, False, 1.0, 0.5, dict(m_max=50),
                      None),
    "sparse_exp": (102, 1024, 2.0, False, 0.5, 0.5, dict(m_max=30), np.exp),
}


@pytest.fixture(scope="module", params=sorted(_CASES))
def case(request):
    seed, N, radius, herm, density, dt, kwargs, func = _CASES[request.param]
    rng = np.random.default_rng(seed)
    H = random_matrix(N, spectral_radius=radius, hermitian=herm,
                      density=density, rng=rng)
    psi0 = random_state_vector(N, rng=rng)
    M = H * dt if func is np.exp else -1j * H * dt
    fkw = {} if func is None else {"func": func}
    want_jax = np.asarray(jnewton.newton_apply(
        jnp.asarray(H), jnp.asarray(psi0), dt, **kwargs, **fkw))
    return (request.param, H, psi0, dt, kwargs, func, expm(M) @ psi0,
            want_jax)


def test_newton_apply_vs_jax(case):
    name, H, psi0, dt, kwargs, func, exact, want_jax = case
    fkw = {} if func is None else {"func": func}
    info = tnewton.NewtonInfo()
    got = tnewton.newton_apply(torch.as_tensor(H), torch.as_tensor(psi0),
                               dt, info=info, **kwargs, **fkw).numpy()
    assert np.linalg.norm(got - exact) < 1e-10
    assert np.abs(got - want_jax).max() < 1e-10
    if name == "hermitian":
        assert info.restarts > 1  # m_max=5 forces restarts


def test_newton_apply_dd_vs_jax(case):
    """The port's reference tier against expm and the JAX kernel's
    result (the JAX dd kernel itself is held to the same expm at these
    sizes by tests/test_dd_linalg.py:196-252)."""
    name, H, psi0, dt, kwargs, func, exact, want_jax = case
    if name == "sparse_exp":
        # the sparse operator route of tests/test_dd_linalg.py:223
        H = sp.csr_matrix(H)
    fkw = {} if func is None else {"func": func}
    got = tnewton.newton_apply_dd(H, psi0, dt, **kwargs, **fkw)
    assert got.dtype == torch.complex128
    got = got.numpy()
    assert np.abs(got - exact).max() < 1e-10
    assert np.abs(got - want_jax).max() < 1e-10


def test_newton_apply_dd_operator_kinds():
    """The dense and the sparse (blocked-ELL CDDOp) operator give the
    same result as the host matrix."""
    rng = np.random.default_rng(9)
    N = 128
    A = random_matrix(N, spectral_radius=4.0, hermitian=False, density=0.2,
                      rng=rng)
    psi = random_state_vector(N, rng=rng)
    exact = expm(0.5 * A) @ psi
    for op in (cdd_op_from_matrix(A),
               cdd_op_from_matrix(sp.csr_matrix(A), sparse=True,
                                  block_size=8)):
        got = tnewton.newton_apply_dd(op, psi, 0.5, m_max=40,
                                      func=np.exp).numpy()
        assert np.abs(got - exact).max() < 1e-10


def test_extend_leja_and_coeffs_equal_jax():
    rng = np.random.default_rng(7)
    pts = rng.normal(size=12) + 1j * rng.normal(size=12)
    more = rng.normal(size=9) + 0.3j * rng.normal(size=9)
    leja_t = tnewton.extend_leja(np.zeros(0), pts, 12)
    leja_j = jnewton.extend_leja(np.zeros(0), pts, 12)
    assert np.array_equal(leja_t, leja_j)
    leja_t = tnewton.extend_leja(leja_t, more, 9)
    leja_j = jnewton.extend_leja(leja_j, more, 9)
    assert np.array_equal(leja_t, leja_j)
    func = lambda z: np.exp(-1j * z)
    a_t = tnewton.extend_newton_coeffs(np.zeros(0), leja_t, func, 12, 2.5)
    a_j = jnewton.extend_newton_coeffs(np.zeros(0), leja_j, func, 12, 2.5)
    assert np.array_equal(a_t, a_j)
    a_t = tnewton.extend_newton_coeffs(a_t, leja_t, func, 21, 2.5)
    a_j = jnewton.extend_newton_coeffs(a_j, leja_j, func, 21, 2.5)
    assert np.array_equal(a_t, a_j)
    assert np.array_equal(tnewton._split_c128_planes([1 + 2j]),
                          np.array([1 + 2j]))


@pytest.mark.parametrize("dd", [False, True])
def test_newton_eigenvector_shortcut(dd):
    rng = np.random.default_rng(103)
    N = 50
    H = random_matrix(N, spectral_radius=5.0, hermitian=True, rng=rng)
    evals, evecs = np.linalg.eigh(H)
    psi = evecs[:, 3].astype(complex)
    info = tnewton.NewtonInfo()
    fn = tnewton.newton_apply_dd if dd else tnewton.newton_apply
    res = fn(H, psi, 0.7, m_max=10, info=info).numpy()
    assert np.linalg.norm(res - np.exp(-1j * evals[3] * 0.7) * psi) < 1e-10
    assert info.restarts == 0


def test_newton_requires_dim():
    with pytest.raises(ValueError):
        tnewton.newton_apply(np.eye(2, dtype=complex),
                             np.ones(2, dtype=complex), 0.5, m_max=10)
    with pytest.raises(ValueError):
        tnewton.newton_apply(np.eye(8, dtype=complex),
                             np.ones(8, dtype=complex), 0.5, m_max=2)
