"""Port vs JAX package: Chebyshev coefficients and recurrence, and
spectral-range estimation (mirrors ``test_cheby.py`` and
``test_specrad.py``; reference ``test/test_cheby.jl``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

from quantumpropagators.ops import cheby as jcheby
from quantumpropagators.ops import specrange as jspec
from quantumpropagators.utils.fixtures import random_matrix, random_state_vector
from quantumpropagators_torch.ops import cheby as tcheby
from quantumpropagators_torch.ops import specrange as tspec
from quantumpropagators_torch import set_default_device

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")


@pytest.fixture(scope="module")
def system():
    """The reference's ensemble: N=1000 random Hermitian H, dt=0.5."""
    rng = np.random.default_rng(2591)
    N = 1000
    X = rng.random((N, N)) + 1j * rng.random((N, N))
    H = np.triu(X) + np.triu(X, 1).conj().T
    np.fill_diagonal(H, np.real(np.diag(X)))
    psi0 = random_state_vector(N, rng=rng)
    evals = np.linalg.eigvalsh(H)
    return H, psi0, evals


def test_cheby_coeffs_equal_and_count(system):
    _H, _psi0, evals = system
    delta = evals[-1] - evals[0]
    a = tcheby.cheby_coeffs(delta, 0.5, limit=1e-12)
    np.testing.assert_array_equal(a, jcheby.cheby_coeffs(delta, 0.5))
    assert 266 <= len(a) <= 269  # reference test_cheby.jl:36
    assert tcheby.n_cheby_coeffs(delta, 0.5) == len(a)


def test_cheby_vs_jax_and_expm(system):
    H, psi0, evals = system
    dt = 0.5
    e_min, delta = evals[0], evals[-1] - evals[0]
    a = tcheby.cheby_coeffs(delta, dt)
    got = tcheby.cheby_apply(torch.as_tensor(H), torch.as_tensor(psi0), a,
                             delta, e_min, dt).numpy()
    want = np.asarray(jcheby.cheby_apply(jnp.asarray(H), jnp.asarray(psi0),
                                         jnp.asarray(a), delta, e_min, dt))
    assert np.abs(got - want).max() < 1e-12
    assert np.linalg.norm(got - expm(-1j * H * dt) @ psi0) < 1e-10


def test_cheby_backward(system):
    H, psi0, evals = system
    dt = 0.5
    e_min, delta = evals[0], evals[-1] - evals[0]
    a = tcheby.cheby_coeffs(delta, dt)
    Ht = torch.as_tensor(H)
    fwd = tcheby.cheby_apply(Ht, torch.as_tensor(psi0), a, delta, e_min, dt)
    back = tcheby.cheby_apply(Ht, fwd, a, delta, e_min, -dt, forward=False)
    assert np.linalg.norm(back.numpy() - psi0) < 1e-12


def test_cheby_normalization_check(system):
    H, psi0, evals = system
    dt = 0.5
    e_min, delta = evals[0], evals[-1] - evals[0]
    Ht, pt = torch.as_tensor(H), torch.as_tensor(psi0)
    a = tcheby.cheby_coeffs(delta, dt)
    _res, max_norm = tcheby.cheby_apply(Ht, pt, a, delta, e_min, dt,
                                        check_normalization=True)
    _jres, jmax = jcheby.cheby_apply(jnp.asarray(H), jnp.asarray(psi0),
                                     jnp.asarray(a), delta, e_min, dt,
                                     check_normalization=True)
    assert max_norm <= 1.0 + 1e-12
    assert abs(max_norm - float(jmax)) < 1e-12
    bad = 0.2 * delta
    _res, bad_norm = tcheby.cheby_apply(Ht, pt, tcheby.cheby_coeffs(bad, dt),
                                        bad, e_min, dt,
                                        check_normalization=True)
    assert bad_norm > 1.0


def test_workspace_padding_matches():
    ws = tcheby.ChebyWorkspace.create(10.0, -5.0, 0.5, pad_to=8)
    jws = jcheby.ChebyWorkspace.create(10.0, -5.0, 0.5, pad_to=8)
    assert ws.n_coeffs == jws.n_coeffs
    np.testing.assert_array_equal(ws.coeffs, np.asarray(jws.coeffs))
    assert ws.coeffs.shape[0] % 8 == 0
    assert np.all(ws.coeffs[ws.n_coeffs:] == 0)


def test_specrange_arnoldi_shared_rng():
    """Same seed → same random start state → same Ritz bracket."""
    rng = np.random.default_rng(2)
    N = 500
    H = random_matrix(N, spectral_radius=8.0, hermitian=True, rng=rng)
    evals = np.linalg.eigvalsh(H)
    got = tspec.specrange(torch.as_tensor(H), "arnoldi",
                          rng=np.random.default_rng(17))
    want = jspec.specrange(jnp.asarray(H), "arnoldi",
                           rng=np.random.default_rng(17))
    np.testing.assert_allclose(got, want, rtol=1e-9)
    delta = evals[-1] - evals[0]
    assert got[0] <= evals[0] + 1e-9 and got[1] >= evals[-1] - 1e-9
    assert got[0] > evals[0] - 0.05 * delta and got[1] < evals[-1] + 0.05 * delta
    R_t = tspec.ritzvals(torch.as_tensor(H), random_state_vector(N, rng=rng),
                         20, 60, prec=1e-3)
    assert abs(R_t.real.max() - evals[-1]) / abs(evals[-1]) < 0.02


def test_specrange_diag_manual_and_random_state():
    rng = np.random.default_rng(3)
    H = random_matrix(16, spectral_radius=3.0, hermitian=True, rng=rng)
    evals = np.linalg.eigvalsh(H)
    Ht = torch.as_tensor(H)
    assert tspec.specrange(Ht, "diag") == pytest.approx((evals[0], evals[-1]))
    assert tspec.specrange(Ht, "auto") == pytest.approx((evals[0], evals[-1]))
    assert tspec.specrange(Ht, "auto", E_min=-2, E_max=2) == (-2.0, 2.0)
    with pytest.raises(ValueError, match="Unknown specrange method"):
        tspec.specrange(Ht, "lanczos")
    np.testing.assert_array_equal(
        tspec.random_state(Ht, rng=np.random.default_rng(4)),
        jspec.random_state(jnp.asarray(H), rng=np.random.default_rng(4)),
    )
