"""Port vs JAX package: the stepwise propagation loop (mirrors
``test_propagate.py``; reference ``test/test_propagate.jl``), the
``check=True`` contract checks and method selection."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.utils.fixtures import random_matrix, random_state_vector
from quantumpropagators_torch import interfaces
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch import set_default_device

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")

SX = np.array([[0, 1], [1, 0]], dtype=complex)
SZ = np.array([[1, 0], [0, -1]], dtype=complex)
TLIST = np.linspace(0, 10, 101)


@pytest.fixture
def tls():
    """Resonant Rabi problem: H = Ω σ_x, |0⟩ → cos²(Ωt) population,
    built in JAX and carried across."""
    jgen = qp.hamiltonian(jnp.zeros((2, 2), dtype=complex),
                          (jnp.asarray(SX), lambda t: 1.0))
    jpsi0 = jnp.asarray(np.array([1, 0], dtype=complex))
    return jgen, from_jax(jgen), jpsi0, from_jax(jpsi0)


def test_tls_rabi_vs_jax_and_analytic(tls):
    jgen, tgen, jpsi0, tpsi0 = tls
    states = qt.propagate(tpsi0, tgen, TLIST, method="cheby", storage=True)
    want = qp.propagate(jpsi0, jgen, TLIST, method="cheby", storage=True)
    assert states.shape == (2, len(TLIST))
    assert np.abs(states - np.asarray(want)).max() < 1e-12
    assert np.abs(states[0] - np.cos(TLIST)).max() < 1e-10
    assert np.abs(states[1] + 1j * np.sin(TLIST)).max() < 1e-10
    psi = qt.propagate(tpsi0, tgen, TLIST, method="auto")
    assert isinstance(psi, torch.Tensor) and psi.shape == (2,)
    assert abs(complex(psi[0]) - np.cos(TLIST[-1])) < 1e-10


def test_backward_reverses_forward(tls):
    _jgen, tgen, _jpsi0, tpsi0 = tls
    fwd = qt.propagate(tpsi0, tgen, TLIST, method="cheby", storage=True)
    bwd = qt.propagate(torch.as_tensor(fwd[:, -1]), tgen, TLIST,
                       method="cheby", backward=True, storage=True)
    assert np.abs(bwd - fwd).max() < 1e-12


def test_observables_and_storage(tls):
    _jgen, tgen, _jpsi0, tpsi0 = tls
    data = qt.propagate(tpsi0, tgen, TLIST, method="cheby",
                        observables=(torch.as_tensor(SZ),), storage=True)
    assert np.abs(data.real - np.cos(2 * TLIST)).max() < 1e-10
    calls = []

    def obs(state, tl, n):
        calls.append(n)
        return float(abs(state[0]) ** 2)

    data = qt.propagate(tpsi0, tgen, TLIST, method="cheby",
                        observables=(obs,), storage=True)
    assert calls[0] == 0 and calls[-1] == len(TLIST) - 1
    assert data.shape == (len(TLIST),)
    storage = np.zeros((2, len(TLIST)), dtype=complex)
    out = qt.propagate(tpsi0, tgen, TLIST, method="cheby", storage=storage)
    assert out.shape == (2,)
    assert np.linalg.norm(storage[:, -1] - out.numpy()) < 1e-12
    seen = []
    qt.propagate(tpsi0, tgen, TLIST, method="cheby",
                 callback=lambda prop, obs: seen.append(prop.t))
    assert len(seen) == len(TLIST) - 1 and seen[-1] == pytest.approx(TLIST[-1])


def test_propagate_sequence(tls):
    _jgen, tgen, _jpsi0, tpsi0 = tls
    t_half = np.linspace(0, 5, 51)
    direct = qt.propagate(tpsi0, tgen, TLIST, method="cheby")
    psi = qt.propagate_sequence(tpsi0, [
        qt.Propagation(tgen, t_half, method="cheby"),
        qt.Propagation(tgen, t_half + 5.0, method="cheby"),
    ])
    assert torch.linalg.vector_norm(psi - direct) < 1e-10
    psi2 = qt.propagate_sequence(tpsi0, [
        qt.Propagation(tgen, t_half, method="cheby"),
        qt.Propagation(tgen, t_half + 5.0, method="cheby",
                       pre_propagation=lambda s: -s),
    ])
    assert torch.linalg.vector_norm(psi2 + direct) < 1e-10
    stores = qt.propagate_sequence(tpsi0, [
        qt.Propagation(tgen, t_half, method="cheby"),
        qt.Propagation(tgen, t_half + 5.0, method="cheby"),
    ], storage=True)
    assert len(stores) == 2 and stores[1].shape == (2, 51)


def test_random_generator_vs_jax():
    """Driven random Hermitian generator: the port and the JAX package
    agree to 1e-12 with a generic (β ≠ 0) spectral envelope."""
    rng = np.random.default_rng(7)
    N = 24
    H0 = random_matrix(N, spectral_radius=3.0, hermitian=True, rng=rng)
    H1 = random_matrix(N, spectral_radius=1.0, hermitian=True, rng=rng)
    jgen = qp.hamiltonian(jnp.asarray(H0),
                          (jnp.asarray(H1), lambda t: np.sin(2 * t)))
    tlist = np.linspace(0, 5, 126)
    psi0 = random_state_vector(N, rng=rng)
    want = np.asarray(qp.propagate(jnp.asarray(psi0), jgen, tlist,
                                   method="cheby"))
    got = qt.propagate(torch.as_tensor(psi0), from_jax(jgen), tlist,
                       method="cheby").numpy()
    assert np.abs(got - want).max() < 1e-12
    # precision="dd" is the complex128 step; a complex64 state comes back
    # in complex128 and matches
    got_dd = qt.propagate(torch.as_tensor(psi0).to(torch.complex64),
                          from_jax(jgen), tlist, method="cheby",
                          precision="dd", check=False)
    assert got_dd.dtype == torch.complex128
    assert np.abs(got_dd.numpy() - want).max() < 1e-6


def test_check_rejects_real_state(tls, caplog):
    _jgen, tgen, _jpsi0, _tpsi0 = tls
    real = torch.tensor([1.0, 0.0], dtype=torch.float64)
    with pytest.raises(ValueError, match="does not pass check_state"):
        qt.propagate(real, tgen, TLIST, method="cheby")
    with caplog.at_level(logging.ERROR, logger="quantumpropagators_torch.interfaces"):
        assert not interfaces.check_state(real)
    assert "the state must have a complex dtype" in caplog.text
    assert interfaces.check_state(torch.tensor([0.6 + 0j, 0.8j]))
    assert interfaces.check_generator(tgen, state=torch.tensor([1 + 0j, 0]),
                                         tlist=TLIST)
    with pytest.raises(ValueError, match="does not pass check_tlist"):
        qt.propagate(torch.tensor([1.0 + 0j, 0]), tgen, TLIST[::-1])


def test_unknown_method_errors(tls):
    _jgen, tgen, _jpsi0, tpsi0 = tls
    with pytest.raises(ValueError, match="Unknown propagation method 'foo'"):
        qt.propagate(tpsi0, tgen, TLIST, method="foo")
    with pytest.raises(ValueError) as jexc:
        qp.propagate(jnp.asarray([1.0 + 0j, 0]), qp.hamiltonian(
            jnp.zeros((2, 2), dtype=complex),
            (jnp.asarray(SX), lambda t: 1.0)), TLIST, method="foo")
    assert str(jexc.value).startswith("Unknown propagation method 'foo'")
    # auto on a non-Hermitian generator resolves to newton in both
    # packages, which needs more than two levels
    nonherm = torch.tensor([[0, 1], [0, 0]], dtype=torch.complex128)
    with pytest.raises(ValueError, match="state dimension > 2"):
        qt.propagate(tpsi0, qt.hamiltonian(nonherm, (torch.as_tensor(SX),
                                                     lambda t: 1.0)),
                     TLIST, check=False)
    with pytest.raises(ValueError, match="state dimension > 2"):
        qp.propagate(jnp.asarray([1.0 + 0j, 0]), qp.hamiltonian(
            jnp.asarray(nonherm.numpy()), (jnp.asarray(SX), lambda t: 1.0)),
            TLIST, check=False)
    # fused newton_leja runs and agrees with the Chebyshev propagation
    got = qt.propagate(tpsi0, tgen, TLIST, method="newton_leja", fused=True)
    ref = qt.propagate(tpsi0, tgen, TLIST, method="cheby")
    assert float((got - ref).abs().max()) < 1e-10


def test_generator_firewall(tls):
    _jgen, tgen, _jpsi0, tpsi0 = tls
    prop = qt.init_prop(tpsi0, tgen, TLIST, method="cheby")
    with pytest.raises(AttributeError, match="cannot be mutated"):
        prop.generator = tgen
    with pytest.raises(AttributeError, match="does not expose"):
        prop.generator
    assert qt.prop_step(prop).shape == (2,)
    qt.reinit_prop(prop, tpsi0)
    assert prop.t == TLIST[0]
