"""Port vs JAX package: time-dependent observables (both cases of
``test_timedependent_observables.py``; reference
``test/test_timedependent_observables.jl``): rotating-frame and
lab-frame observables against closed-form sin/cos (1e-10, 1e-9 as
there) and against the JAX package's storage (1e-12)."""

import jax.numpy as jnp
import numpy as np
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators_torch import set_default_device

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")

SX = np.array([[0, 1], [1, 0]], dtype=complex)
SY = np.array([[0, -1j], [1j, 0]], dtype=complex)
SZ = np.array([[1, 0], [0, -1]], dtype=complex)
PACKAGES = [(qt, torch.as_tensor), (qp, jnp.asarray)]


def test_rotating_frame_observable():
    """Propagate in the lab frame under H = (ω/2)σz; σx in the frame
    rotating at ω stays at its initial value, while the lab-frame ⟨σx⟩
    follows cos(ωt)."""
    omega = 3.0
    H = 0.5 * omega * SZ
    tlist = np.linspace(0, 4, 201)
    psi0 = np.array([1, 1], dtype=complex) / np.sqrt(2)

    def sx_rotating(state, tl, n):
        t = tl[n]
        U = np.array(
            [[np.exp(0.5j * omega * t), 0], [0, np.exp(-0.5j * omega * t)]]
        )
        rotated = U @ np.asarray(state)
        return float(np.real(rotated.conj() @ SX @ rotated))

    results = []
    for pkg, arr in PACKAGES:
        data = np.asarray(pkg.propagate(
            arr(psi0), arr(H), tlist, method="expprop",
            observables=(arr(SX), sx_rotating), storage=True))
        assert data.shape == (2, len(tlist))
        assert np.max(np.abs(data[0].real - np.cos(omega * tlist))) < 1e-10
        assert np.max(np.abs(data[1].real - 1.0)) < 1e-10
        results.append(data)
    np.testing.assert_allclose(results[0], results[1], atol=1e-12, rtol=0)


def test_lab_frame_sin_component():
    """⟨σy⟩ under σz rotation follows +sin(ωt) for |+⟩."""
    omega = 2.0
    H = 0.5 * omega * SZ
    tlist = np.linspace(0, 5, 251)
    psi0 = np.array([1, 1], dtype=complex) / np.sqrt(2)
    results = []
    for pkg, arr in PACKAGES:
        data = np.asarray(pkg.propagate(
            arr(psi0), arr(H), tlist, method="cheby",
            observables=(arr(SY),), storage=True))
        assert np.max(np.abs(data.real - np.sin(omega * tlist))) < 1e-9
        results.append(data)
    np.testing.assert_allclose(results[0], results[1], atol=1e-12, rtol=0)
