"""Port vs JAX package: timing instrumentation (every case of
``test_timings.py``; reference ``test/test_timings.jl``): disabled by
default, matvec counts recorded when enabled and equal to the JAX
package's, reset on reinit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.utils import timings as jtimings
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.utils import timings as ttimings

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")

SZ = np.array([[1, 0], [0, -1]], dtype=complex)
SX = np.array([[0, 1], [1, 0]], dtype=complex)
TLIST = np.linspace(0, 10, 101)
PACKAGES = [(qt, torch.as_tensor, ttimings), (qp, jnp.asarray, jtimings)]


def _rabi(pkg, arr):
    H = pkg.hamiltonian(0.5 * arr(SZ), (arr(SX), lambda t: 0.8))
    return arr(np.array([1, 0], dtype=complex)), H


@pytest.fixture(autouse=True)
def _restore_timings_flag():
    yield
    ttimings.disable_timings()
    jtimings.disable_timings()


def test_timings_disabled_by_default():
    for pkg, arr, timings in PACKAGES:
        psi0, H = _rabi(pkg, arr)
        assert not timings.timings_enabled()
        prop = pkg.init_prop(psi0, H, TLIST, method="cheby")
        for _ in range(len(TLIST) - 1):
            pkg.prop_step(prop)
        assert prop.timing_data.times == {}
        assert prop.timing_data.counters == {}


def test_timings_record_matvecs():
    """After enable_timings, a 100-step Chebyshev propagation records
    >200 matvecs (reference ``test/test_timings.jl:28-30``), the same
    count in both packages, and the same final state (1e-12)."""
    counters, states = [], []
    for pkg, arr, timings in PACKAGES:
        psi0, H = _rabi(pkg, arr)
        timings.enable_timings()
        prop = pkg.init_prop(psi0, H, TLIST, method="cheby")
        n_steps = 0
        while pkg.prop_step(prop) is not None:
            n_steps += 1
        assert n_steps == len(TLIST) - 1
        assert prop.timing_data.calls["prop_step"] == n_steps
        assert prop.timing_data.counters["matvec"] > 200
        assert prop.timing_data.times["prop_step"] > 0.0
        report = prop.timing_data.report()
        assert "prop_step" in report and "matvec" in report
        counters.append(prop.timing_data.counters)
        states.append(np.asarray(prop.state))
    assert counters[0] == counters[1]
    np.testing.assert_allclose(states[0], states[1], atol=1e-12, rtol=0)


def test_timings_reset_on_reinit():
    for pkg, arr, timings in PACKAGES:
        psi0, H = _rabi(pkg, arr)
        timings.enable_timings()
        prop = pkg.init_prop(psi0, H, TLIST, method="cheby")
        pkg.prop_step(prop)
        assert prop.timing_data.counters.get("matvec", 0) > 0
        pkg.reinit_prop(prop, psi0)
        assert prop.timing_data.counters == {}
        assert prop.timing_data.calls == {}


def test_timings_toggle_roundtrip():
    for pkg, arr, timings in PACKAGES:
        psi0, H = _rabi(pkg, arr)
        assert timings.enable_timings() is True
        assert timings.timings_enabled()
        assert timings.disable_timings() is False
        assert not timings.timings_enabled()
        prop = pkg.init_prop(psi0, H, TLIST, method="cheby")
        pkg.prop_step(prop)
        assert prop.timing_data.counters == {}


@pytest.mark.parametrize("method", ["newton", "expv"])
def test_timings_other_methods(method):
    """Two steps of an 8-level random Hermitian system: two recorded
    steps in both packages, Newton's matvec counts equal."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
    psi = rng.standard_normal(8) + 1j * rng.standard_normal(8)
    psi = psi / np.linalg.norm(psi)
    counters, states = [], []
    for pkg, arr, timings in PACKAGES:
        H = pkg.hamiltonian(arr(A + A.conj().T))
        timings.enable_timings()
        prop = pkg.init_prop(arr(psi), H, np.linspace(0, 1, 11),
                             method=method)
        pkg.prop_step(prop)
        pkg.prop_step(prop)
        assert prop.timing_data.calls["prop_step"] == 2
        if method == "newton":
            assert prop.timing_data.counters["matvec"] > 0
        counters.append(prop.timing_data.counters)
        states.append(np.asarray(prop.state))
    assert counters[0] == counters[1]
    np.testing.assert_allclose(states[0], states[1], atol=1e-12, rtol=0)
