"""Port vs JAX package: CRAB functions (``models/crab.py``) and amplitude
types (``models/amplitudes.py``), both numpy-only copies.  The cases of
``tests/test_crab.py`` and ``tests/test_amplitudes.py``: the port's
values equal the JAX package's exactly, and amplitudes drive the port's
propagation as controls do."""

import numpy as np
import pytest
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.utils.iddict import IdDict

set_default_device("cpu")

TLIST = np.linspace(0, 10, 21)
TIMES = np.linspace(-1.0, 11.0, 37)


def _crabs(pkg):
    """The CRAB functions of tests/test_crab.py, built by ``pkg``."""
    freqs = np.array([1.0, 2.0])
    return {
        "random": pkg.CRABFunction(4, max_frequency=5.0,
                                   rng=np.random.default_rng(42)),
        "guess_shape": pkg.CRABFunction(
            3, frequencies=np.array([1.0, 2.0, 3.0]),
            rng=np.random.default_rng(7), guess=lambda t: 0.5 * t,
            shape=lambda t: np.exp(-t)),
        "even": pkg.CRABFunction(2, frequencies=freqs, parity="even",
                                 parameters=np.array([0.3, 0.4])),
        "odd": pkg.CRABFunction(2, frequencies=freqs, parity="odd",
                                parameters=np.array([0.3, 0.4])),
        "varied": pkg.VariedFrequencyCRABFunction(
            2, frequencies=freqs,
            parameters=np.array([0.5, 0.5, 0.0, 0.0, 2.0, 3.0])),
        "varied_random": pkg.VariedFrequencyCRABFunction(
            3, max_frequency=4.0, rng=np.random.default_rng(3)),
    }


@pytest.mark.parametrize("name", sorted(_crabs(qt)))
def test_crab_equals_jax(name):
    f, g = _crabs(qt)[name], _crabs(qp)[name]
    assert np.array_equal(f.frequencies, g.frequencies)
    assert np.array_equal(f.parameters, g.parameters)
    assert isinstance(f, qt.ParameterizedFunction)
    assert qt.get_parameters(f) is f.parameters
    for t in TIMES:
        assert f(t) == g(t)
    assert np.array_equal(qt.discretize(f, TLIST), qp.discretize(g, TLIST))


def test_crab_initial_parameters_and_errors():
    for kw in ({}, dict(guess=lambda t: t), dict(parity="even"),
               dict(vary_frequencies=True)):
        assert np.array_equal(qt.crab_initial_parameters(3, **kw),
                              qp.crab_initial_parameters(3, **kw))
    with pytest.raises(ValueError, match="cannot be all zero"):
        qt.CRABFunction(2)
    with pytest.raises(ValueError, match="parity"):
        qt.CRABFunction(2, max_frequency=1.0, parity="bogus")
    with pytest.raises(ValueError, match="Number of parameters"):
        qt.CRABFunction(2, max_frequency=1.0, parameters=np.zeros(17))
    with pytest.raises(ValueError, match="vector"):
        qt.CRABFunction(2, max_frequency=1.0, guess=np.zeros(10))


def _amplitudes(pkg):
    S = lambda t: pkg.blackman(t, 0, 10)
    F = lambda t: pkg.flattop(t, T=10, t_rise=2)
    G = lambda t: 0.3 * np.cos(t)
    eps = lambda t: np.sin(t)
    return {
        "locked": pkg.LockedAmplitude(F),
        "locked_vec": pkg.LockedAmplitude(F, TLIST),
        "shaped": pkg.ShapedAmplitude(eps, shape=S),
        "shaped_vec": pkg.ShapedAmplitude(eps, TLIST, shape=S),
        "guided": pkg.GuidedAmplitude(eps, shape=S, guide=G),
        "guided_vec": pkg.GuidedAmplitude(eps, TLIST, shape=S, guide=G),
    }


@pytest.mark.parametrize("name", sorted(_amplitudes(qt)))
def test_amplitude_equals_jax(name):
    a, b = _amplitudes(qt)[name], _amplitudes(qp)[name]
    for n in range(len(TLIST) - 1):
        assert qt.evaluate(a, TLIST, n) == qp.evaluate(b, TLIST, n)
    if not name.endswith("_vec"):
        for t in TIMES:
            assert qt.evaluate(a, t) == qp.evaluate(b, t)
    ca, cb = qt.get_controls(a), qp.get_controls(b)
    assert len(ca) == len(cb) == (0 if name.startswith("locked") else 1)
    if ca and not name.endswith("_vec"):
        vals = IdDict([(ca[0], 2.0)])
        jvals = qp.utils.iddict.IdDict([(cb[0], 2.0)])
        assert qt.evaluate(a, TLIST, 3, vals_dict=vals) \
            == qp.evaluate(b, TLIST, 3, vals_dict=jvals)


def test_amplitude_errors_and_substitute():
    with pytest.raises(ValueError):
        qt.LockedAmplitude(42)
    with pytest.raises(ValueError):
        qt.evaluate(qt.LockedAmplitude(np.sin, TLIST), 5.0)
    eps1, eps2 = np.sin, np.cos
    a = qt.ShapedAmplitude(eps1, shape=lambda t: 1.0)
    b = qt.substitute(a, IdDict([(eps1, eps2)]))
    assert qt.get_controls(b) == (eps2,)
    assert qt.evaluate(b, 1.0) == pytest.approx(np.cos(1.0))


def test_amplitude_in_generator():
    """tests/test_amplitudes.py:79-96 through the port's propagation."""
    from quantumpropagators_torch.interfaces import check_amplitude

    sx = torch.tensor([[0, 1], [1, 0]], dtype=torch.complex128)
    sz = torch.tensor([[1, 0], [0, -1]], dtype=torch.complex128)
    S = lambda t: qt.flattop(t, T=10, t_rise=2)
    eps = lambda t: 0.4
    gen = qt.hamiltonian(sz, (sx, qt.ShapedAmplitude(eps, shape=S)))
    assert qt.get_controls(gen) == (eps,)
    psi0 = torch.tensor([1, 0], dtype=torch.complex128)
    psi = qt.propagate(psi0, gen, TLIST, method="cheby")
    gen2 = qt.hamiltonian(sz, (sx, lambda t: S(t) * 0.4))
    psi2 = qt.propagate(psi0, gen2, TLIST, method="cheby")
    assert np.linalg.norm(psi.numpy() - psi2.numpy()) < 1e-12
    assert check_amplitude(qt.ShapedAmplitude(eps, shape=S), tlist=TLIST)
