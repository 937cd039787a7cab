"""Controls written in ``torch`` math, and the time every callable control
is called at (``models.controls.control_time``).

The port's counterpart of the JAX package's ``jnp.sin`` control is a
``torch.sin`` control: it receives ``t`` as a 0-d float64 tensor, at
every host time as inside the continuous ODE integrator.  So a
``torch`` control runs under every method with the default ``check``,
within 1e-12 of the JAX package's ``jnp`` control, and passes the
``check_*`` functions; and ``numpy``, ``math`` and the port's shape
functions compute on the tensor the bits (and ``numpy`` the types) they
compute on the float."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.utils.fixtures import random_matrix, random_state_vector
from quantumpropagators_torch.models import shapes
from quantumpropagators_torch.models.controls import control_time

qt.set_default_device("cpu")


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(56)
    N = 8
    H0 = random_matrix(N, hermitian=True, spectral_radius=2, rng=rng)
    H1 = random_matrix(N, hermitian=True, spectral_radius=1, rng=rng)
    return H0, H1, random_state_vector(N, rng=rng), np.linspace(0, 1, 6)


def _generators(system, port_control, jax_control):
    H0, H1, _, _ = system
    T = torch.as_tensor
    return (qt.hamiltonian(T(H0), (T(H1), port_control)),
            qp.hamiltonian(jnp.asarray(H0), (jnp.asarray(H1), jax_control)))


@pytest.mark.parametrize("method", ["cheby", "newton", "expprop", "ode"])
def test_torch_control_propagates_as_jax_does(system, method):
    """A ``torch.sin`` control under each method with the default
    ``check=True`` against the JAX package's ``jnp.sin`` run (the ODE
    rule sends both to the continuous variant)."""
    gen, jgen = _generators(system, lambda t: 0.3 * torch.sin(2.0 * t),
                            lambda t: 0.3 * jnp.sin(2.0 * t))
    _, _, psi0, tlist = system
    got = qt.propagate(torch.as_tensor(psi0), gen, tlist, method=method)
    want = qp.propagate(jnp.asarray(psi0), jgen, tlist, method=method)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-12


def test_checks_accept_a_torch_control(system):
    control = lambda t: 0.3 * torch.cos(2.0 * t)
    gen, _ = _generators(system, control, None)
    psi0, tlist = system[2:]
    assert qt.check_control(control, tlist=tlist, for_time_continuous=True,
                            quiet=True)
    assert qt.check_amplitude(control, tlist=tlist,
                              for_time_continuous=True, quiet=True)
    assert qt.check_amplitude(qt.ShapedAmplitude(control, shape=lambda t:
                                                 torch.exp(-t)),
                              tlist=tlist, quiet=True)
    assert qt.check_generator(gen, state=torch.as_tensor(psi0), tlist=tlist,
                              for_time_continuous=True, quiet=True)


_HOST_CONTROLS = {
    "numpy": lambda t: 0.1 * np.sin(t),
    "numpy array": lambda t: float(np.dot([0.5, 0.25],
                                          np.cos(np.array([1.0, 3.0]) * t))),
    "math": lambda t: math.sin(t) * math.exp(-t),
    "gaussian": lambda t: np.exp(-t ** 2),
    "branch": lambda t: 0.4 if t < 0.35 else -0.2,
    "complex": lambda t: np.exp(1j * t),
    "box": lambda t: shapes.box(t, 0.1, 0.7),
    "blackman": lambda t: shapes.blackman(t, 0.0, 1.0),
    "flattop": lambda t: shapes.flattop(t, T=1.0, t_rise=0.3),
}


@pytest.mark.parametrize("name", sorted(_HOST_CONTROLS))
def test_host_controls_keep_their_bits(name):
    """``discretize``, ``discretize_on_midpoints`` and ``evaluate`` of a
    host control equal its calls at the floats bit for bit, with numbers
    (not tensors) for values."""
    control = _HOST_CONTROLS[name]
    tlist = np.linspace(0.0, 1.0, 8)
    mids = qt.get_tlist_midpoints(tlist)
    if name != "complex":  # controls are real; amplitudes may be complex
        assert np.array_equal(qt.discretize(control, tlist, via_midpoints=False),
                              [float(control(t)) for t in tlist])
        assert np.array_equal(qt.discretize_on_midpoints(control, tlist),
                              [float(control(t)) for t in mids])
        assert np.array_equal(
            qt.discretize(control, tlist),
            qt.discretize(np.array([float(control(t)) for t in mids]), tlist))
    for t in tlist:
        value = qt.evaluate(control, t)
        assert not isinstance(value, torch.Tensor)
        assert value == control(float(t))
    for n in range(len(tlist) - 1):
        assert qt.evaluate(control, tlist, n) == control(float(mids[n]))


def test_control_time_is_the_float():
    """A 0-d float64 tensor holding the float exactly; an array times it
    is an array, a ufunc of it a numpy scalar, a true division by zero
    raises as the float's does, and ``torch`` math gives tensors."""
    t = control_time(np.float64(0.1) + 2.0 ** -40)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float64
    assert t.dim() == 0 and float(t) == 0.1 + 2.0 ** -40
    assert type(np.sin(t)) is np.float64
    assert type(np.array([1.0, 2.0]) * t) is np.ndarray
    assert isinstance(torch.sin(t), torch.Tensor)
    with pytest.raises(ZeroDivisionError):
        1.0 / (t - t)
    with pytest.raises(ZeroDivisionError):
        t / 0
