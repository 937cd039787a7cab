"""Port vs JAX package: which ODE variant ``method="ode"`` builds.

With neither ``pwc`` nor ``piecewise`` given, the JAX package runs
``jax.eval_shape`` on the right-hand side: amplitudes that trace
integrate H(t) continuously, the rest fall back to the piecewise-constant
variant with a warning.  The port calls each amplitude on a 0-d float64
tensor on the ``meta`` device instead.  Each case here builds both
propagators on the setup of ``tests/test_expv_ode.py::test_ode_propagator``
(seed 54, N = 16, ``linspace(0, 2, 41)``), asserts the same variant and
warning, and holds the results together: 1e-12 where both integrate
piecewise (the same DP5 steps on the same midpoint operators), 1e-10
where both integrate continuously (``test_torch_krylov_ode.py``'s
continuous tolerance).  An explicit ``pwc=False`` is the port's way to
integrate any host callable continuously; the JAX package refuses it."""

import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.utils.fixtures import random_matrix, random_state_vector
from quantumpropagators_torch import set_default_device

set_default_device("cpu")

FALLBACK = "falling back to piecewise-constant evaluation"


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(54)
    N = 16
    H0 = random_matrix(N, hermitian=True, spectral_radius=2, rng=rng)
    H1 = random_matrix(N, hermitian=True, spectral_radius=1, rng=rng)
    tlist = np.linspace(0, 2, 41)
    psi0 = random_state_vector(N, rng=rng)
    return H0, H1, tlist, psi0


def _both(setup, port_amplitudes, jax_amplitudes, **kw):
    """The port's and the JAX package's propagator and result for
    ``H0 + Σ amplitude·H1``, with the warnings each init raised."""
    H0, H1, tlist, psi0 = setup
    out = {}
    for pkg, amps, conv in ((qt, port_amplitudes, torch.as_tensor),
                            (qp, jax_amplitudes, jnp.asarray)):
        gen = pkg.hamiltonian(conv(H0), *[(conv(k * H1), a)
                                          for k, a in enumerate(amps, 1)])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            prop = pkg.init_prop(conv(psi0), gen, tlist, method="ode", **kw)
        res = pkg.propagate(conv(psi0), gen, tlist, method="ode",
                            check=False, **kw)
        messages = [str(w.message) for w in caught]
        out[pkg.__name__] = (type(prop).__name__, messages, np.asarray(res))
    return out["quantumpropagators_torch"], out["quantumpropagators"]


def test_numpy_control_falls_back_as_jax_does(setup):
    (kind, msgs, res), (jkind, jmsgs, jres) = _both(
        setup, [lambda t: np.cos(t)], [lambda t: np.cos(t)])
    assert kind == jkind == "ODEPWCPropagator"
    assert any(FALLBACK in m for m in msgs)
    assert any(FALLBACK in m for m in jmsgs)
    assert np.linalg.norm(res - jres) <= 1e-12


def test_torch_control_integrates_continuously(setup):
    """``torch.cos`` is the port's counterpart of the JAX tests' ``jnp.cos``
    control: both trace, so both integrate continuously, with no
    warning."""
    (kind, msgs, res), (jkind, jmsgs, jres) = _both(
        setup, [lambda t: torch.cos(t)], [lambda t: jnp.cos(t)])
    assert kind == jkind == "ODEContinuousPropagator"
    assert not any(FALLBACK in m for m in msgs + jmsgs)
    assert np.linalg.norm(res - jres) <= 1e-10


def _branch(t):
    return 1.0 if t < 1 else 0.5


# name: (port amplitudes, JAX amplitudes, the variant JAX's rule picks)
_RULE = {
    "math.cos": ([lambda t: math.cos(t)], [lambda t: math.cos(t)],
                 "ODEPWCPropagator"),
    "branch on t": ([_branch], [_branch], "ODEPWCPropagator"),
    "constant": ([lambda t: 0.5], [lambda t: 0.5], "ODEContinuousPropagator"),
    "number beside a traced control": (
        [lambda t: torch.cos(t), 0.5], [lambda t: jnp.cos(t), 0.5],
        "ODEPWCPropagator"),
}


@pytest.mark.parametrize("name", list(_RULE))
def test_each_control_goes_where_jax_sends_it(setup, name):
    amps, jamps, want = _RULE[name]
    (kind, msgs, res), (jkind, jmsgs, jres) = _both(setup, amps, jamps)
    assert jkind == want
    assert kind == jkind
    fell_back = want == "ODEPWCPropagator"
    assert any(FALLBACK in m for m in msgs) == fell_back
    assert any(FALLBACK in m for m in jmsgs) == fell_back
    assert np.linalg.norm(res - jres) <= (1e-12 if fell_back else 1e-10)


def test_explicit_continuous_integrates_host_controls(setup):
    """The port's convention: ``pwc=False`` integrates a ``numpy`` control
    continuously (it is called on 0-d CPU tensors), agreeing with the JAX
    package's continuous run of ``jnp.cos``; the JAX package, which must
    trace the control, refuses the same call."""
    (kind, msgs, res), (jkind, _, jres) = _both(
        setup, [lambda t: np.cos(t)], [lambda t: jnp.cos(t)], pwc=False)
    assert kind == jkind == "ODEContinuousPropagator"
    assert not any(FALLBACK in m for m in msgs)
    assert np.linalg.norm(res - jres) <= 1e-10
    H0, H1, tlist, psi0 = setup
    jgen = qp.hamiltonian(jnp.asarray(H0),
                          (jnp.asarray(H1), lambda t: np.cos(t)))
    with pytest.raises(ValueError):
        qp.init_prop(jnp.asarray(psi0), jgen, tlist, method="ode", pwc=False)
