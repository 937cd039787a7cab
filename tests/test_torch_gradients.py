"""Port vs JAX package: gradients through ``make_fused_cheby_propagator``
(the two-level control problem of ``test_gradients.py``).

``torch.autograd`` through the generic Chebyshev scan takes the place of
``jax.grad``: the gradient with respect to the coefficient table equals
the JAX package's to 1e-10 relative and finite differences as in the
JAX test; the observable-trajectory gradient equals JAX's to 1e-10; the
GRAPE loop's first 10 losses and tables equal the JAX loop's to 1e-10
(the JAX loop runs all 200 steps and its π-pulse criterion)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.fused import make_fused_cheby_propagator as jmake
from quantumpropagators.models.generators import coeff_table as jcoeff_table
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.fused import make_fused_cheby_propagator
from quantumpropagators_torch.models.generators import coeff_table

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")

SX = np.array([[0, 1], [1, 0]], dtype=complex)
SZ = np.array([[1, 0], [0, -1]], dtype=complex)
TLIST = np.linspace(0, 2, 41)
PSI0 = np.array([1, 0], dtype=complex)
TARGET = np.array([0, 1], dtype=complex)
ENVELOPE = dict(E_min=-3.0, E_max=3.0, specrange_method="manual")


def _gen(pkg, arr):
    return pkg.hamiltonian(0.0 * arr(SZ), (arr(SX), lambda t: 0.2))


@pytest.fixture(scope="module")
def problem():
    """State transfer |0⟩ → |1⟩ on a TLS with a σx drive, on both
    packages, with the JAX test's generous spectral envelope."""
    tgen, jgen = _gen(qt, torch.as_tensor), _gen(qp, jnp.asarray)
    fn = make_fused_cheby_propagator(torch.as_tensor(PSI0), tgen, TLIST,
                                     **ENVELOPE)
    jfn = jmake(jnp.asarray(PSI0), jgen, TLIST, **ENVELOPE)
    table0 = coeff_table(tgen, TLIST)
    assert np.array_equal(table0.numpy(), np.asarray(jcoeff_table(jgen,
                                                                  TLIST)))
    return fn, jfn, table0


def _infidelity(fn, table):
    psi_T, _ = fn(torch.as_tensor(PSI0), table)
    overlap = torch.vdot(torch.as_tensor(TARGET), psi_T)
    return 1.0 - overlap.abs() ** 2


def _jax_infidelity(jfn):
    def infidelity(table):
        psi_T, _ = jfn(jnp.asarray(PSI0), table)
        return 1.0 - jnp.abs(jnp.vdot(jnp.asarray(TARGET), psi_T)) ** 2

    return infidelity


def test_gradient_matches_jax_and_finite_difference(problem):
    fn, jfn, table0 = problem
    table = table0.clone().requires_grad_(True)
    loss = _infidelity(fn, table)
    (g,) = torch.autograd.grad(loss, table)
    assert g.shape == table0.shape
    jloss, jg = jax.value_and_grad(_jax_infidelity(jfn))(
        jnp.asarray(table0.numpy()))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=0)
    base = table0.numpy()
    for idx in [(0, 0), (10, 0), (25, 0)]:
        eps = 1e-6
        tp, tm = base.copy(), base.copy()
        tp[idx] += eps
        tm[idx] -= eps
        with torch.no_grad():
            fd = (float(_infidelity(fn, torch.as_tensor(tp)))
                  - float(_infidelity(fn, torch.as_tensor(tm)))) / (2 * eps)
        assert float(g[idx]) == pytest.approx(fd, rel=1e-5, abs=1e-8)


def test_grape_style_optimization(problem):
    """The port's first 10 gradient-descent steps equal the JAX loop's
    (losses and tables to 1e-10); the JAX loop's 200 steps reach the
    JAX test's near-perfect π-pulse from the same start."""
    fn, jfn, table0 = problem
    loss_and_grad = jax.jit(jax.value_and_grad(_jax_infidelity(jfn)))
    lr = 1.0
    jtable = jnp.asarray(table0.numpy())
    jlosses, jtables = [], []
    for _ in range(200):
        l, g = loss_and_grad(jtable)
        jtables.append(np.asarray(jtable))
        jtable = jtable - lr * g
        jlosses.append(float(l))
    assert jlosses[-1] < 1e-6 and jlosses[-1] < jlosses[0] / 100
    dt = TLIST[1] - TLIST[0]
    assert abs(abs(float(jnp.sum(jtable[:, 0]) * dt)) - np.pi / 2) < 0.05

    table = table0.clone()
    for k in range(10):
        np.testing.assert_allclose(table.numpy(), jtables[k], rtol=1e-10,
                                   atol=1e-12)
        table.requires_grad_(True)
        loss = _infidelity(fn, table)
        (g,) = torch.autograd.grad(loss, table)
        assert float(loss.detach()) == pytest.approx(jlosses[k], rel=1e-10)
        table = (table - lr * g).detach()
    assert jlosses[9] < jlosses[0]


def test_gradient_through_observable_trajectory(problem):
    """Gradients flow through in-scan observables too (trajectory
    shaping objectives), and equal the JAX package's (1e-10)."""
    _, _, table0 = problem
    tgen, jgen = _gen(qt, torch.as_tensor), _gen(qp, jnp.asarray)
    sz, jsz = torch.as_tensor(SZ), jnp.asarray(SZ)
    fn = make_fused_cheby_propagator(
        torch.as_tensor(PSI0), tgen, TLIST, **ENVELOPE,
        observable_fn=lambda psi: torch.vdot(psi, sz @ psi).real)
    jfn = jmake(jnp.asarray(PSI0), jgen, TLIST, **ENVELOPE,
                observable_fn=lambda psi: jnp.vdot(psi, jsz @ psi).real)

    def traj_cost(tb):
        _, vals = fn(torch.as_tensor(PSI0), tb)
        return torch.mean((vals + 1.0) ** 2)  # drive ⟨σz⟩ toward -1

    def jtraj_cost(tb):
        _, vals = jfn(jnp.asarray(PSI0), tb)
        return jnp.mean((vals + 1.0) ** 2)

    table = table0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(traj_cost(table), table)
    assert torch.all(torch.isfinite(g))
    assert float(torch.linalg.vector_norm(g)) > 1e-6
    jg = jax.grad(jtraj_cost)(jnp.asarray(table0.numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-14)


def test_gradient_through_stored_states(problem):
    """``store_states=True``: a cost on the whole trajectory has the
    JAX package's gradient (1e-10)."""
    _, _, table0 = problem
    tgen, jgen = _gen(qt, torch.as_tensor), _gen(qp, jnp.asarray)
    fn = make_fused_cheby_propagator(torch.as_tensor(PSI0), tgen, TLIST,
                                     store_states=True, **ENVELOPE)
    jfn = jmake(jnp.asarray(PSI0), jgen, TLIST, store_states=True,
                **ENVELOPE)
    table = table0.clone().requires_grad_(True)
    _, states = fn(torch.as_tensor(PSI0), table)
    assert states.shape == (len(TLIST) - 1, 2)
    (g,) = torch.autograd.grad(torch.mean(states[:, 1].abs() ** 2), table)
    jg = jax.grad(lambda tb: jnp.mean(
        jnp.abs(jfn(jnp.asarray(PSI0), tb)[1][:, 1]) ** 2))(
        jnp.asarray(table0.numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-14)
