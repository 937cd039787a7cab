"""Port vs JAX package: ``cheby_propagate_fused(kernel="dd")`` on
multi-amplitude generators — two independently driven flip groups on
disjoint sites plus a driven diagonal over 100 steps, and several static
diagonal terms (mirrors the multi-amplitude tests of
``test_fused_cheby_dd.py``), against the JAX dd and generic routes."""

import jax.numpy as jnp
import numpy as np
import torch

import quantumpropagators as qp
from quantumpropagators.fused import cheby_propagate_fused as jax_fused
from quantumpropagators.models.lattice import SiteOperatorSum
from quantumpropagators.ops.operators import DiagonalOperator
from quantumpropagators_torch.fused import cheby_propagate_fused
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch import set_default_device

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")

J, H = 1.0, 0.3
L = 10


def test_dd_two_disjoint_driven_groups_100_steps():
    H_diag, _ = qp.transverse_field_ising(L, J=J, g=1.0, h=H,
                                          dtype=jnp.float64)
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    rng = np.random.default_rng(29)
    g_site = rng.uniform(0.7, 1.3, size=L)
    mats_odd = np.zeros((L, 2, 2))
    mats_even = np.zeros((L, 2, 2))
    for i in range(L):
        (mats_odd if i % 2 else mats_even)[i] = g_site[i] * sx
    Hx_odd = SiteOperatorSum(jnp.asarray(mats_odd), L=L,
                             active=tuple(i % 2 == 1 for i in range(L)))
    Hx_even = SiteOperatorSum(jnp.asarray(mats_even), L=L,
                              active=tuple(i % 2 == 0 for i in range(L)))
    eps_d = lambda t: 1.0 + 0.3 * np.sin(0.9 * t)
    eps_o = lambda t: 1.2 + 0.4 * np.cos(1.7 * t)
    eps_e = lambda t: 0.9 + 0.5 * np.sin(2.3 * t)
    gen = qp.hamiltonian((H_diag, eps_d), (Hx_odd, eps_o), (Hx_even, eps_e),
                         check=False)
    psi0 = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi0 /= np.linalg.norm(psi0)
    tlist = np.linspace(0.0, 2.0, 101)
    bound = 1.3 * (J * (L - 1) + H * L) + 1.6 * float(np.abs(g_site).sum())
    kw = dict(specrange_method="manual", E_min=-bound, E_max=bound + 1.1)
    tgen = from_jax(gen)
    psi = torch.as_tensor(psi0)
    # both JAX routes are slow on the CPU (the dd one interprets its
    # Pallas kernels), so they are held over the first 20 steps; all 100
    # steps are held against the port's own generic path
    short = tlist[:21]
    j_dd, _ = jax_fused(jnp.asarray(psi0), gen, short, kernel="dd", **kw)
    j_xla, _ = jax_fused(jnp.asarray(psi0), gen, short, kernel="xla", **kw)
    got20, _ = cheby_propagate_fused(psi, tgen, short, kernel="dd", **kw)
    assert np.abs(got20.numpy() - np.asarray(j_dd)).max() < 1e-12
    assert np.abs(got20.numpy() - np.asarray(j_xla)).max() < 1e-12
    got, _ = cheby_propagate_fused(psi, tgen, tlist, kernel="dd", **kw)
    xla, _ = cheby_propagate_fused(psi, tgen, tlist, kernel="xla", **kw)
    assert float((got - xla).abs().max()) < 1e-12
    assert abs(float(torch.linalg.vector_norm(got)) - 1.0) < 1e-11


def test_dd_multi_static_diag_terms():
    H_diag, H_x = qp.transverse_field_ising(L, J=J, g=1.0, h=H,
                                            dtype=jnp.float64)
    rng = np.random.default_rng(33)
    extra = DiagonalOperator(jnp.asarray(rng.normal(size=2 ** L)))
    op = qp.Operator([H_diag, extra, H_x], np.array([1.0, 0.5, 1.1]))
    psi0 = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi0 /= np.linalg.norm(psi0)
    tlist = np.linspace(0.0, 0.3, 4)
    bound = J * (L - 1) + H * L + 0.5 * float(
        np.abs(np.asarray(extra.diag)).max()) + 1.1 * L
    kw = dict(specrange_method="manual", E_min=-bound - 0.3, E_max=bound)
    j_dd, _ = jax_fused(jnp.asarray(psi0), op, tlist, kernel="dd", **kw)
    got, _ = cheby_propagate_fused(torch.as_tensor(psi0), from_jax(op),
                                   tlist, kernel="dd", **kw)
    got = got.numpy()
    j_xla, _ = jax_fused(jnp.asarray(psi0), op, tlist, kernel="xla", **kw)
    assert np.abs(got - np.asarray(j_dd)).max() < 1e-12
    assert np.abs(got - np.asarray(j_xla)).max() < 1e-12
