"""Port vs JAX package: ``cheby_propagate_fused(kernel="dd")`` on a
driven generator over 100 steps — time-dependent amplitudes on the
diagonal AND the flip term (mirrors
``test_fused_cheby_dd.py::test_dd_kernel_driven_generator_100_steps``),
against both the JAX dd route and the JAX complex128 generic route."""

import jax.numpy as jnp
import numpy as np
import torch

import quantumpropagators as qp
from quantumpropagators.fused import cheby_propagate_fused as jax_fused
from quantumpropagators_torch.fused import cheby_propagate_fused
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch import set_default_device

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")

J, H = 1.0, 0.3
L = 10


def _driven(flip_only=False):
    H_diag, H_x = qp.transverse_field_ising(L, J=J, g=1.0, h=H,
                                            dtype=jnp.float64)
    eps_g = lambda t: 1.2 + 0.4 * np.cos(1.7 * t)   # g(t) ∈ [0.8, 1.6]
    eps_d = lambda t: 1.0 + 0.3 * np.sin(0.9 * t)   # diagonal drive
    if flip_only:
        return qp.hamiltonian(H_diag, (H_x, eps_g), check=False)
    return qp.hamiltonian((H_diag, eps_d), (H_x, eps_g), check=False)


def test_dd_driven_generator_100_steps():
    gen = _driven()
    rng = np.random.default_rng(21)
    psi0 = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi0 /= np.linalg.norm(psi0)
    tlist = np.linspace(0.0, 2.0, 101)
    # envelope certified over the control ranges, shifted (β ≠ 0)
    bound = 1.3 * (J * (L - 1) + H * L) + 1.6 * L
    kw = dict(specrange_method="manual", E_min=-bound - 0.5, E_max=bound)
    j_dd, _ = jax_fused(jnp.asarray(psi0), gen, tlist, kernel="dd", **kw)
    j_xla, _ = jax_fused(jnp.asarray(psi0), gen, tlist, kernel="xla", **kw)
    got, _ = cheby_propagate_fused(torch.as_tensor(psi0), from_jax(gen),
                                   tlist, kernel="dd", **kw)
    assert got.dtype == torch.complex128
    got = got.numpy()
    assert np.abs(got - np.asarray(j_dd)).max() < 1e-12
    assert np.abs(got - np.asarray(j_xla)).max() < 1e-12
    assert abs(np.linalg.norm(got) - 1.0) < 1e-11


def test_dd_driven_flip_only_backward():
    """Driven flip term only (static diagonal): forward then backward
    through kernel="dd" returns to the initial state at 1e-12, and the
    forward state matches the JAX dd route."""
    gen = _driven(flip_only=True)
    rng = np.random.default_rng(22)
    psi0 = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi0 /= np.linalg.norm(psi0)
    tlist = np.linspace(0.0, 0.5, 11)
    bound = J * (L - 1) + H * L + 1.6 * L
    kw = dict(specrange_method="manual", E_min=-bound, E_max=bound + 0.9)
    tgen = from_jax(gen)
    fwd, _ = cheby_propagate_fused(torch.as_tensor(psi0), tgen, tlist,
                                   kernel="dd", **kw)
    j_fwd, _ = jax_fused(jnp.asarray(psi0), gen, tlist, kernel="dd", **kw)
    assert np.abs(fwd.numpy() - np.asarray(j_fwd)).max() < 1e-12
    back, _ = cheby_propagate_fused(fwd, tgen, tlist, kernel="dd",
                                    backward=True, **kw)
    assert np.abs(back.numpy() - psi0).max() < 1e-12
