"""Port vs JAX package: batched propagation (every case of
``test_batched.py``, N = 64).  A leading batch axis of states goes
through ``cheby_apply`` on dense, CSR and lattice operators, and
``torch.func.vmap`` over control amplitudes takes the place of
``jax.vmap``; each batch row equals its single call and the JAX
package's result to 1e-12 (1e-10 against ``expm``, as there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.ops.cheby import cheby_apply as jcheby_apply
from quantumpropagators.ops.operators import csr_from_dense as jcsr
from quantumpropagators.utils.fixtures import random_matrix, random_state_vector
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.ops.cheby import cheby_apply, cheby_coeffs
from quantumpropagators_torch.utils.timings import (
    disable_timings,
    enable_timings,
    timings_enabled,
)

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(88)
    N = 64
    H = random_matrix(N, hermitian=True, spectral_radius=4.0, rng=rng)
    evals = np.linalg.eigvalsh(H)
    batch = np.stack([random_state_vector(N, rng=rng) for _ in range(5)])
    return H, evals, batch


def test_batched_cheby_dense(system):
    H, evals, batch = system
    dt = 0.3
    delta, e_min = evals[-1] - evals[0], evals[0]
    a = cheby_coeffs(delta, dt)
    out = cheby_apply(torch.as_tensor(H), torch.as_tensor(batch), a, delta,
                      e_min, dt)
    assert out.shape == batch.shape
    jout = np.asarray(jcheby_apply(jnp.asarray(H), jnp.asarray(batch),
                                   jnp.asarray(a), delta, e_min, dt))
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-12, rtol=0)
    for b in range(batch.shape[0]):
        single = cheby_apply(torch.as_tensor(H), torch.as_tensor(batch[b]),
                             a, delta, e_min, dt)
        np.testing.assert_allclose(out[b].numpy(), single.numpy(),
                                   atol=1e-12, rtol=0)


def test_batched_cheby_csr(system):
    H, evals, batch = system
    Hs = H * (np.abs(H) > 0.1)
    ev = np.linalg.eigvalsh(Hs)
    dt = 0.3
    delta, e_min = ev[-1] - ev[0], ev[0]
    a = cheby_coeffs(delta, dt)
    out = cheby_apply(qt.csr_from_dense(Hs), torch.as_tensor(batch), a, delta,
                      e_min, dt).numpy()
    U = expm(-1j * Hs * dt)
    np.testing.assert_allclose(out, batch @ U.T, atol=1e-10, rtol=0)
    jout = np.asarray(jcheby_apply(jcsr(Hs), jnp.asarray(batch),
                                   jnp.asarray(a), delta, e_min, dt))
    np.testing.assert_allclose(out, jout, atol=1e-12, rtol=0)


def test_batched_cheby_lattice():
    """A (3, 2^6) batch through the TFIM chain's lattice operators
    (diagonal and site sum) equals the single calls and the JAX package
    (1e-12)."""
    L = 6
    td, tx = qt.transverse_field_ising(L, J=1.0, g=1.2, h=0.3,
                                       dtype=torch.complex128)
    jd, jx = qp.transverse_field_ising(L, J=1.0, g=1.2, h=0.3,
                                       dtype=jnp.complex128)
    top = qt.Operator([td, tx], np.array([0.6]))
    jop = qp.Operator([jd, jx], np.array([0.6]))
    bound = (L - 1) + 0.3 * L + 1.2 * L
    delta, e_min, dt = 2 * bound, -bound, 0.1
    a = cheby_coeffs(delta, dt)
    rng = np.random.default_rng(4)
    batch = np.stack([random_state_vector(2 ** L, rng=rng) for _ in range(3)])
    out = cheby_apply(top, torch.as_tensor(batch), a, delta, e_min, dt)
    jout = np.asarray(jcheby_apply(jop, jnp.asarray(batch), jnp.asarray(a),
                                   delta, e_min, dt))
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-12, rtol=0)
    for b in range(3):
        single = cheby_apply(top, torch.as_tensor(batch[b]), a, delta, e_min,
                             dt)
        np.testing.assert_allclose(out[b].numpy(), single.numpy(),
                                   atol=1e-12, rtol=0)


def test_vmap_over_control_sets(system):
    """``torch.func.vmap`` over the amplitude of ``Operator([H, H1],
    [amp])``: 7 control settings in one call, each equal to its single
    call and to ``jax.vmap`` of the JAX package's function."""
    H, evals, batch = system
    rng = np.random.default_rng(9)
    H1 = random_matrix(64, hermitian=True, spectral_radius=1.0, rng=rng)
    dt = 0.2
    ev_lo = np.linalg.eigvalsh(H - 2 * H1)
    ev_hi = np.linalg.eigvalsh(H + 2 * H1)
    e_min = min(ev_lo[0], ev_hi[0]) - 1.0
    e_max = max(ev_lo[-1], ev_hi[-1]) + 1.0
    delta = e_max - e_min
    a = cheby_coeffs(delta, dt)
    tH, tH1 = torch.as_tensor(H), torch.as_tensor(H1)
    psi0 = torch.as_tensor(batch[0])

    def propagate_with_amp(amp):
        op = qt.Operator([tH, tH1], amp.reshape(1))
        return cheby_apply(op, psi0, a, delta, e_min, dt)

    def jax_propagate_with_amp(amp):
        op = qp.Operator([jnp.asarray(H), jnp.asarray(H1)], jnp.array([amp]))
        return jcheby_apply(op, jnp.asarray(batch[0]), jnp.asarray(a), delta,
                            e_min, dt)

    amps = np.linspace(-2, 2, 7)
    outs = torch.func.vmap(propagate_with_amp)(torch.as_tensor(amps))
    assert outs.shape == (7, 64)
    jouts = np.asarray(jax.vmap(jax_propagate_with_amp)(jnp.asarray(amps)))
    np.testing.assert_allclose(outs.numpy(), jouts, atol=1e-12, rtol=0)
    for i, amp in enumerate(amps):
        single = propagate_with_amp(torch.tensor(amp))
        np.testing.assert_allclose(outs[i].numpy(), single.numpy(),
                                   atol=1e-12, rtol=0)


def test_timings_counters(system):
    """``enable_timings`` records sections and the matvec counter (the
    reference's TimerOutputs behavior, test/test_timings.jl); the counts
    equal the JAX package's."""
    from quantumpropagators.utils import timings as jtimings

    H, evals, batch = system
    tlist = np.linspace(0, 1, 11)
    props = {}
    for pkg, arr, timings in [
        (qt, torch.as_tensor, (enable_timings, disable_timings,
                               timings_enabled)),
        (qp, jnp.asarray, (jtimings.enable_timings, jtimings.disable_timings,
                           jtimings.timings_enabled)),
    ]:
        enable, disable, enabled = timings
        gen = pkg.hamiltonian(arr(H), (arr(H), lambda t: 0.1 * np.sin(t)))
        psi0 = arr(batch[0])
        enable()
        try:
            assert enabled()
            prop = pkg.init_prop(psi0, gen, tlist, method="cheby")
            while prop.prop_step() is not None:
                pass
            assert prop.timing_data.calls["prop_step"] == 10
            assert prop.timing_data.counters["matvec"] > 100
            assert prop.timing_data.times["prop_step"] > 0
            assert "prop_step" in prop.timing_data.report()
            props[pkg.__name__] = prop
        finally:
            disable()
        prop2 = pkg.init_prop(psi0, gen, tlist, method="cheby")
        prop2.prop_step()
        assert prop2.timing_data.calls == {}
    assert (props["quantumpropagators_torch"].timing_data.counters
            == props["quantumpropagators"].timing_data.counters)
    np.testing.assert_allclose(
        np.asarray(props["quantumpropagators_torch"].state),
        np.asarray(props["quantumpropagators"].state), atol=1e-12, rtol=0)


@pytest.mark.parametrize("kind", ["lattice", "csr"])
def test_vmap_over_control_sets_structured(kind):
    """``torch.func.vmap`` over the drive amplitude of ``Operator([H_diag,
    H_1], [amp])`` with a site-sum or CSR drive term (both wrote the
    batched sum into an unbatched buffer before): each row equals its
    single call and ``jax.vmap`` of the JAX package (1e-12)."""
    import scipy.sparse as sp

    from quantumpropagators.ops.operators import csr_from_scipy as jcsr_sp

    L = 6
    td, tx = qt.transverse_field_ising(L, J=1.0, g=1.2, h=0.3,
                                       dtype=torch.complex128)
    jd, jx = qp.transverse_field_ising(L, J=1.0, g=1.2, h=0.3,
                                       dtype=jnp.complex128)
    if kind == "csr":
        A = sp.csr_matrix(np.asarray(qp.to_dense(jx)))
        tx, jx = qt.csr_from_scipy(A), jcsr_sp(A)
    bound = (L - 1) + 0.3 * L + 1.2 * L
    delta, e_min, dt = 2 * bound, -bound, 0.1
    a = cheby_coeffs(delta, dt)
    psi = random_state_vector(2 ** L, rng=np.random.default_rng(6))
    tpsi = torch.as_tensor(psi)

    def propagate_with_amp(amp):
        return cheby_apply(qt.Operator([td, tx], amp.reshape(1)), tpsi, a,
                           delta, e_min, dt)

    def jax_propagate_with_amp(amp):
        return jcheby_apply(qp.Operator([jd, jx], jnp.array([amp])),
                            jnp.asarray(psi), jnp.asarray(a), delta, e_min,
                            dt)

    amps = np.linspace(0.0, 1.0, 5)
    outs = torch.func.vmap(propagate_with_amp)(torch.as_tensor(amps))
    jouts = np.asarray(jax.vmap(jax_propagate_with_amp)(jnp.asarray(amps)))
    np.testing.assert_allclose(outs.numpy(), jouts, atol=1e-12, rtol=0)
    for i, amp in enumerate(amps):
        single = propagate_with_amp(torch.tensor(amp))
        np.testing.assert_allclose(outs[i].numpy(), single.numpy(),
                                   atol=1e-12, rtol=0)
