"""Port vs JAX package: the planar ``(re, im)`` Chebyshev path (every
case of ``test_planar.py`` on both packages, L = 8; 1e-12 per apply and
step, 1e-11 over 20 steps, 1e-10 against ``expm``, as there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.ops import planar as jplanar
from quantumpropagators.ops.cheby import cheby_apply as jcheby_apply
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.ops import planar as tplanar
from quantumpropagators_torch.ops.cheby import cheby_apply, cheby_coeffs

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")

L = 8


@pytest.fixture(scope="module")
def tfim():
    """The JAX test's chain on both packages, and its seeded state."""
    jd, jx = qp.transverse_field_ising(L, J=1.0, g=1.2, h=0.3,
                                       dtype=jnp.float64)
    td, tx = qt.transverse_field_ising(L, J=1.0, g=1.2, h=0.3,
                                       dtype=torch.float64)
    jop = qp.Operator([jd, jx.grouped(4)], np.array([1.0]))
    top = qt.Operator([td, tx.grouped(4)], np.array([1.0]))
    bound = 1.0 * (L - 1) + 0.3 * L + 1.2 * L
    rng = np.random.default_rng(7)
    psi = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi /= np.linalg.norm(psi)
    return jop, top, psi, -bound, 2 * bound


def _planes(psi):
    return torch.as_tensor(psi.real), torch.as_tensor(psi.imag)


def _joined(planes):
    re, im = planes
    return np.asarray(re) + 1j * np.asarray(im)


def test_is_real_linear(tfim):
    jop, top, _, _, _ = tfim
    for op, j in [(top, jop), (top.ops[0], jop.ops[0]),
                  (top.ops[1], jop.ops[1])]:
        assert tplanar.is_real_linear(op) and jplanar.is_real_linear(j)
    assert not tplanar.is_real_linear(torch.eye(4, dtype=torch.complex128))
    assert not jplanar.is_real_linear(jnp.eye(4, dtype=jnp.complex128))
    assert tplanar.is_real_linear(torch.eye(4, dtype=torch.float64))
    assert tplanar.is_real_linear(np.eye(4))
    assert jplanar.is_real_linear(jnp.eye(4))
    # complex coefficients or a complex term make a sum complex-linear
    cop = qt.Operator(top.ops, np.array([1.0j]))
    assert not tplanar.is_real_linear(cop)
    assert not jplanar.is_real_linear(qp.Operator(jop.ops, np.array([1.0j])))
    assert not tplanar.is_real_linear(
        qt.ScaledOperator(2.0j, top.ops[0]))
    assert tplanar.is_real_linear(qt.ScaledOperator(
        torch.tensor(2.0, dtype=torch.float64), top.ops[0]))


def test_apply_planar_matches_complex(tfim):
    jop, top, psi, _, _ = tfim
    got = _joined(tplanar.apply_planar(top, *_planes(psi)))
    want = _joined(jplanar.apply_planar(jop, jnp.asarray(psi.real),
                                        jnp.asarray(psi.imag)))
    ref = np.asarray(qt.apply(top, torch.as_tensor(psi)))
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)


def test_apply_planar_fallback_complex_operator():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))
    psi = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    got = _joined(tplanar.apply_planar(torch.as_tensor(A), *_planes(psi)))
    want = _joined(jplanar.apply_planar(jnp.asarray(A), jnp.asarray(psi.real),
                                        jnp.asarray(psi.imag)))
    np.testing.assert_allclose(got, A @ psi, atol=1e-12, rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


@pytest.mark.parametrize("forward", [True, False])
def test_cheby_planar_vs_expm(tfim, forward):
    jop, top, psi, e_min, delta = tfim
    dt = 0.1 if forward else -0.1
    coeffs = cheby_coeffs(delta, dt)
    got = _joined(tplanar.cheby_apply_planar(
        top, *_planes(psi), coeffs, delta, e_min, dt, forward=forward))
    want = _joined(jplanar.cheby_apply_planar(
        jop, jnp.asarray(psi.real), jnp.asarray(psi.imag),
        jnp.asarray(coeffs), delta, e_min, dt, forward=forward))
    H = np.asarray(qt.to_dense(top))
    exact = expm(-1j * H * dt) @ psi
    assert np.linalg.norm(got - exact) < 1e-10
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


def test_cheby_planar_matches_complex_kernel(tfim):
    jop, top, psi, e_min, delta = tfim
    dt = 0.07
    coeffs = cheby_coeffs(delta, dt)
    got = _joined(tplanar.cheby_apply_planar(
        top, *_planes(psi), coeffs, delta, e_min, dt))
    ref = cheby_apply(top, torch.as_tensor(psi), coeffs, delta, e_min,
                      dt).numpy()
    jref = np.asarray(jcheby_apply(jop, jnp.asarray(psi), jnp.asarray(coeffs),
                                   delta, e_min, dt))
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)
    np.testing.assert_allclose(got, jref, atol=1e-12, rtol=0)


def test_cheby_planar_multi_step_norm(tfim):
    """20 planar steps keep the norm and match 20 complex steps, and
    the JAX package's 20 planar steps."""
    jop, top, psi, e_min, delta = tfim
    dt = 0.05
    coeffs = cheby_coeffs(delta, dt)
    re, im = _planes(psi)
    jre, jim = jnp.asarray(psi.real), jnp.asarray(psi.imag)
    z = torch.as_tensor(psi)
    for _ in range(20):
        re, im = tplanar.cheby_apply_planar(top, re, im, coeffs, delta,
                                            e_min, dt)
        jre, jim = jplanar.cheby_apply_planar(
            jop, jre, jim, jnp.asarray(coeffs), delta, e_min, dt)
        z = cheby_apply(top, z, coeffs, delta, e_min, dt)
    got = _joined((re, im))
    assert abs(np.linalg.norm(got) - 1.0) < 1e-11
    np.testing.assert_allclose(got, z.numpy(), atol=1e-11, rtol=0)
    np.testing.assert_allclose(got, _joined((jre, jim)), atol=1e-11, rtol=0)


@pytest.mark.parametrize("kind", ["site_sum", "csr", "dia", "scaled"])
def test_apply_planar_other_real_operators(tfim, kind):
    """The planar branches the chain above does not take, against the
    JAX package on the same matrices (1e-12)."""
    jop, top, psi, _, _ = tfim
    jd, jx = jop.ops
    td, tx = top.ops
    site_t, site_j = qt.transverse_field_ising(
        L, g=0.7, dtype=torch.float64)[1], qp.transverse_field_ising(
        L, g=0.7, dtype=jnp.float64)[1]
    A = np.asarray(qp.to_dense(site_j)).real
    import scipy.sparse as sp

    from quantumpropagators.ops.operators import csr_from_scipy as jcsr
    from quantumpropagators.ops.operators import dia_from_scipy as jdia

    t_op, j_op = {
        "site_sum": (site_t, site_j),
        "csr": (qt.csr_from_scipy(sp.csr_matrix(A)),
                jcsr(sp.csr_matrix(A))),
        "dia": (qt.dia_from_scipy(sp.diags([np.arange(2.0 ** L)], [0])
                                  + sp.eye(2 ** L, k=3)),
                jdia(sp.diags([np.arange(2.0 ** L)], [0])
                     + sp.eye(2 ** L, k=3))),
        "scaled": (qt.ScaledOperator(-0.5, td), qp.ScaledOperator(-0.5, jd)),
    }[kind]
    assert tplanar.is_real_linear(t_op) and jplanar.is_real_linear(j_op)
    got = _joined(tplanar.apply_planar(t_op, *_planes(psi)))
    want = _joined(jplanar.apply_planar(j_op, jnp.asarray(psi.real),
                                        jnp.asarray(psi.imag)))
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    ref = qt.apply(t_op, torch.as_tensor(psi)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)
