"""Port vs JAX package: ``apply`` / ``op_dot`` / ``to_dense`` of every
ported operator type on random states, at 1e-12 (L ≤ 11)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.models import lattice as jlat
from quantumpropagators_torch.interop import from_jax, to_numpy
from quantumpropagators_torch.models import lattice as tlat
from quantumpropagators_torch.ops import operators as tops
from quantumpropagators_torch import set_default_device

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")

TOL = 1e-12


def _state(N, seed, batch=()):
    rng = np.random.default_rng(seed)
    shape = batch + (N,)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _jax_ops():
    """(name, JAX operator) pairs covering each ported operator type."""
    rng = np.random.default_rng(0)
    N = 64
    dense = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    S = sp.random(N, N, density=0.1, random_state=1, format="csr")
    S = S + 1j * sp.random(N, N, density=0.05, random_state=2, format="csr")
    Hd, Hx = qp.transverse_field_ising(9, J=1.0, g=1.2, h=0.3,
                                       dtype=jnp.complex128)
    Hd2, Hx2 = qp.transverse_field_ising_2d(3, 3, J=0.7, g=0.9, h=-0.2,
                                            periodic=True,
                                            dtype=jnp.complex128)
    mats = rng.standard_normal((6, 2, 2)) + 1j * rng.standard_normal((6, 2, 2))
    site = jlat.SiteOperatorSum(jnp.asarray(mats), L=6,
                                active=(True, False, True, True, False, True))
    return [
        ("dense", jnp.asarray(dense)),
        ("diagonal", qp.DiagonalOperator(jnp.asarray(rng.standard_normal(N)))),
        ("csr", qp.csr_from_scipy(S)),
        ("csr_dense", qp.csr_from_dense(dense, tol=1.0)),
        ("site_sum_general", site),
        ("grouped", site.grouped(3)),
        ("tfim_diag", Hd),
        ("tfim_x", Hx),
        ("tfim_x_grouped", Hx.grouped(4)),
        ("tfim2d_diag", Hd2),
        ("tfim2d_x", Hx2),
        ("operator", qp.Operator([Hd, Hx], np.array([0.8]))),
    ]


@pytest.mark.parametrize("name, jop", _jax_ops(), ids=lambda x: x
                         if isinstance(x, str) else "")
def test_apply_op_dot_to_dense(name, jop):
    top = from_jax(jop)
    N = qp.ops.operators.op_shape(jop)[0]
    psi = _state(N, 3)
    phi = _state(N, 4)
    want = np.asarray(qp.apply(jop, jnp.asarray(psi)))
    got = to_numpy(qt.apply(top, torch.as_tensor(psi)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    e_j = complex(qp.op_dot(jnp.asarray(phi), jop, jnp.asarray(psi)))
    e_t = complex(qt.op_dot(torch.as_tensor(phi), top, torch.as_tensor(psi)))
    assert abs(e_j - e_t) < TOL * max(1.0, abs(e_j))
    np.testing.assert_allclose(to_numpy(qt.to_dense(top)),
                               np.asarray(qp.to_dense(jop)), rtol=0, atol=TOL)
    # batched states: Hilbert dimension on the last axis
    batch = _state(N, 5, batch=(3,))
    np.testing.assert_allclose(
        to_numpy(qt.apply(top, torch.as_tensor(batch))),
        np.asarray(qp.apply(jop, jnp.asarray(batch))), rtol=0, atol=TOL,
    )


@pytest.mark.parametrize("L", [10, 11])
def test_tfim_constructors_equal(L):
    """Constructing in the port gives the operators the JAX package builds
    (MSB-first: site i is index bit L-1-i)."""
    jd, jx = qp.transverse_field_ising(L, J=1.0, g=1.2, h=0.3,
                                       periodic=L == 11, dtype=jnp.complex128)
    td, tx = qt.transverse_field_ising(L, J=1.0, g=1.2, h=0.3,
                                       periodic=L == 11,
                                       dtype=torch.complex128)
    np.testing.assert_array_equal(td.diag.numpy(), np.asarray(jd.diag))
    np.testing.assert_array_equal(tx.site_mats.numpy(),
                                  np.asarray(jx.site_mats))
    psi = _state(2 ** L, L)
    op_j = qp.Operator([jd, jx], np.array([1.0]))
    op_t = qt.Operator([td, tx], np.array([1.0]))
    np.testing.assert_allclose(
        qt.apply(op_t, torch.as_tensor(psi)).numpy(),
        np.asarray(qp.apply(op_j, jnp.asarray(psi))), rtol=0, atol=TOL,
    )
    bonds = tlat.chain_bonds(L, periodic=True)
    assert bonds == jlat.chain_bonds(L, periodic=True)
    np.testing.assert_array_equal(
        tlat.ising_diagonal_np(L, bonds, 0.7, [0.1 * i for i in range(L)]),
        jlat.ising_diagonal_np(L, bonds, 0.7, [0.1 * i for i in range(L)]),
    )
    assert tlat.lattice2d_bonds(3, 4, True) == jlat.lattice2d_bonds(3, 4, True)


def test_site_x_is_bit_flip():
    """X on site i flips index bit L-1-i."""
    L = 5
    mats = np.zeros((L, 2, 2))
    mats[1] = [[0, 1], [1, 0]]
    op = tlat.SiteOperatorSum(torch.as_tensor(mats), L=L)
    e = torch.zeros(2 ** L, dtype=torch.complex128)
    e[3] = 1
    out = op.apply(e)
    assert out[3 ^ (1 << (L - 2))] == 1 and out.abs().sum() == 1


def test_host_structural_helpers_equal():
    rng = np.random.default_rng(9)
    A = sp.random(16, 16, density=0.2, random_state=3, format="csr")
    B = rng.standard_normal((16, 16))
    ta, tb = tops.csr_from_scipy(A), torch.as_tensor(B)
    ja, jb = qp.csr_from_scipy(A), jnp.asarray(B)
    s_t = tops.add_operators(ta, tops.scale_operator(0.5, ta))
    s_j = qp.ops.operators.add_operators(ja,
                                         qp.ops.operators.scale_operator(0.5, ja))
    np.testing.assert_allclose(tops.to_scipy_sparse(s_t).toarray(),
                               qp.ops.operators.to_scipy_sparse(s_j).toarray())
    d = tops.add_operators(tops.DiagonalOperator(torch.ones(16)),
                           tops.DiagonalOperator(torch.arange(16.0)))
    np.testing.assert_array_equal(d.diag.numpy(), 1 + np.arange(16.0))
    np.testing.assert_allclose(tops.add_operators(tb, tb).numpy(), 2 * B)
    assert tops.is_operator(tb) and tops.is_operator(B)
    assert not tops.is_operator(torch.ones(4))
    assert tops.op_shape(ta) == (16, 16)
    assert tops.op_device(ta) == torch.device("cpu")
    with pytest.raises(TypeError, match="does not implement"):
        tops.apply(object(), torch.ones(4))
