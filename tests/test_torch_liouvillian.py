"""Port vs JAX package: Liouvillian construction and open-system
dynamics (the cases of ``test_liouvillian.py`` that
``test_torch_models.py::test_liouvillian_equal`` does not hold;
reference ``test/test_liouvillian.jl``), on both packages with the JAX
test's tolerances, and the two packages' results equal (1e-12)."""

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.ops import operators as jops
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.ops import operators as tops

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")

SM = np.array([[0, 1], [0, 0]], dtype=complex)  # sigma_minus |0><1|
PACKAGES = [(qt, torch.as_tensor, tops), (qp, jnp.asarray, jops)]


def vec(rho):
    """Column-stacking vectorization (Fortran order)."""
    return np.asarray(rho).reshape(-1, order="F")


def unvec(v, n):
    return np.asarray(v).reshape((n, n), order="F")


def _dense(ops, L):
    return np.asarray(ops.to_dense(L))


def test_convention_factor():
    H = np.array([[1, 0], [0, -1]], dtype=complex)
    for pkg, arr, ops in PACKAGES:
        L_tdse = pkg.liouvillian(arr(H), [], convention="TDSE")
        L_lvn = pkg.liouvillian(arr(H), [], convention="LvN")
        assert np.allclose(1j * _dense(ops, L_tdse), _dense(ops, L_lvn))


def test_tls_decay():
    """Spontaneous decay: rho_11(t) = exp(-gamma t) rho_11(0), trace
    kept, through Newton on both packages."""
    gamma = 0.5
    H = 0.5 * np.array([[1, 0], [0, -1]], dtype=complex)
    rho0 = np.array([[0, 0], [0, 1]], dtype=complex)
    tlist = np.linspace(0, 5, 101)
    results = []
    for pkg, arr, _ in PACKAGES:
        L = pkg.liouvillian(arr(H), [arr(np.sqrt(gamma) * SM)],
                            convention="TDSE")
        states = np.asarray(pkg.propagate(arr(vec(rho0)), L, tlist,
                                          method="newton", storage=True,
                                          check=False))
        pops = np.array([unvec(states[:, i], 2)[1, 1].real
                         for i in range(len(tlist))])
        assert np.max(np.abs(pops - np.exp(-gamma * tlist))) < 1e-8
        traces = np.array([np.trace(unvec(states[:, i], 2)).real
                           for i in range(len(tlist))])
        assert np.max(np.abs(traces - 1.0)) < 1e-8
        results.append(states)
    np.testing.assert_allclose(results[0], results[1], atol=1e-12, rtol=0)


def test_lvn_action():
    """LvN: ``L ρ⃗ = vec(+i[H,ρ] + D(ρ))``; TDSE: ``L ρ⃗ = vec([H,ρ]) +
    i vec(D(ρ))`` (reference ``test/test_liouvillian.jl:96-103``)."""
    gamma = 0.3
    H = np.array([[0.7, 0.2], [0.2, -0.7]], dtype=complex)
    c_op = np.sqrt(gamma) * SM
    rho0 = np.array([[0.25, 0.1], [0.1, 0.75]], dtype=complex)
    D = (c_op @ rho0 @ c_op.conj().T
         - 0.5 * (c_op.conj().T @ c_op @ rho0 + rho0 @ c_op.conj().T @ c_op))
    for pkg, arr, ops in PACKAGES:
        L_lvn = _dense(ops, pkg.liouvillian(arr(H), [arr(c_op)],
                                            convention="LvN"))
        assert np.allclose(unvec(L_lvn @ vec(rho0), 2),
                           1j * (H @ rho0 - rho0 @ H) + D, atol=1e-14)
        L_tdse = _dense(ops, pkg.liouvillian(arr(H), [arr(c_op)],
                                             convention="TDSE"))
        assert np.allclose(unvec(L_tdse @ vec(rho0), 2),
                           (H @ rho0 - rho0 @ H) + 1j * D, atol=1e-14)


def test_liouvillian_stays_sparse_large():
    """A 2^6-dim sparse H gives a 2^12-dim superoperator built through
    sparse kron in both packages, with the same action on a random ρ."""
    rng = np.random.default_rng(7)
    N = 64
    main = rng.normal(size=N)
    off = rng.normal(size=N - 1) + 1j * rng.normal(size=N - 1)
    H_sp = sp.diags([off.conj(), main, off], [-1, 0, 1]).tocsr()
    A_sp = sp.diags([np.sqrt(np.arange(1, N, dtype=float))], [1]).tocsr()
    rho = rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))
    rho = 0.5 * (rho + rho.conj().T)
    Hd, Ad = H_sp.toarray(), A_sp.toarray()
    rhs = 1j * (Hd @ rho - rho @ Hd) + (
        Ad @ rho @ Ad.conj().T
        - 0.5 * (Ad.conj().T @ Ad @ rho + rho @ Ad.conj().T @ Ad))
    results = []
    for pkg, arr, ops in PACKAGES:
        L = pkg.liouvillian(ops.csr_from_scipy(H_sp),
                            [ops.csr_from_scipy(A_sp)], convention="LvN")
        assert isinstance(L, ops.CSROperator)
        assert L.nnz < 40 * N * H_sp.nnz
        got = np.asarray(pkg.apply(L, arr(vec(rho))))
        assert np.allclose(got, vec(rhs), atol=1e-12)
        results.append(got)
    np.testing.assert_allclose(results[0], results[1], atol=1e-12, rtol=0)


def test_to_scipy_sparse_roundtrips():
    """to_scipy_sparse of every operator container equals its dense
    form, and the two packages' matrices are equal."""
    rng = np.random.default_rng(3)
    N = 17
    D = sp.diags(
        [rng.normal(size=N - 2), rng.normal(size=N), rng.normal(size=N - 3)],
        [-2, 0, 3],
    ).tocsr()
    diag = rng.normal(size=N)
    mats = []
    for pkg, arr, ops in PACKAGES:
        got = []
        for op in (ops.csr_from_scipy(D), ops.dia_from_scipy(D),
                   ops.DiagonalOperator(arr(diag)), arr(D.toarray())):
            A = ops.to_scipy_sparse(op).toarray()
            assert np.allclose(A, np.asarray(ops.to_dense(op)), atol=1e-14)
            got.append(A)
        mats.append(got)
    for a, b in zip(*mats):
        np.testing.assert_array_equal(a, b)
