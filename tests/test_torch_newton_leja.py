"""Port vs JAX package: fixed-Leja Newton propagation
(``ops/newton_leja.py`` and ``propagate(..., fused=True,
method="newton_leja")``), mirroring ``tests/test_dd_linalg.py:473-561``.

The plan is pure numpy and must equal the JAX plan (points and radius
exactly, the certified error within 1e-15).  Propagations are held
against the per-interval ``expm`` oracle and the JAX result at 1e-11,
the backward round trip at 1e-11, and the fused entry point against
the port's Chebyshev propagation at 1e-10.  A static
:class:`BSROperator` of block 8 takes the banded route (band planes and
the banded SpMV's plain version on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.models.controls import discretize_on_midpoints
from quantumpropagators.ops.df64 import cdd_to_c128 as jax_c128
from quantumpropagators.ops.newton_leja import (
    newton_leja_plan as jax_plan,
    newton_leja_propagate_dd as jax_leja,
)
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch.ops import banded_spmv as bs
from quantumpropagators_torch.ops.newton_leja import (
    newton_leja_plan,
    newton_leja_propagate_dd,
)

set_default_device("cpu")


@pytest.mark.parametrize("e_min, e_max, dt", [(-12.0, 12.0, 0.25),
                                              (-48.0, 48.0, 0.25),
                                              (-3.1, 17.4, -0.07)])
def test_plan_equals_jax(e_min, e_max, dt):
    plan = newton_leja_plan(e_min, e_max, dt, tol=1e-13)
    ref = jax_plan(e_min, e_max, dt, tol=1e-13)
    assert np.array_equal(plan.points, ref.points)
    assert plan.radius == ref.radius
    assert (plan.a, plan.b) == (ref.a, ref.b)
    assert abs(plan.sup_error - ref.sup_error) <= 1e-15
    assert plan.sup_error < 1e-13
    # the JAX coefficients are hi/lo f32 planes of the same values
    c = ref.coeffs4.astype(np.float64)
    want = (c[0] + c[1]) + 1j * (c[2] + c[3])
    assert np.abs(plan.coeffs4 - want).max() <= 1e-14 * np.abs(want).max()


def _driven(N, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    M0 = rng.normal(size=(N, N))
    M1 = rng.normal(size=(N, N))
    H0, H1 = M0 + M0.T, scale * (M1 + M1.T)
    psi0 = rng.normal(size=N) + 1j * rng.normal(size=N)
    return H0, H1, psi0 / np.linalg.norm(psi0)


def test_driven_vs_oracle_and_jax():
    N = 48
    H0, H1, psi0 = _driven(N, 22)
    ctrl = lambda t: np.sin(2 * t)
    jgen = qp.hamiltonian(jnp.asarray(H0, dtype=complex),
                          (jnp.asarray(H1, dtype=complex), ctrl))
    tlist = np.linspace(0, 1.0, 41)
    out, _, plan = newton_leja_propagate_dd(
        torch.as_tensor(psi0), from_jax(jgen), tlist, tol=1e-13)
    assert out.dtype == torch.complex128
    assert plan.sup_error < 1e-13
    # each package estimates its own envelope (a random Arnoldi start)
    jout, _, _ = jax_leja(jnp.asarray(psi0), jgen, tlist, tol=1e-13)
    vals = discretize_on_midpoints(ctrl, tlist)
    psi = psi0.copy()
    for n in range(len(tlist) - 1):
        psi = scipy.linalg.expm(
            -1j * (tlist[n + 1] - tlist[n]) * (H0 + vals[n] * H1)) @ psi
    got = out.numpy()
    assert np.abs(got - psi).max() < 1e-11
    assert np.abs(got - jax_c128(jout)).max() < 1e-11


def test_backward_roundtrip():
    N = 32
    H0, _, psi0 = _driven(N, 23)
    gen = qt.hamiltonian(torch.as_tensor(H0, dtype=torch.complex128))
    tlist = np.linspace(0, 0.8, 17)
    fwd, _, _ = newton_leja_propagate_dd(torch.as_tensor(psi0), gen, tlist)
    back, _, _ = newton_leja_propagate_dd(fwd, gen, tlist, backward=True)
    assert np.abs(back.numpy() - psi0).max() < 1e-11


def test_via_propagate_fused():
    """method='newton_leja' through the public propagate API, with
    observable streaming and stored states, against the port's cheby."""
    N = 32
    H0, H1, psi0 = _driven(N, 24)
    gen = qt.hamiltonian(torch.as_tensor(H0, dtype=torch.complex128),
                         (torch.as_tensor(H1, dtype=torch.complex128),
                          lambda t: np.cos(3 * t)))
    tlist = np.linspace(0, 0.6, 13)
    psi0 = torch.as_tensor(psi0)
    ref = qt.propagate(psi0, gen, tlist, method="cheby")
    got = qt.propagate(psi0, gen, tlist, method="newton_leja", fused=True)
    assert got.dtype == torch.complex128 and got.shape == psi0.shape
    assert np.abs(got.numpy() - ref.numpy()).max() < 1e-10
    n_op = torch.as_tensor(np.diag(np.arange(N, dtype=float)),
                           dtype=torch.complex128)
    store = qt.propagate(psi0, gen, tlist, method="newton_leja", fused=True,
                         storage=True, observables=[n_op])
    ref_store = qt.propagate(psi0, gen, tlist, method="cheby", storage=True,
                             observables=[n_op])
    assert store.shape == (len(tlist),)
    assert np.abs(np.asarray(store) - np.asarray(ref_store)).max() < 1e-10
    states = qt.propagate(psi0, gen, tlist, method="newton_leja", fused=True,
                          storage=True)
    assert states.shape == (N, len(tlist))
    assert np.abs(states[:, -1] - got.numpy()).max() == 0.0
    back = qt.propagate(got, gen, tlist, method="newton_leja", fused=True,
                        backward=True, storage=True, observables=[n_op])
    assert np.abs(np.asarray(back) - np.asarray(ref_store)).max() < 1e-10


@pytest.mark.parametrize("N", [96, 90])
def test_static_bsr_banded_route(N):
    """A real banded BSROperator of block 8 becomes band planes: every
    Leja node of every step is one banded product (the plain version on
    the CPU; the state is padded once when 8 does not divide N).  Held
    against expm and the JAX package's blocked-ELL route."""
    rng = np.random.default_rng(25)
    A = sp.diags([rng.normal(size=N - 8), rng.normal(size=N - 1),
                  rng.normal(size=N), rng.normal(size=N - 1),
                  rng.normal(size=N - 8)], [-8, -1, 0, 1, 8]).tocsr()
    A = (0.5 * (A + A.T)).tocsr()
    psi0 = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi0 /= np.linalg.norm(psi0)
    tlist = np.linspace(0, 0.5, 6)
    evals = np.linalg.eigvalsh(A.toarray())
    e_min, e_max = float(evals[0]) - 0.2, float(evals[-1]) + 0.1
    op = qt.bsr_from_scipy(A, block_size=8)
    calls = []
    plain = bs.banded_spmv_plain

    def counted(planes, offsets, x, halo=None):
        calls.append(x.numel())
        return plain(planes, offsets, x, halo)

    bs.banded_spmv_plain = counted
    try:
        got, _, plan = newton_leja_propagate_dd(
            torch.as_tensor(psi0), op, tlist, e_min=e_min, e_max=e_max)
    finally:
        bs.banded_spmv_plain = plain
    n_rows = -(-N // 8) * 8
    assert calls == [n_rows] * (5 * (len(plan.points) - 1))
    exact = scipy.linalg.expm(-0.5j * A.toarray()) @ psi0
    assert got.shape == (N,)
    assert np.abs(got.numpy() - exact).max() < 1e-11
    jout, _, _ = jax_leja(jnp.asarray(psi0),
                          qp.bsr_from_scipy(A, block_size=8), tlist,
                          e_min=e_min, e_max=e_max)
    assert np.abs(got.numpy() - jax_c128(jout)).max() < 1e-11
