"""Port vs JAX package: the reference-accuracy layer (``ops/df64.py``,
``ops/df64_sparse.py``, ``ops/dd_linalg.py``), mirroring
``tests/test_dd_linalg.py:53-177``, ``tests/test_df64.py`` and
``tests/test_df64_sparse.py``.

The JAX package computes on double-float f32 planes; the port in
complex128.  The same seeded inputs go through both; JAX operators are
carried across with ``interop.from_jax`` (``hi + lo``).  Tolerances:
reductions ≤ 1e-13 relative, operator applies and the Arnoldi
Hessenberg ≤ 1e-12 relative, the Arnoldi basis orthonormal to 1e-13.
The JAX banded Pallas kernel runs in interpret mode at b = 8."""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch

from quantumpropagators.ops import dd_linalg as jdd
from quantumpropagators.ops import df64 as jdf
from quantumpropagators.ops import df64_sparse as jds
from quantumpropagators.ops.bsr_dd_pallas import (
    banded_dd_apply as jax_banded_apply,
    banded_dd_from_scipy as jax_banded_from_scipy,
)
from quantumpropagators.ops.cheby import cheby_coeffs
from quantumpropagators.ops.newton import _split_c128_planes as jsplit
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch.ops import dd_linalg as tdd
from quantumpropagators_torch.ops import df64 as tdf
from quantumpropagators_torch.ops import df64_sparse as tds
from quantumpropagators_torch.ops.bsr_dd import BandedDD

set_default_device("cpu")


def _jc(x):
    """A JAX CDD value (or DD pair) as host complex128."""
    if isinstance(x, jdf.CDD):
        return jdf.cdd_to_c128(x)
    return np.float64(x.hi) + np.float64(x.lo)


def _np(t):
    return t.detach().cpu().numpy()


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(
        np.asarray(want)).max()


# -- reductions --------------------------------------------------------------


def test_dd_sum_vs_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=1024) * np.exp(rng.normal(size=1024) * 4)
    xd = jdf.cdd_from_c128(x)
    want_jax = float(_jc(jdd.dd_sum(xd.re)))
    got = float(tdd.dd_sum(torch.as_tensor(x)))
    scale = np.abs(x).sum()
    assert abs(got - np.sum(x)) / scale < 1e-13
    assert abs(got - want_jax) / scale < 1e-13


def test_cdd_dot_and_norm_vs_jax():
    rng = np.random.default_rng(1)
    N = 1024
    x = rng.normal(size=N) + 1j * rng.normal(size=N)
    y = rng.normal(size=N) + 1j * rng.normal(size=N)
    xd, yd = jdf.cdd_from_c128(x), jdf.cdd_from_c128(y)
    want_jax = complex(_jc(jdd.cdd_dot(xd, yd)))
    xt, yt = tdf.cdd_from_c128(x), tdf.cdd_from_c128(y)
    got = complex(tdd.cdd_dot(xt, yt))
    assert abs(got - np.vdot(x, y)) / abs(np.vdot(x, y)) < 1e-13
    assert abs(got - want_jax) / abs(want_jax) < 1e-13
    nrm = float(tdd.cdd_norm(xt))
    assert abs(nrm - float(_jc(jdd.cdd_norm(xd)))) / nrm < 1e-13
    assert abs(float(tdd.cdd_norm_sq(xt)) - nrm ** 2) / nrm ** 2 < 1e-13


def test_dd_sqrt_div_and_converters():
    for v in (2.0, 3.14159, 1e-6, 123456.789):
        assert abs(float(tdd.dd_sqrt(v)) - np.sqrt(v)) < 1e-15 * max(1, v)
    assert abs(float(tdd.dd_div(tdf.DD(1.0), tdf.DD(7.0))) - 1 / 7) < 1e-16
    z = np.array([1.5 - 2j, 0.25 + 1e-9j])
    jz = jdf.cdd_from_c128(z)
    # the JAX pairs carried across equal hi + lo
    assert np.array_equal(_np(from_jax(jz)), jdf.cdd_to_c128(jz))
    assert np.array_equal(_np(from_jax(jz.re)), jdf.dd_to_f64(jz.re))
    assert np.array_equal(tdf.cdd_to_c128(tdf.cdd_from_c128(z)), z)
    assert tdf.CDD(z.real, z.imag).dtype == torch.complex128


# -- operators ---------------------------------------------------------------


def test_dense_apply_vs_jax():
    rng = np.random.default_rng(2)
    N = 96
    M = rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))
    v = rng.normal(size=N) + 1j * rng.normal(size=N)
    jop = jdd.dense_dd_from_numpy(M)
    want_jax = _jc(jdd.apply_cdd_op(jop, jdf.cdd_from_c128(v)))
    for op in (tdd.dense_dd_from_numpy(M), from_jax(jop)):
        got = _np(tdd.apply_cdd_op(op, tdf.cdd_from_c128(v)))
        assert _rel(got, M @ v) < 1e-12
        assert _rel(got, want_jax) < 1e-12


def test_sparse_complex_cddop_vs_jax():
    rng = np.random.default_rng(3)
    N = 320
    A = sp.random(N, N, density=0.05, random_state=7)
    A = (A + 1j * sp.random(N, N, density=0.05, random_state=8)).tocsr()
    v = rng.normal(size=N) + 1j * rng.normal(size=N)
    jop = jdd.cdd_op_from_matrix(A, sparse=True, block_size=8)
    want_jax = _jc(jdd.apply_cdd_op(jop, jdf.cdd_from_c128(v)))[:N]
    top = tdd.cdd_op_from_matrix(A, sparse=True, block_size=8)
    assert isinstance(top, tdd.CDDOp) and top.im is not None
    assert top.re.blocks.dtype == torch.float64
    for op in (top, from_jax(jop)):
        got = _np(tdd.apply_cdd_op(op, tdf.cdd_from_c128(v)))[:N]
        assert _rel(got, A @ v) < 1e-12
        assert _rel(got, want_jax) < 1e-12


def test_terms_op_vs_jax():
    rng = np.random.default_rng(4)
    N = 64
    H0 = rng.normal(size=(N, N))
    H1 = rng.normal(size=(N, N))
    v = rng.normal(size=N) + 1j * rng.normal(size=N)
    jterms = (jdd.dense_dd_from_numpy(H0), jdd.dense_dd_from_numpy(H1))
    tterms = (tdd.dense_dd_from_numpy(H0), tdd.dense_dd_from_numpy(H1))
    for c in (0.3, -1.7 + 0.2j):
        jop = jdd.TermsDDOp(terms=jterms,
                            coeffs4=jsplit(np.array([c], np.complex128)),
                            shape=(N, N))
        want_jax = _jc(jdd.apply_cdd_op(jop, jdf.cdd_from_c128(v)))
        top = tdd.TermsDDOp(terms=tterms, coeffs4=np.array([c]),
                            shape=(N, N))
        for op in (top, from_jax(jop)):
            got = _np(tdd.apply_cdd_op(op, tdf.cdd_from_c128(v)))
            assert _rel(got, (H0 + c * H1) @ v) < 1e-12
            assert _rel(got, want_jax) < 1e-12


def test_banded_term_vs_jax():
    """A real banded operator (b = 8, N not a multiple of 8): the port
    pads and unpads around the banded SpMV; the JAX reference runs its
    Pallas kernel in interpret mode on the padded state."""
    N = 77
    rng = np.random.default_rng(5)
    A = sp.diags([rng.normal(size=N - 9), rng.normal(size=N - 1),
                  rng.normal(size=N), rng.normal(size=N - 1),
                  rng.normal(size=N - 9)], [-9, -1, 0, 1, 9]).tocsr()
    v = rng.normal(size=N) + 1j * rng.normal(size=N)
    jb = jax_banded_from_scipy(A, block=8)
    n_pad = jb.R * jb.b
    assert n_pad > N
    vp = np.zeros(n_pad, complex)
    vp[:N] = v
    vd = jdf.cdd_from_c128(vp)
    want_jax = (_jc(jax_banded_apply(jb, vd.re, interpret=True))
                + 1j * _jc(jax_banded_apply(jb, vd.im, interpret=True)))[:N]
    tb = from_jax(jb)
    assert isinstance(tb, BandedDD)
    op = tdd.CDDOp(tb, None, (N, N))
    got = _np(tdd.apply_cdd_op(op, tdf.cdd_from_c128(v)))
    assert got.shape == (N,)
    assert _rel(got, A @ v) < 1e-12
    assert _rel(got, want_jax) < 1e-12
    # two banded terms with coefficients
    top = tdd.TermsDDOp(terms=(op, op), coeffs4=np.array([0.5 - 0.25j]))
    got2 = _np(tdd.apply_cdd_op(top, tdf.cdd_from_c128(v)))
    assert _rel(got2, (1.5 - 0.25j) * (A @ v)) < 1e-12


# -- Arnoldi -----------------------------------------------------------------


def test_arnoldi_dd_vs_jax():
    rng = np.random.default_rng(5)
    N, m = 128, 15
    M = rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))
    H = M + M.conj().T
    v = rng.normal(size=N) + 1j * rng.normal(size=N)
    v /= np.linalg.norm(v)
    Hj, _, mj = jdd.arnoldi_dd(jdd.dense_dd_from_numpy(H),
                               jdf.cdd_from_c128(v), m, 0.25)
    Hs, q, m_eff = tdd.arnoldi_dd(tdd.dense_dd_from_numpy(H),
                                  tdf.cdd_from_c128(v), m, 0.25)
    assert m_eff == mj == m
    qq = _np(q[:m])
    assert np.abs(qq @ qq.conj().T - np.eye(m)).max() < 1e-13
    scale = np.abs(Hs[:m, :m]).max()
    assert np.abs(Hs[:m + 1, :m] - Hj[:m + 1, :m]).max() / scale < 1e-12
    Hrec = qq.conj() @ (0.25 * H @ qq.T)
    assert np.abs(Hrec - Hs[:m, :m]).max() / scale < 1e-12


def test_arnoldi_dd_breakdown_eigenvector():
    rng = np.random.default_rng(6)
    N = 48
    M = rng.normal(size=(N, N))
    H = M + M.T
    w, V = np.linalg.eigh(H)
    Hs, _, m_eff = tdd.arnoldi_dd(tdd.dense_dd_from_numpy(H),
                                  tdf.cdd_from_c128(V[:, 3] + 0j), 8, 0.5)
    assert m_eff == 1
    assert abs(Hs[0, 0] / 0.5 - w[3]) < 1e-11


# -- Chebyshev over the complex128 layer ------------------------------------


def _dense_tfim(L, J, g, h):
    X = np.array([[0, 1], [1, 0]], float)
    Z = np.diag([1.0, -1.0])

    def site(op, i):
        out = np.eye(1)
        for k in range(L):
            out = np.kron(out, op if k == i else np.eye(2))
        return out

    H = sum(J * site(Z, i) @ site(Z, i + 1) for i in range(L - 1))
    return H + sum(h * site(Z, i) + g * site(X, i) for i in range(L))


def test_cheby_apply_dd_vs_jax():
    """One flip-structured step at L = 8 (the flip kernel's plain version
    on the CPU), with per-site flip coefficients, against the JAX dd
    step and expm at 1e-12."""
    L = 8
    H = _dense_tfim(L, 1.0, 0.0, 0.3)
    gs = np.linspace(0.9, 1.3, L)
    X = np.array([[0, 1], [1, 0]], float)
    for k, gk in enumerate(gs):
        op = np.eye(1)
        for i in range(L):
            op = np.kron(op, X if i == k else np.eye(2))
        H = H + gk * op
    diag = np.diag(H).copy()
    evals = np.linalg.eigvalsh(H)
    e_min, delta = float(evals[0]) - 0.3, float(evals[-1] - evals[0]) + 0.5
    dt = 0.2
    rng = np.random.default_rng(3)
    psi = rng.normal(size=2 ** L) + 1j * rng.normal(size=2 ** L)
    psi /= np.linalg.norm(psi)
    coeffs = cheby_coeffs(delta, dt)
    want_jax = jdf.cdd_to_c128(jdf.cheby_apply_dd(
        jdf.cdd_from_c128(psi), jdf.dd_from_f64(diag), list(gs), coeffs,
        delta, e_min, dt, L=L))
    got = tdf.cdd_to_c128(tdf.cheby_apply_dd(
        tdf.cdd_from_c128(psi), tdf.dd_from_f64(diag), list(gs), coeffs,
        delta, e_min, dt, L=L))
    exact = scipy.linalg.expm(-1j * H * dt) @ psi
    assert np.abs(got - exact).max() < 1e-12
    assert np.abs(got - want_jax).max() < 1e-12


def test_dd_bsr_cheby_beta_nonzero_vs_jax():
    """The generic-envelope case (β = Δ/2 + E_min ≠ 0) of
    ``tests/test_df64_sparse.py:121``: the global phase is kept."""
    rng = np.random.default_rng(9)
    N = 32
    M0 = rng.normal(size=(N, N))
    H = M0 + M0.T
    psi = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi /= np.linalg.norm(psi)
    evals = np.linalg.eigvalsh(H)
    e_min = float(evals[0] - 0.5)
    delta = float(evals[-1] + 0.5 - e_min)
    dt = 0.05
    assert abs(delta / 2 + e_min) > 0.05
    c = cheby_coeffs(delta, dt)
    jop = jds.bsr_dd_from_scipy(sp.csr_matrix(H), block_size=8)
    want_jax = jdf.cdd_to_c128(jds.cheby_apply_dd_bsr(
        jop, jdf.cdd_from_c128(psi), c, delta, e_min, dt))
    want = scipy.linalg.expm(-1j * dt * H) @ psi
    for op in (tds.bsr_dd_from_scipy(sp.csr_matrix(H), block_size=8),
               from_jax(jop)):
        assert isinstance(op, tds.BSRdd) and op.blocks.dtype == torch.float64
        got = tdf.cdd_to_c128(tds.cheby_apply_dd_bsr(
            op, tdf.cdd_from_c128(psi), c, delta, e_min, dt))
        assert np.abs(got - want).max() < 1e-13
        assert np.abs(got - want_jax).max() < 1e-13
    # the recurrence over a callable, coefficients split as in JAX
    top = tds.bsr_dd_from_scipy(sp.csr_matrix(H), block_size=8)
    hi = c.astype(np.float32)
    got = tdf.cdd_to_c128(tds.cheby_dd_recurrence(
        lambda v: tds.bsr_apply_dd(top, v), tdf.cdd_from_c128(psi), hi,
        c - hi.astype(np.float64), delta, e_min, dt, True))
    assert np.abs(got - want).max() < 1e-13


def test_dd_bsr_padded_transmon_many_steps():
    """``tests/test_df64_sparse.py``'s transmon ladder at block size 2 on
    a padded state (N = 10 → 10), 30 steps, against expm at 1e-12."""
    N = 10
    a = sp.diags(np.sqrt(np.arange(1, N, dtype=float)), 1).tocsr()
    ad = a.conj().T.tocsr()
    n_op = (ad @ a).tocsr()
    H = (6.0 * n_op - 0.1 * (n_op @ (n_op - sp.identity(N)))
         + 0.3 * (a + ad)).tocsr()
    H = (0.5 * (H + H.T)).tocsr()
    op = tds.bsr_dd_from_scipy(H, block_size=4)
    Np = op.shape[0]
    assert Np == 12
    evals = np.linalg.eigvalsh(H.toarray())
    e_min, delta = float(evals[0]), float(evals[-1] - evals[0])
    dt = 0.1
    z = torch.zeros(Np, dtype=torch.complex128)
    z[0] = 1.0
    c = cheby_coeffs(delta, dt)
    for _ in range(30):
        z = tds.cheby_apply_dd_bsr(op, z, c, delta, e_min, dt)
    exact = scipy.linalg.expm(-1j * H.toarray() * dt * 30)[:, 0]
    assert np.abs(_np(z)[:N] - exact).max() < 1e-12
    assert np.abs(_np(z)[N:]).max() == 0.0
