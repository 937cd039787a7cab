"""Port vs JAX package: Krylov ``expv`` (``ops/expv.py``), the dense
exponential (``ops/expprop.py``), the DP5(4) integrator (``ops/ode.py``)
and the ``newton``, ``krylov``/``expv``, ``expprop`` and ``ode``
propagators.

The kernel cases and tolerances are those of ``tests/test_expv_ode.py``
(1e-10 / 1e-9 for expv, the DP5 atols of ``:71,79,81,103,115``) and of
``tests/test_dd_linalg.py:260-281``; each port result is also held
against the JAX function's.  The propagators run, with ``precision``
``"native"`` and ``"dd"`` where they take it, on the optomech and
transmon generators of ``tests/test_optomech.py`` /
``tests/test_transmon.py`` (time grids cut to keep the file fast) and
agree with the JAX propagators to 1e-10."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch
from scipy.linalg import expm

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.ops.expv import expv_apply as jax_expv
from quantumpropagators.ops.ode import dopri5_integrate as jax_dopri5
from quantumpropagators.ops.operators import csr_from_scipy as jax_csr
from quantumpropagators.utils.fixtures import random_matrix, random_state_vector
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch.ops.expprop import expprop_apply, expprop_matrix
from quantumpropagators_torch.ops.expv import expv_apply, expv_apply_dd
from quantumpropagators_torch.ops.ode import dopri5_integrate
from quantumpropagators_torch.propagate import propagate_propagator

set_default_device("cpu")


def _t(x):
    return torch.as_tensor(np.asarray(x))


# -- expv --------------------------------------------------------------------

# (seed, N, radius, hermitian, density, dt, kwargs, func, tol)
_EXPV = {
    "dense_hermitian": (50, 400, 5.0, True, 1.0, 0.5, dict(m=40), None,
                        1e-10),
    "non_hermitian_tol": (51, 300, 4.0, False, 1.0, 0.3,
                          dict(m=10, tol=1e-12), None, 1e-9),
    "custom_func": (62, 150, 1.5, False, 1.0, 0.5, dict(m=40),
                    scipy.linalg.expm, 1e-9),
    "tol_grows_m": (64, 400, 20.0, True, 1.0, 0.5, dict(m=8, tol=1e-12),
                    None, 1e-9),
    "sparse_csr": (60, 200, 3.0, True, 0.1, 0.4, dict(m=40), None, 1e-10),
}


@pytest.mark.parametrize("name", sorted(_EXPV))
def test_expv_vs_jax(name):
    seed, N, radius, herm, density, dt, kw, func, tol = _EXPV[name]
    rng = np.random.default_rng(seed)
    H = random_matrix(N, spectral_radius=radius, hermitian=herm,
                      density=density, rng=rng)
    psi = random_state_vector(N, rng=rng)
    M = H * dt if func is not None else -1j * H * dt
    exact = expm(M) @ psi
    fkw = {} if func is None else {"func": func}
    jop = jax_csr(sp.csr_matrix(H)) if density < 1 else jnp.asarray(H)
    want_jax = np.asarray(jax_expv(jop, jnp.asarray(psi), dt, **kw, **fkw))
    top = from_jax(jop) if density < 1 else _t(H)
    got = expv_apply(top, _t(psi), dt, **kw, **fkw).numpy()
    assert np.linalg.norm(got - exact) < tol
    assert np.linalg.norm(got - want_jax) < tol
    if name == "tol_grows_m":
        fixed = expv_apply(top, _t(psi), dt, m=8).numpy()
        assert np.linalg.norm(got - exact) < np.linalg.norm(
            fixed - exact) / 100


def test_expv_happy_breakdown_zero_state_backward():
    rng = np.random.default_rng(52)
    H = random_matrix(40, hermitian=True, rng=rng)
    evals, evecs = np.linalg.eigh(H)
    psi = evecs[:, 5].astype(complex)
    res = expv_apply(_t(H), _t(psi), 0.9, m=20).numpy()
    assert np.linalg.norm(res - np.exp(-0.9j * evals[5]) * psi) < 1e-10
    zero = expv_apply(torch.eye(8, dtype=torch.complex128),
                      torch.zeros(8, dtype=torch.complex128), 0.5)
    assert float(torch.linalg.vector_norm(zero)) == 0.0
    rng = np.random.default_rng(63)
    H = random_matrix(120, hermitian=True, spectral_radius=4, rng=rng)
    psi = random_state_vector(120, rng=rng)
    fwd = expv_apply(_t(H), _t(psi), 0.4, m=40)
    back = expv_apply(_t(H), fwd, -0.4, m=40).numpy()
    assert np.linalg.norm(back - psi) < 1e-10


def test_expv_lazy_operator():
    rng = np.random.default_rng(61)
    H0 = random_matrix(100, hermitian=True, spectral_radius=2, rng=rng)
    H1 = random_matrix(100, hermitian=True, spectral_radius=1, rng=rng)
    op = qt.Operator([_t(H0), _t(H1)], np.array([0.7]))
    psi = random_state_vector(100, rng=rng)
    exact = expm(-0.3j * (H0 + 0.7 * H1)) @ psi
    got = expv_apply(op, _t(psi), 0.3, m=40).numpy()
    assert np.linalg.norm(got - exact) < 1e-10


@pytest.mark.parametrize("hermitian, kw", [(True, dict(m=40)),
                                           (False, dict(m=8, tol=1e-12,
                                                        m_max=96))])
def test_expv_dd(hermitian, kw):
    """tests/test_dd_linalg.py:260-281 at 1e-10."""
    rng = np.random.default_rng(11 if hermitian else 12)
    N = 400 if hermitian else 300
    H = random_matrix(N, spectral_radius=4.0 if hermitian else 3.0,
                      hermitian=hermitian, rng=rng)
    psi = random_state_vector(N, rng=rng)
    dt = 0.4 if hermitian else 0.5
    got = expv_apply_dd(H, psi, dt, **kw)
    assert got.dtype == torch.complex128
    exact = expm(-1j * dt * H) @ psi
    assert np.abs(got.numpy() - exact).max() < 1e-10


# -- expprop -----------------------------------------------------------------


def test_expprop_apply():
    rng = np.random.default_rng(70)
    H = random_matrix(24, hermitian=True, spectral_radius=3, rng=rng)
    psi = random_state_vector(24, rng=rng)
    got = expprop_apply(_t(H), _t(psi), 0.4).numpy()
    assert np.abs(got - expm(-0.4j * H) @ psi).max() < 1e-12
    U = expprop_matrix(_t(H), 0.4, func=lambda M: torch.linalg.matrix_exp(M))
    assert np.abs(U.numpy() - expm(0.4 * H)).max() < 1e-12
    assert expprop_matrix(_t(H).to(torch.complex64), 0.4).dtype \
        == torch.complex64


@pytest.mark.parametrize("norm", [1e-4, 0.03, 0.05, 1.0, 10.0, 100.0])
@pytest.mark.parametrize("kind", ["skew-hermitian", "real"])
def test_expm_matches_jax(norm, kind):
    """The port's ``expm`` equals ``jax.scipy.linalg.expm`` to 1e-13
    relative at 1-norms on both sides of each Padé degree's bound
    (``torch.linalg.matrix_exp`` misses by 4e-13 and 1e-12 at 0.03
    here, and by 2e-11 on the 2 × 2 step of
    ``test_torch_timedependent_observables.py``)."""
    import jax.scipy.linalg as jsl

    from quantumpropagators_torch.ops.expprop import expm as texpm

    rng = np.random.default_rng(71)
    A = random_matrix(6, hermitian=True, spectral_radius=1.0, rng=rng)
    M = -1j * A if kind == "skew-hermitian" else A.real
    M = M * (norm / np.abs(M).sum(axis=0).max())
    want = np.asarray(jsl.expm(jnp.asarray(M)))
    got = texpm(_t(M)).numpy()
    assert np.abs(got - want).max() < 1e-13 * max(1.0, np.abs(want).max())


# -- DP5(4) ------------------------------------------------------------------


def test_dopri5_oscillator_vs_jax():
    """y'' = -y over one period (test_expv_ode.py:65-71)."""
    A = np.array([[0.0, 1.0], [-1.0, 0.0]])
    y1 = dopri5_integrate(lambda t, y: _t(A) @ y, _t([1.0, 0.0]), 0.0,
                          2 * np.pi, rtol=1e-10, atol=1e-10).numpy()
    assert np.allclose(y1, [1.0, 0.0], atol=1e-7)
    want = np.asarray(jax_dopri5(lambda t, y: jnp.asarray(A) @ y,
                                 jnp.asarray([1.0, 0.0]), 0.0, 2 * np.pi,
                                 rtol=1e-10, atol=1e-10))
    assert np.abs(y1 - want).max() < 1e-12


def test_dopri5_backward_vs_jax():
    """test_expv_ode.py:74-81."""
    lam = -0.7 + 0.3j
    fwd = dopri5_integrate(lambda t, y: lam * y, _t([1.0 + 0j]), 0.0, 2.0,
                           rtol=1e-11, atol=1e-11)
    assert np.allclose(fwd.numpy(), np.exp(lam * 2.0), atol=1e-8)
    back = dopri5_integrate(lambda t, y: lam * y, fwd, 2.0, 0.0,
                            rtol=1e-11, atol=1e-11)
    assert np.allclose(back.numpy(), 1.0, atol=1e-7)
    want = np.asarray(jax_dopri5(lambda t, y: lam * y, jnp.asarray([1 + 0j]),
                                 0.0, 2.0, rtol=1e-11, atol=1e-11))
    assert np.abs(fwd.numpy() - want).max() < 1e-12


@pytest.mark.parametrize("pwc", [True, False])
def test_ode_propagator(pwc):
    """test_expv_ode.py:84-103: pwc against expprop at 1e-7; continuous
    against a fine-grid pwc reference at 1e-5, and against the JAX
    continuous propagator."""
    rng = np.random.default_rng(54)
    N = 16
    H0 = random_matrix(N, hermitian=True, spectral_radius=2, rng=rng)
    H1 = random_matrix(N, hermitian=True, spectral_radius=1, rng=rng)
    gen = qt.hamiltonian(_t(H0), (_t(H1), lambda t: np.cos(t)))
    tlist = np.linspace(0, 2, 41)
    psi0 = _t(random_state_vector(N, rng=rng))
    res = qt.propagate(psi0, gen, tlist, method="ode", pwc=pwc, check=False)
    ref = qt.propagate(psi0, gen, tlist, method="expprop", check=False)
    tol = 1e-7 if pwc else 2e-3
    assert np.linalg.norm(res.numpy() - ref.numpy()) < tol
    if not pwc:
        fine = qt.propagate(psi0, gen, np.linspace(0, 2, 4001),
                            method="expprop", check=False)
        assert np.linalg.norm(res.numpy() - fine.numpy()) < 1e-5
        jgen = qp.hamiltonian(jnp.asarray(H0),
                              (jnp.asarray(H1), lambda t: jnp.cos(t)))
        want = qp.propagate(jnp.asarray(psi0.numpy()), jgen, tlist,
                            method="ode", pwc=False, check=False)
        assert np.linalg.norm(res.numpy() - np.asarray(want)) < 1e-10


@pytest.mark.parametrize("control", ["numpy", "torch"])
def test_ode_backward_and_fallback(control):
    """test_expv_ode.py:106-115 with the default ``check``: a ``torch.sin``
    control (the JAX test's ``jnp.sin``: it computes on an abstract time,
    so the continuous variant, within 1e-12 of the JAX package's forward
    state) and a ``numpy`` control with no flag (the piecewise variant,
    as the JAX package's rule picks); and the fall back to the piecewise
    variant when an amplitude is not a function of t."""
    rng = np.random.default_rng(55)
    N = 8
    H0 = _t(random_matrix(N, hermitian=True, spectral_radius=2, rng=rng))
    sin = torch.sin if control == "torch" else np.sin
    gen = qt.hamiltonian(H0, (H0, lambda t: 0.1 * sin(t)))
    tlist = np.linspace(0, 2, 21)
    psi0 = _t(random_state_vector(N, rng=rng))
    if control == "torch":
        prop = qt.init_prop(psi0, gen, tlist, method="ode")
        assert isinstance(prop, qt.propagators.ode.ODEContinuousPropagator)
    else:
        with pytest.warns(UserWarning, match="piecewise"):
            prop = qt.init_prop(psi0, gen, tlist, method="ode")
        assert isinstance(prop, qt.propagators.ode.ODEPWCPropagator)
    fwd = qt.propagate(psi0, gen, tlist, method="ode")
    back = qt.propagate(fwd, gen, tlist, method="ode", backward=True)
    assert np.linalg.norm(back.numpy() - psi0.numpy()) < 1e-7
    if control == "torch":
        H = jnp.asarray(H0.numpy())
        jgen = qp.hamiltonian(H, (H, lambda t: 0.1 * jnp.sin(t)))
        want = qp.propagate(jnp.asarray(psi0.numpy()), jgen, tlist,
                            method="ode")
        assert np.linalg.norm(fwd.numpy() - np.asarray(want)) < 1e-12
    vals = np.linspace(0.0, 0.1, 20)  # midpoint values: not callable
    gen2 = qt.hamiltonian(H0, (H0, vals))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        prop = qt.init_prop(psi0, gen2, tlist, method="ode")
    assert isinstance(prop, qt.propagators.ode.ODEPWCPropagator)
    assert any("piecewise" in str(x.message) for x in w)
    with pytest.raises(ValueError):
        qt.init_prop(psi0, gen2, tlist, method="ode", pwc=False)


# -- the propagators against the JAX package --------------------------------


def _optomech():
    from tests.test_optomech import build_optomech

    H0, H_int = build_optomech()
    eps = lambda t: float(np.sin(2 * np.pi * t / 5.0) ** 2)
    jgen = qp.hamiltonian(jax_csr(H0), (jax_csr(H_int), eps))
    psi0 = np.zeros(H0.shape[0], dtype=complex)
    psi0[0] = 1.0
    return jgen, np.linspace(0, 0.5, 26), psi0


def _transmon():
    N, omega, alpha = 10, 5.0, 0.3
    n = np.arange(N)
    H0 = np.diag(omega * n - 0.5 * alpha * n * (n - 1)).astype(complex)
    a = np.diag(np.sqrt(np.arange(1, N)), 1).astype(complex)
    eps = lambda t: 0.5 * qp.flattop(t, T=4.0, t_rise=1.0) * np.cos(omega * t)
    jgen = qp.hamiltonian(jnp.asarray(H0), (jnp.asarray(a + a.conj().T), eps))
    return jgen, np.linspace(0, 0.5, 51), np.eye(N)[0].astype(complex)


_SYSTEMS = {"optomech": _optomech, "transmon": _transmon}
_METHODS = [
    ("newton", dict(m_max=12), "native"),
    ("newton", dict(m_max=12), "dd"),
    ("krylov", dict(m_max=20), "native"),
    ("expv", dict(m_max=20), "dd"),
    ("expprop", {}, None),
    ("ode", dict(pwc=True), None),
]


@pytest.fixture(scope="module", params=sorted(_SYSTEMS))
def system(request):
    jgen, tlist, psi0 = _SYSTEMS[request.param]()
    ref = {}
    for method in ("newton", "krylov", "expprop", "ode"):
        kw = dict(m_max=12) if method == "newton" else (
            dict(m_max=20) if method == "krylov" else {})
        if method == "ode":
            kw = dict(pwc=True)
        ref[method] = np.asarray(qp.propagate(jnp.asarray(psi0), jgen, tlist,
                                              method=method, check=False,
                                              **kw))
    return request.param, from_jax(jgen), tlist, psi0, ref


@pytest.mark.parametrize("method, kw, precision", _METHODS)
def test_propagator_vs_jax(system, method, kw, precision):
    name, gen, tlist, psi0, ref = system
    if precision is not None:
        kw = dict(kw, precision=precision)
    prop = qt.init_prop(_t(psi0), gen, tlist, method=method, **kw)
    propagate_propagator(prop)
    got = prop.state.numpy()
    if precision == "dd":
        assert prop.precision == "dd"
        assert prop.state_dd.dtype == torch.complex128
        assert np.array_equal(prop.state_dd.numpy(), got)
    key = "krylov" if method == "expv" else method
    assert np.abs(got - ref[key]).max() < 1e-10
    # Newton and Krylov agree with each other as in the JAX tests
    if method in ("newton", "krylov"):
        assert np.abs(got - ref["expprop"]).max() < 1e-10


def test_dd_propagators_roundtrip_and_reinit():
    """Backward dd Newton reverses forward at 1e-11; reinit re-reads the
    state (tests/test_dd_linalg.py:564-611)."""
    rng = np.random.default_rng(25)
    N = 40
    M0 = rng.normal(size=(N, N))
    gen = qt.hamiltonian(_t((M0 + M0.T).astype(complex)))
    tlist = np.linspace(0, 0.5, 11)
    psi0 = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi0 = _t(psi0 / np.linalg.norm(psi0))
    fwd = qt.init_prop(psi0, gen, tlist, method="newton", precision="dd",
                       m_max=16)
    propagate_propagator(fwd)
    bwd = qt.init_prop(fwd.state_dd, gen, tlist, method="newton",
                       precision="dd", m_max=16, backward=True)
    propagate_propagator(bwd)
    assert np.abs(bwd.state_dd.numpy() - psi0.numpy()).max() < 1e-11
    prop = qt.init_prop(psi0, gen, tlist, method="expv", precision="dd",
                        m_max=16)
    propagate_propagator(prop)
    first = prop.state_dd.clone()
    qt.reinit_prop(prop, psi0)
    assert torch.equal(prop.state_dd, psi0)
    propagate_propagator(prop)
    assert np.abs((prop.state_dd - first).numpy()).max() < 1e-13
    cheby = qt.init_prop(psi0, gen, tlist, method="cheby", precision="dd")
    propagate_propagator(cheby)
    assert cheby.state_dd.dtype == torch.complex128
    assert np.abs((cheby.state_dd - first).numpy()).max() < 1e-10


def test_available_methods_and_unknown():
    from quantumpropagators.propagators import available_methods as jax_m

    assert set(jax_m()) <= set(qt.propagators.available_methods())
    with pytest.raises(ValueError, match="Unknown propagation method"):
        qt.init_prop(_t(np.ones(4, complex)), _t(np.eye(4, dtype=complex)),
                     np.linspace(0, 1, 3), method="no_such_method")
