"""The last compiled sites of the JAX package as graphed sites of the port,
on the CPU: Newton's restart tail (the JAX ``_newton_update_dd``, and for
the native precision ``_accumulate`` + ``_norm``), ``expv``'s final
combine (``_combine_dd``) and the standalone dd Chebyshev applies
(``_cheby_dd_impl``, ``_cheby_dd_bsr_impl``).

- (a) each body against its JAX counterpart, state within 1e-12;
- (b) each body, given its per-call data as tensors (as a capture gives
  it its static buffers), under the guard that raises on every host
  read;
- (c) the card's route with the CPU standing for the card
  (``test_torch_step_graph._on_the_card``): Newton restarts in a
  propagator capture the tail once for each Krylov dimension they meet
  (also where a restart breaks down to ``m_eff < m``) and never after
  the first steps; ``expv``'s combine captures once; the dd applies
  inside a scope capture once over calls with new coefficients and the
  same static arguments, and outside every scope capture nothing; every
  routed result equals the body's bit for bit.

The card's half is in ``test_torch_step_graph_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch

import quantumpropagators_torch as qt
from quantumpropagators.ops import df64 as jdf
from quantumpropagators.ops import df64_sparse as jdfs
from quantumpropagators.ops import expv as jexpv
from quantumpropagators.ops import newton as jnewton
from quantumpropagators_torch.ops import arnoldi as tarn
from quantumpropagators_torch.ops import dd_linalg as tdd
from quantumpropagators_torch.ops import df64 as tdf
from quantumpropagators_torch.ops import df64_sparse as tdfs
from quantumpropagators_torch.ops import expv as texpv
from quantumpropagators_torch.ops import newton as tnewton
from quantumpropagators_torch.ops.cheby import cheby_coeffs
from quantumpropagators_torch.utils import scan as scan_mod
from test_torch_step_graph import Guard, _on_the_card, _run

qt.set_default_device("cpu")

T = torch.as_tensor


def _complex(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture(scope="module")
def tail_inputs():
    """A basis of ``m + 1`` rows, the coordinates ``P`` and ``R`` (``R``
    normalized) and an accumulated state, ``m = 5``, ``N = 16``."""
    rng = np.random.default_rng(31)
    m, N = 5, 16
    q = np.linalg.qr(_complex(rng, N, m + 1))[0].T
    R = _complex(rng, m + 1)
    return q, _complex(rng, m), R / np.linalg.norm(R), _complex(rng, N), m


# -- (a) the bodies against JAX ---------------------------------------------

def test_tail_matches_newton_update_dd(tail_inputs):
    q, P, R, Psi, m = tail_inputs
    Pj, vj, nh, nl = jnewton._newton_update_dd(
        jdf.cdd_from_c128(q), jnewton._split_c128_planes(P),
        jnewton._split_c128_planes(R), jdf.cdd_from_c128(Psi), m)
    got = tnewton._newton_tail(T(q), P, R, T(Psi), m, None)
    for a, b in zip(got[:2], (Pj, vj)):
        assert np.abs(a.numpy() - jdf.cdd_to_c128(b)).max() <= 1e-12
    norm = np.float64(nh) + np.float64(nl)
    assert abs(float(got[2]) - norm) <= 1e-12 * norm


def test_tail_matches_accumulate_and_norm(tail_inputs):
    """The native loop's ``_accumulate`` and ``_norm``, and its next start
    vector (a ``tensordot`` of ``R`` over ``m + 1`` rows)."""
    q, P, R, Psi, m = tail_inputs
    Pj = jnewton._accumulate(jnp.asarray(Psi), jnp.asarray(q[:m]),
                             jnp.asarray(P))
    vj = jnp.tensordot(jnp.asarray(R), jnp.asarray(q), axes=(0, 0))
    got = tnewton._newton_tail(T(q), P, R, T(Psi), m, None)
    assert np.abs(got[0].numpy() - np.asarray(Pj)).max() <= 1e-12
    assert np.abs(got[1].numpy() - np.asarray(vj)).max() <= 1e-12
    norm = float(jnewton._norm(Pj))
    assert abs(float(got[2]) - norm) <= 1e-12 * norm


def test_combine_matches_combine_dd(tail_inputs):
    q, P, _, _, m = tail_inputs
    want = jexpv._combine_dd(jdf.cdd_from_c128(q[:m]),
                             jnewton._split_c128_planes(P))
    got = texpv._expv_combine(T(q), P, m)
    assert np.abs(got.numpy() - jdf.cdd_to_c128(want)).max() <= 1e-12


def _chain(L=6, seed=32):
    """A diagonal-plus-flip Hamiltonian on 2^L states, its envelope and a
    normalized state."""
    rng = np.random.default_rng(seed)
    diag = rng.uniform(-1.0, 1.0, 2 ** L)
    flip = tuple(float(g) for g in rng.uniform(0.2, 0.6, L))
    bound = 1.0 + sum(flip)
    psi = _complex(rng, 2 ** L)
    return diag, flip, psi / np.linalg.norm(psi), 2.1 * bound, -1.05 * bound


def _split(coeffs):
    hi = coeffs.astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(
        (coeffs - hi.astype(np.float64)).astype(np.float32))


@pytest.mark.parametrize("dt", [0.3, -0.3])
def test_cheby_dd_body_matches_jax(dt):
    L = 6
    diag, flip, psi, delta, e_min = _chain(L)
    coeffs = cheby_coeffs(delta, abs(dt))
    want = jdf._cheby_dd_impl(jdf.cdd_from_c128(psi), jdf.dd_from_f64(diag),
                              *_split(coeffs), delta, e_min, dt, L, flip,
                              dt > 0)
    got = tdf._cheby_dd_impl(T(psi), T(diag), coeffs, delta, e_min, dt, L,
                             flip, dt > 0)
    assert np.abs(got.numpy() - jdf.cdd_to_c128(want)).max() <= 1e-12


def _bsr(N=64, seed=33):
    rng = np.random.default_rng(seed)
    A = sp.random(N, N, density=0.15, random_state=rng,
                  data_rvs=rng.standard_normal)
    A = (A + A.T).tocsr()
    bound = float(np.abs(A).sum(axis=1).max())
    psi = _complex(rng, N)
    return A, psi / np.linalg.norm(psi), 2.0 * bound, -bound


def test_cheby_dd_bsr_body_matches_jax():
    A, psi, delta, e_min = _bsr()
    dt = 0.2
    coeffs = cheby_coeffs(delta, dt)
    jop = jdfs.bsr_dd_from_scipy(A, block_size=8)
    want = jdfs._cheby_dd_bsr_impl(
        jop.blocks_hi, jop.blocks_lo, jop.cols, int(jop.shape[0]),
        jdf.cdd_from_c128(psi), *_split(coeffs), delta, e_min, dt, True)
    op = tdfs.bsr_dd_from_scipy(A, block_size=8, device="cpu")
    got = tdfs._cheby_dd_bsr_impl(op, T(psi), coeffs, delta, e_min, dt, True)
    assert np.abs(got.numpy() - jdf.cdd_to_c128(want)).max() <= 1e-12
    exact = scipy.linalg.expm(-1j * dt * A.toarray()) @ psi
    assert np.abs(got.numpy() - exact).max() <= 1e-10


# -- (b) the bodies read nothing from the host -------------------------------

def _bodies():
    rng = np.random.default_rng(34)
    m, N = 5, 16
    q = T(np.linalg.qr(_complex(rng, N, m + 1))[0].T)
    P, R, Psi = (T(_complex(rng, k)) for k in (m, m + 1, N))
    diag, flip, psi, delta, e_min = _chain()
    diag, psi, coeffs = T(diag), T(psi), T(cheby_coeffs(delta, 0.3))
    A, psi_b, delta_b, e_min_b = _bsr()
    op = tdfs.bsr_dd_from_scipy(A, block_size=8, device="cpu")
    psi_b, coeffs_b = T(psi_b), T(cheby_coeffs(delta_b, 0.2))
    return {
        "newton tail": lambda: tnewton._newton_tail(q, P, R, Psi, m, None),
        "expv combine": lambda: texpv._expv_combine(q, P, m),
        "cheby dd": lambda: tdf._cheby_dd_impl(
            psi, diag, coeffs, delta, e_min, 0.3, 6, flip, True),
        "cheby dd bsr": lambda: tdfs._cheby_dd_bsr_impl(
            op, psi_b, coeffs_b, delta_b, e_min_b, 0.2, True),
    }


@pytest.mark.parametrize("body", sorted(_bodies()))
def test_body_reads_nothing_from_the_host(body):
    call = _bodies()[body]
    want = call()
    with Guard():
        got = call()
    for a, b in zip(scan_mod._leaves(got), scan_mod._leaves(want)):
        assert torch.equal(a, b)


# -- (c) the card's route on the CPU ------------------------------------------

def _driven(H0, H1, psi, n=6):
    gen = qt.hamiltonian(T(H0), (T(H1), lambda t: np.cos(4.0 * t)))
    return gen, T(psi), np.linspace(0.0, 1.0, n + 1)


def _hermitian(rng, N, scale=1.0):
    X = _complex(rng, N, N)
    H = X + X.conj().T
    return scale * H / np.abs(np.linalg.eigvalsh(H)).max()


def _block_system(rng, n_small=3, N=16):
    """A state inside an invariant block of ``n_small`` dimensions of both
    terms: every Arnoldi call breaks down at ``m_eff = n_small``."""
    H0, H1 = (scipy.linalg.block_diag(_hermitian(rng, n_small, 2.0),
                                      _hermitian(rng, N - n_small, 2.0))
              for _ in range(2))
    psi = np.zeros(N, complex)
    psi[:n_small] = _complex(rng, n_small)
    return H0, H1, psi / np.linalg.norm(psi)


@pytest.mark.parametrize("case", ["restarts", "breakdown"])
@pytest.mark.parametrize("precision", ["native", "dd"])
def test_newton_tail_captures_once_per_dimension(monkeypatch, case,
                                                 precision):
    rng = np.random.default_rng(35)
    if case == "restarts":
        N = 16
        system = (_hermitian(rng, N, 4.0), _hermitian(rng, N),
                  _complex(rng, N) / 4.0)
    else:
        system = _block_system(rng)
    gen, psi, tlist = _driven(*system)
    psi = psi / torch.linalg.vector_norm(psi)
    kw = dict(method="newton", precision=precision, m_max=5)
    eager = _run(qt.init_prop(psi, gen, tlist, **kw), psi)
    _on_the_card(monkeypatch)
    prop = qt.init_prop(psi, gen, tlist, **kw)
    graph = _run(prop, psi)
    sites = prop._arnoldi_sites
    parts = sites.parts(tnewton._newton_tail)
    if case == "breakdown":
        assert all(m < 5 for _, m in parts)
    else:
        assert prop.newton_info.restarts >= 1
    captures = sites.captures
    assert sites.captures_of(tnewton._newton_tail) == len(parts)
    assert all(torch.equal(g, e) for g, e in zip(graph, eager))
    assert all(torch.equal(g, e) for g, e in zip(_run(prop, psi), eager))
    assert sites.captures == captures  # nothing after the first steps


def test_expv_combine_captures_once(monkeypatch):
    rng = np.random.default_rng(36)
    N = 16
    gen, psi, tlist = _driven(_hermitian(rng, N), _hermitian(rng, N, 0.3),
                              _complex(rng, N))
    psi = psi / torch.linalg.vector_norm(psi)
    kw = dict(method="expv", m_max=6)
    eager = _run(qt.init_prop(psi, gen, tlist, **kw), psi)
    _on_the_card(monkeypatch)
    prop = qt.init_prop(psi, gen, tlist, **kw)
    graph = _run(prop, psi)
    assert prop._arnoldi_sites.captures_of(texpv._expv_combine) == 1
    assert all(torch.equal(g, e) for g, e in zip(graph, eager))


def _applies():
    """Per apply: the function and its calls' arguments, the coefficients
    new at every call (the count and the static arguments kept)."""
    diag, flip, psi, delta, e_min = _chain()
    A, psi_b, delta_b, e_min_b = _bsr()
    op = tdfs.bsr_dd_from_scipy(A, block_size=8, device="cpu")
    rng = np.random.default_rng(37)

    def flip_call(k):
        c = cheby_coeffs(delta, 0.3) * (1.0 + 0.01 * rng.standard_normal())
        return lambda: tdf.cheby_apply_dd(T(psi), T(diag), flip, c, delta,
                                          e_min, 0.3, L=6)

    def bsr_call(k):
        c = cheby_coeffs(delta_b, 0.2) * (1.0 + 0.01 * k)
        return lambda: tdfs.cheby_apply_dd_bsr(op, T(psi_b), c, delta_b,
                                               e_min_b, 0.2)

    return {"cheby_apply_dd": (flip_call, tdf._cheby_dd_impl),
            "cheby_apply_dd_bsr": (bsr_call, tdfs._cheby_dd_bsr_impl)}


@pytest.mark.parametrize("name", sorted(_applies()))
def test_dd_apply_captures_once_in_a_scope(monkeypatch, name):
    make, body = _applies()[name]
    calls = [make(k) for k in range(4)]
    eager = [call() for call in calls]
    _on_the_card(monkeypatch)
    outside = [call() for call in calls]  # no scope: the body
    with tarn.arnoldi_sites(tarn.ArnoldiSites()) as sites:
        graph = [call() for call in calls]
    assert sites.captures_of(body) == 1 == sites.captures
    for got in (outside, graph):
        assert all(torch.equal(g, e) for g, e in zip(got, eager))


def test_dd_apply_outside_a_scope_captures_nothing(monkeypatch):
    captures = []
    _on_the_card(monkeypatch)
    captured = scan_mod._captured
    monkeypatch.setattr(scan_mod, "_captured",
                        lambda *a, **k: captures.append(1) or captured(*a,
                                                                      **k))
    for name, (make, _) in sorted(_applies().items()):
        for k in range(3):
            make(k)()
    assert not captures
