"""The stepwise path's graphed sites on the card: each Chebyshev interval
and each Arnoldi call replays one CUDA graph (``utils/scan.graphed``,
the port of the JAX package's ``jax.jit`` of ``_cheby_step`` and of
``_arnoldi_impl``).  A stepwise propagation with controls that change
every interval equals the eager one (every site's body,
``chip_smoke.bodies_only``) bit for bit with one capture; a
``reinit_prop`` with new controls or a moved envelope of the same
length captures nothing; Newton's restarts replay the Arnoldi graph;
a generator of numpy matrices runs graphed (the propagator copies them
onto the card once); a dropped propagator gives its memory back.
Newton's restart tail and ``expv``'s combine replay their graphs
(one capture a Krylov dimension), and the standalone dd Chebyshev
applies replay one graph a scope over new coefficients, each bit for
bit its eager body, a dropped scope giving its memory back.  Small
sizes (DIA operators, elementwise and deterministic).  Needs an NVIDIA GPU (``-m cuda``);
skips without one.  Imports no jax: run with ``--noconftest``."""

import gc

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
import quantumpropagators_torch as qt
from quantumpropagators_torch.ops import arnoldi as arn
from quantumpropagators_torch.ops import df64, df64_sparse, expv, newton
from quantumpropagators_torch.ops.cheby import cheby_coeffs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _driven(device, N=256, n=10):
    """A driven tridiagonal system as DIA terms, ``n`` intervals."""
    main = np.linspace(-2.0, 2.0, N)
    off = 0.5 * np.ones(N - 1)
    H0 = sp.diags([off, main, off], [-1, 0, 1]).tocsr()
    H1 = sp.diags(np.cos(np.arange(N))).tocsr()
    gen = qt.hamiltonian(qt.dia_from_scipy(H0, device=device),
                         (qt.dia_from_scipy(H1, device=device),
                          lambda t: float(np.cos(3.0 * t))))
    rng = np.random.default_rng(7)
    psi = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    psi = torch.as_tensor(psi / np.linalg.norm(psi), device=device)
    return gen, psi, np.linspace(0.0, 2.0, n + 1)


def _states(prop, psi):
    qt.reinit_prop(prop, psi)
    out = []
    while (s := prop.prop_step()) is not None:
        out.append(s)
    torch.cuda.synchronize()
    return out


def test_stepwise_cheby_graph_equals_eager(cuda):
    gen, psi, tlist = _driven(cuda)
    prop = qt.init_prop(psi, gen, tlist, method="cheby",
                        check_normalization=True)
    graph = _states(prop, psi)
    with chip_smoke.bodies_only():
        eager = _states(prop, psi)
    assert all(torch.equal(g, e) for g, e in zip(graph, eager))
    assert len(graph) == 10 and prop._step.captures == 1


def test_reinit_captures_nothing(cuda):
    gen, psi, tlist = _driven(cuda)
    prop = qt.init_prop(psi, gen, tlist, method="cheby")
    _states(prop, psi)
    (control,) = prop.parameters.keys()
    vals = prop.parameters[control]
    vals[:] = 0.5 * vals[::-1].copy()
    _states(prop, psi)
    assert prop._step.captures == 1
    f = chip_smoke._moved_envelope(prop)
    moved = _states(prop, psi)
    assert prop._step.captures == 1
    with chip_smoke.bodies_only():
        assert all(torch.equal(g, e) for g, e in zip(moved,
                                                      _states(prop, psi)))
    assert f > 0


def test_newton_restarts_replay_the_arnoldi_graph(cuda, monkeypatch):
    gen, psi, tlist = _driven(cuda, n=3)
    calls, replays = [], []
    read, replay = arn._read, torch.cuda.CUDAGraph.replay

    def counted_read(*args):
        calls.append(1)
        return read(*args)

    def counted_replay(graph):
        replays.append(1)
        return replay(graph)

    monkeypatch.setattr(arn, "_read", counted_read)
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", counted_replay)
    prop = qt.init_prop(psi, gen, tlist, method="newton", m_max=4)
    _states(prop, psi)
    assert len(calls) > 3  # restarts
    sites = prop._arnoldi_sites
    assert sites.captures_of(arn._arnoldi_impl) == 1
    assert sites.captures_of(newton._newton_tail) == 1
    # one tail a restart: its site captures at its third call, the second
    # whose basis is the Arnoldi site's own
    assert len(replays) == (len(calls) - 1) + (len(calls) - 2)


@pytest.mark.parametrize("method", ["cheby", "newton"])
def test_numpy_generator_graph_equals_eager(cuda, method):
    """``hamiltonian`` of numpy matrices with the state on the card: each
    matrix is copied onto the card once (a copy at every matvec could not
    be captured), one capture, bit for bit the eager run."""
    N = 64
    rng = np.random.default_rng(8)
    X = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    H0 = (X + X.conj().T) / 8.0
    H1 = np.diag(np.cos(np.arange(N))).astype(complex)
    gen = qt.hamiltonian(H0, (H1, lambda t: float(np.cos(3.0 * t))))
    psi = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    psi = torch.as_tensor(psi / np.linalg.norm(psi), device=cuda)
    kw = dict(method=method, m_max=8) if method == "newton" \
        else dict(method="cheby", check_normalization=True)
    prop = qt.init_prop(psi, gen, np.linspace(0.0, 2.0, 11), **kw)
    graph = _states(prop, psi)
    with chip_smoke.bodies_only():
        eager = _states(prop, psi)
    if method == "cheby":
        assert prop._step.captures == 1
    else:
        sites = prop._arnoldi_sites
        assert sites.captures_of(arn._arnoldi_impl) == 1
        assert sites.captures_of(newton._newton_tail) == len(
            sites.parts(newton._newton_tail))
    assert len(graph) == 10
    assert all(torch.equal(g, e) for g, e in zip(graph, eager))


def test_dropped_propagator_gives_its_memory_back(cuda):
    gen, psi, tlist = _driven(cuda, N=2 ** 20, n=3)
    before = chip_smoke._reserved_gib()
    prop = qt.init_prop(psi, gen, tlist, method="cheby",
                        rng=np.random.default_rng(3))
    held = torch.cuda.memory_reserved() / 2 ** 30  # a 0.95 GiB basis
    _states(prop, psi)
    del prop
    gc.collect()
    assert held - before > 0.9
    assert abs(chip_smoke._reserved_gib() - before) <= 0.25


@pytest.mark.parametrize("method,precision", [("newton", "native"),
                                              ("newton", "dd"),
                                              ("expv", "native"),
                                              ("expv", "dd")])
def test_krylov_tails_graph_equal_eager(cuda, method, precision):
    gen, psi, tlist = _driven(cuda)
    prop = qt.init_prop(psi, gen, tlist, method=method, precision=precision,
                        m_max=6)
    graph = _states(prop, psi)
    captures = prop._arnoldi_sites.captures
    again = _states(prop, psi)
    with chip_smoke.bodies_only():
        eager = _states(prop, psi)
    sites = prop._arnoldi_sites
    tail = newton._newton_tail if method == "newton" else expv._expv_combine
    assert sites.captures == captures  # none after the first steps
    assert sites.captures_of(tail) == len(sites.parts(tail)) >= 1
    for run in (graph, again):
        assert all(torch.equal(g, e) for g, e in zip(run, eager))


def _dd_applies(device):
    """``cheby_apply_dd`` on an L = 12 chain and ``cheby_apply_dd_bsr`` on
    a real symmetric block-tridiagonal matrix, each ``(body, call(k))``
    with coefficients new at every call."""
    rng = np.random.default_rng(9)
    L = 12
    diag = torch.as_tensor(rng.uniform(-1.0, 1.0, 2 ** L), device=device)
    flip = rng.uniform(0.2, 0.6, L)
    bound = 1.0 + flip.sum()
    psi = torch.as_tensor(rng.standard_normal(2 ** L) + 0j, device=device)
    psi = psi / torch.linalg.vector_norm(psi)
    A = sp.random(512, 512, density=0.02, random_state=rng)
    A = (A + A.T + sp.diags(np.ones(511), 1) + sp.diags(np.ones(511), -1))
    op = df64_sparse.bsr_dd_from_scipy(A.tocsr(), block_size=8,
                                       device=device)
    b = float(np.abs(A).sum(axis=1).max())
    psi_b = torch.as_tensor(rng.standard_normal(512) + 0j, device=device)

    def flip_call(k):
        c = cheby_coeffs(2.1 * bound, 0.3) * (1.0 + 0.01 * k)
        return lambda: df64.cheby_apply_dd(psi, diag, flip, c, 2.1 * bound,
                                           -1.05 * bound, 0.3, L=L)

    def bsr_call(k):
        c = cheby_coeffs(2.0 * b, 0.2) * (1.0 - 0.01 * k)
        return lambda: df64_sparse.cheby_apply_dd_bsr(op, psi_b, c, 2.0 * b,
                                                      -b, 0.2)

    return {"flip": (df64._cheby_dd_impl, flip_call),
            "bsr": (df64_sparse._cheby_dd_bsr_impl, bsr_call)}


@pytest.mark.parametrize("name", ["flip", "bsr"])
def test_dd_apply_graph_equals_eager(cuda, name):
    body, make = _dd_applies(cuda)[name]
    calls = [make(k) for k in range(5)]
    eager = [call() for call in calls]  # outside every scope: the body
    before = chip_smoke._reserved_gib()
    with arn.arnoldi_sites(arn.ArnoldiSites()) as sites:
        graph = [call() for call in calls]
        torch.cuda.synchronize()
        assert sites.captures_of(body) == 1 == sites.captures
    del sites
    gc.collect()
    assert all(torch.equal(g, e) for g, e in zip(graph, eager))
    assert abs(chip_smoke._reserved_gib() - before) <= 0.05
