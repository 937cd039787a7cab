"""The graphed interval step and the graphed Arnoldi on the CPU (the port
of the JAX package's ``jax.jit`` of ``_cheby_step``/``_cheby_step_dd``
and of ``_arnoldi_impl``/``_arnoldi_dd_impl``).

On the card each stepwise Chebyshev interval and each Arnoldi call
replays one CUDA graph (``utils/scan.graphed``).  Here the wrapper is
the body, so this file holds what the body computes and what a capture
needs:

- (a) the interval body against the JAX ``_cheby_step`` (state within
  1e-12, ``max_norm`` within 1e-12 relative), and the dd interval with
  ``dd_operator_terms`` against the JAX propagator's ``_prop_step_dd``;
- (b) the Arnoldi body against the JAX ``arnoldi``/``arnoldi_dd``, with
  and without Krylov breakdown (``Hess`` within 1e-12, ``m_eff``
  equal);
- (c) each body, given its per-call data as tensors (as a capture gives
  it its static buffers), under a guard that raises on every host read;
- (d) the card's route of a call, with the CPU standing for the card
  (``_on_the_card``: a capture is a guarded call, a replay another):
  the interval's amplitudes and the envelope are data, not key, so a
  propagation with changing controls, a ``reinit_prop`` with new
  controls and a moved envelope of the same length capture once; the
  Arnoldi calls of Newton restarts (in a propagator and in one
  ``newton_apply``), of expv steps and of the envelope's two
  ``specrange`` calls capture once per owner, at a key's second call,
  and lend their basis (which Newton's restart tail and ``expv``'s
  combine read, each captured once a Krylov dimension:
  ``test_torch_krylov_graph.py``); host matrices among the terms are copied onto
  the state's device once, not at every matvec inside a graph; a
  generator sharded over more than one rank captures nothing; every
  result equals the body's bit for bit.

The card's half (graph against eager, memory given back) is
``test_torch_step_graph_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import quantumpropagators as jqp
import quantumpropagators_torch as qt
from quantumpropagators.models.generators import Operator as JOperator
from quantumpropagators.ops import arnoldi as jarn
from quantumpropagators.ops import dd_linalg as jdd
from quantumpropagators.ops import df64 as jdf
from quantumpropagators.propagators.cheby import _cheby_step as jax_step
from quantumpropagators_torch.models.generators import Operator
from quantumpropagators_torch.ops import arnoldi as tarn
from quantumpropagators_torch.ops.arnoldi import ArnoldiSites
from quantumpropagators_torch.ops import dd_linalg as tdd
from quantumpropagators_torch.ops.bsr_dd import banded_dd_from_bsr
from quantumpropagators_torch.ops.cheby import cheby_coeffs
from quantumpropagators_torch.ops.specrange import specrange
from quantumpropagators_torch.propagators import cheby as tcheby
from quantumpropagators_torch.propagators._dd_support import build_dd_terms
from quantumpropagators_torch.utils import scan as scan_mod
from test_torch_scan import HostRead
from test_torch_sharded_graph import Guard as _Guard

qt.set_default_device("cpu")

T = torch.as_tensor


def _hermitian(rng, N, scale=1.0):
    X = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    H = X + X.conj().T
    return scale * H / np.abs(np.linalg.eigvalsh(H)).max()


def _state(rng, N):
    v = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    return v / np.linalg.norm(v)


def _tridiagonal(N):
    """A real symmetric tridiagonal matrix (a band of 8-blocks)."""
    main = np.linspace(-1.0, 1.0, N)
    off = 0.5 * np.ones(N - 1)
    return sp.diags([off, main, off], [-1, 0, 1]).tocsr()


def _envelope(H0, H1, amp_max):
    ev = np.concatenate([np.linalg.eigvalsh(H0 + s * H1)
                         for s in (-amp_max, amp_max)])
    return float(ev.min()) - 0.05, float(ev.max()) + 0.05


class Guard(_Guard):
    """The sharded sites' guard, plus a number written into a tensor
    (``t[i] = 0.0``): on the card that is a host-to-device copy."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") == "__setitem__" and len(args) > 2 \
                and not isinstance(args[2], torch.Tensor):
            raise HostRead(f"__setitem__ of {type(args[2]).__name__}")
        return super().__torch_function__(func, types, args, kwargs)


def test_guard_catches_a_number_written_into_a_tensor():
    t = torch.zeros(3)
    with Guard(), pytest.raises(HostRead):
        t[0] = 1.0
    with Guard():
        t[0] = torch.ones(())


# -- (a) the interval body against JAX ----------------------------------------

@pytest.mark.parametrize("check,forward", [(False, True), (True, True),
                                           (True, False)])
def test_interval_body_matches_jax(check, forward):
    rng = np.random.default_rng(11)
    N = 16
    H0, H1, psi = _hermitian(rng, N), _hermitian(rng, N, 0.3), _state(rng, N)
    e_min, e_max = _envelope(H0, H1, 1.0)
    delta, dt = e_max - e_min, 0.1 if forward else -0.1
    coeffs = cheby_coeffs(delta, abs(dt))
    amps = np.array([0.7])
    want = jax_step(JOperator([jnp.asarray(H0), jnp.asarray(H1)], amps),
                    jnp.asarray(psi), jnp.asarray(coeffs), delta, e_min, dt,
                    forward, check)
    got = tcheby._cheby_step((T(H0), T(H1)), amps, T(psi), coeffs, delta,
                             e_min, dt, forward, check)
    if check:
        (want, want_norm), (got, got_norm) = want, got
        assert got_norm.shape == () and float(got_norm) <= 1.0 + 1e-12
        assert abs(float(got_norm) - float(want_norm)) \
            <= 1e-12 * float(want_norm)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-12


@pytest.mark.parametrize("terms", ["host matrices", "banded term"])
def test_dd_interval_matches_jax(terms):
    """Three stepwise dd intervals of a driven system with
    ``dd_operator_terms``: the port's graphed body (here the body)
    against the JAX ``_prop_step_dd``.  The port's banded term is a ready
    ``BandedDD`` (one ``banded_spmv`` a matvec, its plain version here);
    the JAX package takes the same matrix from the host."""
    rng = np.random.default_rng(12)
    N = 64
    H0 = _tridiagonal(N)
    H1 = sp.diags(rng.uniform(-0.2, 0.2, N)).tocsr()
    psi = _state(rng, N)
    tlist = np.linspace(0.0, 0.3, 4)
    eps = lambda t: 0.5 * np.cos(3.0 * t)
    e_min, e_max = _envelope(H0.toarray(), H1.toarray(), 0.5)
    kw = dict(method="cheby", precision="dd", E_min=e_min, E_max=e_max)
    jgen = jqp.hamiltonian(jnp.asarray(H0.toarray()),
                           (jnp.asarray(H1.toarray()), eps))
    jprop = jqp.init_prop(jnp.asarray(psi), jgen, tlist,
                          dd_operator_terms=[H0, H1], **kw)
    port_terms = [H0, H1]
    if terms == "banded term":
        port_terms[0] = banded_dd_from_bsr(qt.bsr_from_scipy(
            H0, block_size=8, dtype=torch.float64))
    gen = qt.hamiltonian(T(H0.toarray()), (T(H1.toarray()), eps))
    prop = qt.init_prop(T(psi), gen, tlist, dd_operator_terms=port_terms,
                        **kw)
    for _ in range(3):
        jprop.prop_step()
        prop.prop_step()
        err = np.abs(prop.state_dd.numpy() - np.asarray(jprop.state)).max()
        assert err <= 1e-12


# -- (b) the Arnoldi body against JAX ----------------------------------------

@pytest.mark.parametrize("N,m", [(8, 12), (64, 10)])
@pytest.mark.parametrize("kind", ["native", "native not extended", "dd"])
def test_arnoldi_matches_jax(kind, N, m):
    """``Hess`` within 1e-12 and ``m_eff`` equal, over an operator with an
    amplitude (taken apart from its terms by the graphed site); N = 8 with
    m = 12 breaks down after 8 iterations."""
    rng = np.random.default_rng(13)
    H0, H1, v = _hermitian(rng, N), _hermitian(rng, N, 0.3), _state(rng, N)
    dt, amp = 0.1, np.array([0.7])
    if kind == "dd":
        # the JAX side as one dense term (its TermsDDOp compiles twice as
        # long); the port's amplitude is still taken apart by the site
        Hj, _, mj = jdd.arnoldi_dd(jdd.dense_dd_from_numpy(H0 + amp[0] * H1),
                                   jdf.cdd_from_c128(v), m, dt)
        op = tdd.TermsDDOp(terms=(tdd.dense_dd_from_numpy(H0),
                                  tdd.dense_dd_from_numpy(H1)),
                           coeffs4=amp.astype(complex), shape=(N, N))
        Ht, q, mt = tdd.arnoldi_dd(op, T(v), m, dt)
    else:
        extended = kind == "native"
        Hj, _, mj = jarn.arnoldi(
            JOperator([jnp.asarray(H0), jnp.asarray(H1)], amp),
            jnp.asarray(v), m, dt, extended=extended)
        Ht, q, mt = tarn.arnoldi(Operator([T(H0), T(H1)], amp), T(v), m, dt,
                                 extended=extended)
    assert mt == int(mj) == min(N, m)
    assert q.shape == (m + 1, N)
    assert np.abs(Ht - np.asarray(Hj)).max() <= 1e-12
    if N < m:  # the rows past the breakdown stay zero
        assert not q[mt + 1:].any()


# -- (c) the bodies read nothing from the host -------------------------------

def _bodies():
    """Each body with its per-call data as tensors, made here, outside
    the guard."""
    rng = np.random.default_rng(14)
    N = 16
    H0, H1 = _hermitian(rng, N), _hermitian(rng, N, 0.3)
    psi, coeffs = T(_state(rng, N)), T(cheby_coeffs(4.0, 0.1))
    amps = T(np.array([0.7]))
    delta, e_min, dt, one, norm_min = (torch.tensor(x, dtype=torch.float64)
                                       for x in (4.0, -2.0, 0.1, 1.0, 1e-15))
    ops = (T(H0), T(H1))
    dd_terms = build_dd_terms(Operator(list(ops), amps),
                              [sp.csr_matrix(H0.real), sp.csr_matrix(H1)],
                              device="cpu")
    dd_amps = amps.to(torch.complex128)
    return {
        "cheby step": lambda: tcheby._cheby_step(
            ops, amps, psi, coeffs, delta, e_min, dt, True, True),
        "cheby dd step": lambda: tcheby._cheby_step_dd(
            dd_terms, dd_amps, psi, coeffs, 4.0, -2.0, 0.1, True),
        "arnoldi": lambda: tarn._arnoldi_impl(
            ("operator", ops), amps, psi, 10, dt, norm_min, True, True),
        "arnoldi without basis": lambda: tarn._arnoldi_impl(
            ("operator", ops), amps, psi, 10, one, norm_min, False, False),
        "arnoldi dd": lambda: tdd._arnoldi_dd_impl(
            ("terms", dd_terms, (N, N)), dd_amps, psi, 10, 0.1, 1e-12),
    }


@pytest.mark.parametrize("body", sorted(_bodies()))
def test_body_reads_nothing_from_the_host(body):
    call = _bodies()[body]
    want = call()
    with Guard():
        got = call()
    for a, b in zip(scan_mod._leaves(got), scan_mod._leaves(want)):
        assert torch.equal(a, b)


# -- (d) the card's route on the CPU: keys and captures -----------------------

class _Replayed:
    """A captured call's stand-in: a replay runs the body again on the
    static buffers, under the guard, into the static outputs."""

    replays = 0  # over every stand-in

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        _Replayed.replays += 1
        with Guard():
            new = self.fn()
        for o, n in zip(scan_mod._leaves(self.out), scan_mod._leaves(new)):
            o.copy_(n)


def _on_the_card(monkeypatch):
    """Every :class:`Graphed` call takes the card's route with CPU
    tensors: a first call run where it is, a capture a guarded call of
    the body on the static buffers, a replay another."""

    def route(self, arguments):
        if self.mesh is not None and self.mesh.world_size > 1:
            return None, False  # as Graphed._route
        tensors = []
        scan_mod._walk(arguments, tensors, set(), keyed=False)
        return (tensors[0].device if tensors else None), False

    def captured(device, fn, refused, pool=None):
        with Guard():
            out = fn()
        return _Replayed(fn, out), out, ()

    monkeypatch.setattr(scan_mod.Graphed, "_route", route)
    monkeypatch.setattr(scan_mod, "_first_on_side",
                        lambda step, device, fn, what="scan": fn())
    monkeypatch.setattr(scan_mod, "_captured", captured)


def _driven(N=16, n=10):
    rng = np.random.default_rng(15)
    H0, H1 = _hermitian(rng, N), _hermitian(rng, N, 0.3)
    psi = _state(rng, N)
    tlist = np.linspace(0.0, 1.0, n + 1)
    gen = qt.hamiltonian(T(H0), (T(H1), lambda t: np.cos(4.0 * t)))
    return gen, T(psi), tlist


def _run(prop, psi):
    qt.reinit_prop(prop, psi)
    states = []
    while (s := prop.prop_step()) is not None:
        states.append(s)
    return states


def test_interval_captures_once_for_new_controls_and_envelopes(monkeypatch):
    gen, psi, tlist = _driven()
    kw = dict(method="cheby", check_normalization=True,
              specrange_method="diag")
    eager = _run(qt.init_prop(psi, gen, tlist, **kw), psi)
    _on_the_card(monkeypatch)
    prop = qt.init_prop(psi, gen, tlist, **kw)
    graph = _run(prop, psi)
    assert prop._step.captures == 1
    assert all(torch.equal(g, e) for g, e in zip(graph, eager))
    key = prop._step._call.key
    # new controls inside the certified range: the same graph
    (control,) = prop.parameters.keys()
    vals = prop.parameters[control]
    vals[:] = 0.5 * vals[::-1]
    _run(prop, psi)
    # the envelope moves (a wider range), its coefficient count stays
    n_coeffs, delta = len(prop.wrk.coeffs), prop.wrk.delta
    lo, hi = prop.control_ranges[control]
    vals[:] = np.linspace(lo - 0.02, hi + 0.02, len(vals))
    moved = _run(prop, psi)
    assert prop.wrk.delta != delta and len(prop.wrk.coeffs) == n_coeffs
    assert prop._step.captures == 1 and prop._step._call.key == key
    # the replay computes what the body computes for the moved envelope
    monkeypatch.undo()
    assert all(torch.equal(g, e) for g, e in zip(moved, _run(prop, psi)))


@pytest.mark.parametrize("method,precision", [("newton", "native"),
                                              ("newton", "dd"),
                                              ("expv", "native")])
def test_arnoldi_site_replays_across_steps(monkeypatch, method, precision):
    gen, psi, tlist = _driven(n=5)
    # intervals that differ in their last bits, as most grids' do
    assert len(set(np.diff(tlist))) > 1
    kw = dict(method=method, precision=precision, m_max=6)
    eager = _run(qt.init_prop(psi, gen, tlist, **kw), psi)
    _on_the_card(monkeypatch)
    prop = qt.init_prop(psi, gen, tlist, **kw)
    graph = _run(prop, psi)
    _captured_once(prop._arnoldi_sites, method)
    assert all(torch.equal(g, e) for g, e in zip(graph, eager))


def _captured_once(sites, method):
    """The Arnoldi site of a propagator's scope captured once, and the
    site that reads its lent basis (Newton's tail, ``expv``'s combine)
    once for each Krylov dimension it met."""
    from quantumpropagators_torch.ops import expv, newton

    assert sites.captures_of(tarn._arnoldi_impl, tdd._arnoldi_dd_impl) == 1
    tail = newton._newton_tail if method == "newton" else expv._expv_combine
    assert sites.captures_of(tail) == len(sites.parts(tail)) >= 1


def test_envelope_calls_share_one_key(monkeypatch):
    rng = np.random.default_rng(16)
    N = 40
    H0, H1 = _hermitian(rng, N), _hermitian(rng, N, 0.3)
    ops = [T(H0), T(H1)]
    kw = dict(rng=None, state=_state(rng, N), m_max=12)
    want = [specrange(Operator(ops, np.array([a])), "arnoldi", **kw)
            for a in (-1.0, 1.0)]
    _on_the_card(monkeypatch)
    with tarn.arnoldi_sites(tarn.ArnoldiSites()) as sites:
        got = [specrange(Operator(ops, np.array([a])), "arnoldi", **kw)
               for a in (-1.0, 1.0)]
    assert sites.captures == 1 and got == want


def test_function_operators_get_sites_of_their_own(monkeypatch):
    """Plain functions as dd operators in one scope: a key cannot see
    what a function closes over, so a function is keyed by itself (two
    closures of one code differ, a method of one object is equal to
    itself) and each replays a graph of its own, with its own result."""
    rng = np.random.default_rng(17)
    N = 12
    mats = [T(_hermitian(rng, N)), T(_hermitian(rng, N))]
    v = T(_state(rng, N))
    want = [tdd.arnoldi_dd(lambda x, A=A: A @ x, v, 6, 0.1)[0] for A in mats]
    fs = [lambda x: mats[0] @ x, lambda x: mats[1] @ x]
    key = lambda f: scan_mod._walk(f, [], set())
    assert key(fs[0]) != key(fs[1]) and key(fs[0]) == key(fs[0])
    assert key(v.mul) == key(v.mul) != key(T(_state(rng, N)).mul)
    _on_the_card(monkeypatch)
    with tarn.arnoldi_sites() as sites:
        for f, w in zip(fs, want):
            for _ in range(3):
                assert np.array_equal(tdd.arnoldi_dd(f, v, 6, 0.1)[0], w)
    assert sites.captures == 2


def test_standalone_newton_restarts_replay_a_lent_basis(monkeypatch):
    """One ``newton_apply`` outside every propagator opens its own scope:
    its first restart runs eagerly, the second captures, every later one
    replays, and each returns the site's own basis (no clone).  The
    restart tail reads that basis: its site captures once, at its third
    call (the second whose basis is the Arnoldi site's own), and replays
    after."""
    from quantumpropagators_torch.ops.newton import (NewtonInfo,
                                                     _newton_tail,
                                                     newton_apply)

    rng = np.random.default_rng(18)
    N = 32
    op = Operator([T(_hermitian(rng, N, 4.0)), T(_hermitian(rng, N))],
                  np.array([0.5]))
    psi = T(_state(rng, N))
    want = newton_apply(op, psi, 1.0, m_max=5)
    bases, arnoldi = [], tarn.arnoldi

    def kept(*args, **kwargs):
        out = arnoldi(*args, **kwargs)
        bases.append(out[1])
        return out

    _on_the_card(monkeypatch)
    monkeypatch.setattr("quantumpropagators_torch.ops.newton.arnoldi", kept)
    scopes = []
    monkeypatch.setattr(tarn, "ArnoldiSites",
                        lambda: scopes.append(ArnoldiSites()) or scopes[-1])
    before, info = _Replayed.replays, NewtonInfo()
    got = newton_apply(op, psi, 1.0, m_max=5, info=info)
    assert info.restarts >= 3 and len(bases) == info.restarts + 1
    (sites,) = scopes
    assert sites.captures_of(_newton_tail) == 1
    assert _Replayed.replays - before == (len(bases) - 1) + (len(bases) - 2)
    assert bases[1] is bases[-1] and bases[0] is not bases[1]
    assert torch.equal(got, want)


@pytest.mark.parametrize("method", ["cheby", "newton", "expv"])
def test_host_matrices_are_copied_once(monkeypatch, method):
    """A generator of numpy matrices with the state on the device: the
    propagator copies each matrix there once, so no graph copies one at
    a matvec (the guard of a capture refuses ``as_tensor`` of host
    data); one capture, and the result of the body bit for bit."""
    rng = np.random.default_rng(19)
    N = 16
    H0, H1 = _hermitian(rng, N), _hermitian(rng, N, 0.3)
    gen = qt.hamiltonian(H0, (H1, lambda t: np.cos(4.0 * t)))
    psi, tlist = T(_state(rng, N)), np.linspace(0.0, 1.0, 6)
    kw = dict(method=method, m_max=6) if method != "cheby" \
        else dict(method="cheby", specrange_method="diag")
    eager = _run(qt.init_prop(psi, gen, tlist, **kw), psi)
    _on_the_card(monkeypatch)
    prop = qt.init_prop(psi, gen, tlist, **kw)
    graph = _run(prop, psi)
    if method == "cheby":
        assert prop._step.captures == 1
    else:
        _captured_once(prop._arnoldi_sites, method)
    assert all(torch.equal(g, e) for g, e in zip(graph, eager))


def test_multi_rank_generator_runs_the_interval_body(monkeypatch):
    """A generator sharded over a group of two ranks (a one-process mesh
    that says so): the interval and the envelope's Arnoldi run their
    bodies, as no cross-rank exchange is captured."""
    from quantumpropagators_torch.models.lattice import transverse_field_ising
    from quantumpropagators_torch.parallel import (chain_mesh,
                                                   shard_chain_operator,
                                                   shard_vector)

    L = 6
    Hd, Hx = transverse_field_ising(L, g=1.2, h=0.3, dtype=torch.complex128,
                                    device="cpu")
    mesh = chain_mesh(2, device="cpu")
    mesh.world_size = 2
    gen = qt.hamiltonian(shard_chain_operator(
        qt.Operator([Hd, Hx], np.array([1.0])), mesh, group_bits=2))
    psi = shard_vector(mesh, _state(np.random.default_rng(20), 2 ** L))
    tlist = np.linspace(0.0, 0.3, 4)
    init = lambda: qt.init_prop(psi, gen, tlist, method="cheby",
                                rng=np.random.default_rng(1))
    eager = _run(init(), psi)
    _on_the_card(monkeypatch)
    scopes = []
    monkeypatch.setattr(tcheby, "ArnoldiSites",
                        lambda: scopes.append(tarn.ArnoldiSites())
                        or scopes[-1])
    prop = init()
    graph = _run(prop, psi)
    assert prop._step.mesh is mesh and prop._step.captures == 0
    assert scopes and all(s.captures == 0 for s in scopes)
    assert all(torch.equal(g, e) for g, e in zip(graph, eager))
