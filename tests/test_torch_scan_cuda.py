"""The port's scan on the card: each routed path as a replayed CUDA graph
against the eager loop of the same step, bit for bit and with equal
kernel launches; one capture for three control tables through
``make_fused_cheby_propagator`` and for every length of a step without
per-step inputs; a step that closes over a tensor requiring grad runs
as the loop, with the loop's gradient; a step that reads the host
raises at capture; repeated captures stay in one memory pool.  Needs
an NVIDIA GPU with nvcc (``-m cuda``); skips without one.  Imports no
jax: run with ``--noconftest``."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import quantumpropagators_torch as qt
from quantumpropagators_torch import fused
from quantumpropagators_torch.models.lattice import SiteOperatorSum
from quantumpropagators_torch.ops import banded_spmv as bs
from quantumpropagators_torch.ops import cheby_flip as cf
from quantumpropagators_torch.ops import newton_leja
from quantumpropagators_torch.ops.cheby import ChebyWorkspace
from quantumpropagators_torch.utils import scan as scan_mod

pytestmark = pytest.mark.cuda

L = 12
TLIST = np.linspace(0.0, 0.25, 6)
BOUND = 1.3 * (1.0 * (L - 1) + 0.3 * L) + 1.6 * L
ENVELOPE = dict(specrange_method="manual", E_min=-BOUND - 0.5, E_max=BOUND)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", 0)
    # the process's graph pool and its one-node keeper graph, made before
    # the tests count captures
    scan_mod._graph_pool(device)
    return device


def _state(n, seed, device, dtype=torch.complex128):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return torch.as_tensor(v / np.linalg.norm(v)).to(device, dtype)


def _chain(device, multi=False):
    H_diag, H_x = qt.transverse_field_ising(L, J=1.0, g=1.0, h=0.3,
                                            dtype=torch.float64,
                                            device=device)
    eps_d = lambda t: 1.0 + 0.3 * np.sin(0.9 * t)
    eps_g = lambda t: 1.2 + 0.4 * np.cos(1.7 * t)
    if not multi:
        return qt.hamiltonian((H_diag, eps_d), (H_x, eps_g), check=False)
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    g_site = np.random.default_rng(29).uniform(0.9, 1.3, L)

    def group(parity):
        mats = np.zeros((L, 2, 2))
        for i in range(L):
            if i % 2 == parity:
                mats[i] = g_site[i] * sx
        return SiteOperatorSum(torch.as_tensor(mats, device=device), L=L,
                               active=tuple(i % 2 == parity
                                            for i in range(L)))

    return qt.hamiltonian((H_diag, eps_d), (group(1), eps_g),
                          (group(0), lambda t: 0.9 + 0.5 * np.sin(2.3 * t)),
                          check=False)


def _banded(device, banded=True):
    rng = np.random.default_rng(91)
    N = 2 ** L
    A = sp.diags([rng.normal(size=N - 2), rng.normal(size=N - 1),
                  rng.normal(size=N), rng.normal(size=N - 1),
                  rng.normal(size=N - 2)], [-2, -1, 0, 1, 2]).tolil()
    if not banded:
        # a coupling at every block distance: the blocked-ELL product
        for d in range(1, N // 128):
            A[0, 128 * d] = A[128 * d, 0] = 0.1 * d
    A = A.tocsr()
    A = (0.5 * (A + A.T)).tocsr()
    return qt.bsr_from_scipy(A, block_size=128, device=device)


def _obs(p):
    return torch.vdot(p, p).real


def _path(name, device):
    """Run the routed path ``name`` once; returns ``(state, outputs)``."""
    psi = _state(2 ** L, 3, device)
    ws = ChebyWorkspace.create(12.0, -6.5, float(TLIST[1] - TLIST[0]))
    if name.startswith("dd"):
        tail = 2 if name.endswith("tail") else 0
        return fused.cheby_propagate_fused(
            psi, _chain(device, multi="multi" in name), TLIST, kernel="dd",
            f32_tail=tail, observable_fn=_obs, **ENVELOPE)
    if name == "pallas f32":
        return fused.cheby_propagate_fused(
            psi.to(torch.complex64), _chain(device), TLIST, kernel="pallas",
            store_states=True, **ENVELOPE)
    if name == "xla":
        return fused.cheby_propagate_fused(psi, _chain(device), TLIST,
                                           kernel="xla", observable_fn=_obs,
                                           **ENVELOPE)
    if name in ("banded static", "bsr static"):
        return fused.cheby_propagate_fused(
            psi, _banded(device, name == "banded static"), TLIST,
            workspace=ws, kernel="dd", store_states=True)
    if name == "leja":
        out, ys, _ = newton_leja.newton_leja_propagate_dd(
            psi, _banded(device), TLIST, e_min=-6.5, e_max=5.5,
            observable_fn=_obs)
        return out, ys
    raise KeyError(name)


PATHS = ["dd single tail", "dd single", "dd multi tail", "dd multi",
         "pallas f32", "xla", "banded static", "bsr static", "leja"]


def _counts():
    return {**cf.LAUNCHES, **bs.LAUNCHES}


def _eager(monkeypatch):
    """Route every scan through the eager loop of the same step."""
    def loop(step, carry, xs=None, length=None):
        return scan_mod._loop(step, carry, xs, scan_mod._length(xs, length))

    for mod in (scan_mod, fused, newton_leja):
        monkeypatch.setattr(mod, "scan", loop)


@pytest.mark.parametrize("name", PATHS)
def test_graph_equals_eager_loop(cuda, name, monkeypatch):
    made = []
    real = torch.cuda.CUDAGraph

    def counted(*args, **kwargs):
        made.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", counted)
    cf.reset_launches()
    bs.reset_launches()
    graph = _path(name, cuda)
    torch.cuda.synchronize()
    n_graph = _counts()
    assert len(made) == 1
    with monkeypatch.context() as m:
        _eager(m)
        cf.reset_launches()
        bs.reset_launches()
        eager = _path(name, cuda)
        torch.cuda.synchronize()
        n_eager = _counts()
    assert len(made) == 1
    assert n_graph == n_eager
    if name not in ("xla", "bsr static"):
        assert sum(n_graph.values()) > 0
    for g, e in zip(graph, eager):
        assert g.shape == e.shape and g.dtype == e.dtype
        assert torch.equal(g, e)


def test_one_capture_for_three_tables(cuda, monkeypatch):
    made = []
    real = torch.cuda.CUDAGraph

    def counted(*args, **kwargs):
        made.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", counted)
    H_diag, H_x = qt.transverse_field_ising(L, J=1.0, g=1.0, h=0.3,
                                            dtype=torch.float64,
                                            device=cuda)
    gen = qt.hamiltonian(H_diag, (H_x, lambda t: 1.0), check=False)
    psi = _state(2 ** L, 4, cuda)
    fn = fused.make_fused_cheby_propagator(psi, gen, TLIST,
                                           observable_fn=_obs, **ENVELOPE)
    rng = np.random.default_rng(5)
    for _ in range(3):
        table = torch.as_tensor(rng.uniform(0.8, 1.6, (len(TLIST) - 1, 1)),
                                device=cuda)
        with torch.no_grad():
            got = fn(psi, table)
        want = fn(psi, table.clone().requires_grad_(True))  # the loop
        for g, w in zip(got, want):
            assert torch.equal(g, w.detach())
    assert len(made) == 1


@pytest.mark.parametrize("where", ["host", "card"])
def test_host_read_raises_at_capture(cuda, where):
    """An observable that calls ``.item()``: returning a host tensor it
    is refused after the eager first interval, returning a card tensor
    at the capture; the card runs the path after either."""
    def reads_host(p):
        value = p.abs().max().item()
        return torch.tensor(value, device=p.device if where == "card"
                            else "cpu")

    with pytest.raises(RuntimeError, match="cannot be captured"):
        fused.cheby_propagate_fused(_state(2 ** L, 6, cuda), _chain(cuda),
                                    TLIST, kernel="dd",
                                    observable_fn=reads_host, **ENVELOPE)
    out, ys = fused.cheby_propagate_fused(_state(2 ** L, 6, cuda),
                                          _chain(cuda), TLIST, kernel="dd",
                                          observable_fn=_obs, **ENVELOPE)
    torch.cuda.synchronize()
    assert torch.isfinite(ys).all() and abs(float(ys[-1]) - 1.0) < 1e-12


def _counting_graphs(monkeypatch):
    made = []
    real = torch.cuda.CUDAGraph

    def counted(*args, **kwargs):
        made.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", counted)
    return made


def test_closed_over_grad_runs_the_loop(cuda, monkeypatch):
    """A step that closes over a parameter requiring grad (the operator
    matrix a user differentiates through): no capture, the loop's
    results and the loop's gradient, bit for bit."""
    made = _counting_graphs(monkeypatch)
    rng = np.random.default_rng(8)
    m = torch.as_tensor(rng.standard_normal((64, 64)) / 8, device=cuda)
    w = m.clone().requires_grad_(True)
    xs = torch.as_tensor(rng.uniform(0.5, 1.5, 7), device=cuda)
    c0 = torch.as_tensor(rng.standard_normal(64), device=cuda)

    def step(c, x):
        c = torch.tanh(x * (w @ c))
        return c, c.sum()

    got = scan_mod.scan(step, c0, xs)
    want = scan_mod._loop(step, c0, xs, 7)
    assert not made
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    g_got, = torch.autograd.grad(got[0].sum() + got[1].sum(), w)
    g_want, = torch.autograd.grad(want[0].sum() + want[1].sum(), w)
    assert torch.equal(g_got, g_want)
    with torch.no_grad():
        graphed = scan_mod.scan(step, c0, xs)
    assert len(made) == 1 and torch.equal(graphed[0], want[0].detach())


def test_one_capture_for_every_length(cuda, monkeypatch):
    """A step without ``xs`` and outputs (``bench_torch.py``'s loops):
    one :class:`GraphedScan` captures once and replays each length,
    equal to the loop of that length."""
    from quantumpropagators_torch.ops.fused_cheby_dd import (
        cheby_step_fused_dd, make_flip_plan)

    made = _counting_graphs(monkeypatch)
    # H = β + Σ_j 1.1 X_j (dmb = 0): spectrum ±13.2 inside [−15, 15]
    plan = make_flip_plan(L, 1.1)
    c64 = np.asarray(ChebyWorkspace.create(30.0, -15.0, 0.05).coeffs)
    dmb = torch.zeros(2 ** L, dtype=torch.float64, device=cuda)

    def step(psi, _):
        return cheby_step_fused_dd(plan, dmb, psi, c64, 30.0, -15.0,
                                   0.05), None

    run = scan_mod.GraphedScan(step)
    psi = _state(2 ** L, 9, cuda)
    for n in (2, 6, 3):
        cf.reset_launches()
        got, _ = run(psi, None, n)
        graph_counts = dict(cf.LAUNCHES)
        cf.reset_launches()
        want, _ = scan_mod._loop(step, psi, None, n)
        assert graph_counts == dict(cf.LAUNCHES)
        assert torch.equal(got, want)
    assert len(made) == 1


def test_captures_share_one_pool(cuda):
    """Each propagation captures anew, into the process's one graph pool:
    the memory the card holds stops growing after the first call (a
    pool per graph grew by the step's temporaries every call)."""
    reserved = []
    for _ in range(4):
        fused.cheby_propagate_fused(_state(2 ** L, 7, cuda), _chain(cuda),
                                    TLIST, kernel="dd", **ENVELOPE)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(cuda))
    assert reserved[1] == reserved[2] == reserved[3]
