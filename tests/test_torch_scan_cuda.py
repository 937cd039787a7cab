"""The port's scan on the card: each routed path as its two replayed
CUDA graphs (A from carry buffer 0 into buffer 1, B back, no carry
copy) against the eager loop of the same step, bit for bit and with
equal kernel launches, for odd and even interval counts; one capture
(two graphs) for three control tables through
``make_fused_cheby_propagator`` and for every length of a step without
per-step inputs; the first interval eager where the carry changes type;
a step that takes ``out`` but returns other tensors refused at capture;
no garbage collection while a graph captures; a step that closes over
a tensor requiring grad runs
as the loop, with the loop's gradient; a step that reads the host
raises at capture; repeated captures stay in one memory pool.  The
scan's gradient (``utils/scan._Tape``): the graphed forward and backward
against the loop under autograd, bit for bit (the replays run the
loop's kernels on the same values, and each interval's VJP sums the
same cotangents in the loop's order); one forward and one backward
capture for three tables; a VJP that reads the host raises at its
capture; a 2^16 chain's stacks hold no constant.  Needs an NVIDIA GPU
with nvcc (``-m cuda``); skips without one.  Imports no jax: run with
``--noconftest``."""

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


def _path(name, device, tlist=TLIST):
    """Run the routed path ``name`` once over ``tlist`` (the steps of
    ``TLIST``); returns ``(state, outputs)``."""
    psi = _state(2 ** L, 3, device)
    ws = ChebyWorkspace.create(12.0, -6.5, float(tlist[1] - tlist[0]))
    if name.startswith("dd"):
        tail = 2 if name.endswith("tail") else 0
        return fused.cheby_propagate_fused(
            psi, _chain(device, multi="multi" in name), tlist, kernel="dd",
            f32_tail=tail, observable_fn=_obs, **ENVELOPE)
    if name == "pallas f32":
        return fused.cheby_propagate_fused(
            psi.to(torch.complex64), _chain(device), tlist, kernel="pallas",
            store_states=True, **ENVELOPE)
    if name == "xla":
        return fused.cheby_propagate_fused(psi, _chain(device), tlist,
                                           kernel="xla", observable_fn=_obs,
                                           **ENVELOPE)
    if name in ("banded static", "bsr static"):
        return fused.cheby_propagate_fused(
            psi, _banded(device, name == "banded static"), tlist,
            workspace=ws, kernel="dd", store_states=True)
    if name == "leja":
        out, ys, _ = newton_leja.newton_leja_propagate_dd(
            psi, _banded(device), tlist, e_min=-6.5, e_max=5.5,
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


def _captured_scans(monkeypatch):
    """The :class:`_Graph` objects that capture from now on."""
    graphs = []
    capture = scan_mod._Graph._capture

    def recorded(self):
        if self not in graphs:
            graphs.append(self)
        capture(self)

    monkeypatch.setattr(scan_mod._Graph, "_capture", recorded)
    return graphs


@pytest.mark.parametrize("name", PATHS)
def test_graph_equals_eager_loop(cuda, name, monkeypatch):
    made = []
    real = torch.cuda.CUDAGraph

    def counted(*args, **kwargs):
        made.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", counted)
    scans = _captured_scans(monkeypatch)
    cf.reset_launches()
    bs.reset_launches()
    graph = _path(name, cuda)
    torch.cuda.synchronize()
    n_graph = _counts()
    # the two graphs of the step, which writes its carry into out=
    assert len(made) == 2
    assert [s.carry_copies for s in scans] == [0]
    with monkeypatch.context() as m:
        _eager(m)
        cf.reset_launches()
        bs.reset_launches()
        eager = _path(name, cuda)
        torch.cuda.synchronize()
        n_eager = _counts()
    assert len(made) == 2
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
        with monkeypatch.context() as m:
            _loop_scans(m)
            want = fn(psi, table.clone().requires_grad_(True))
        # under autograd: the tape's own two graphs, captured once
        graphed = fn(psi, table.clone().requires_grad_(True))
        for g, w, a in zip(got, want, graphed):
            assert torch.equal(g, w.detach()) and torch.equal(a.detach(), g)
    # the forward's two graphs, the tape's forward and backward
    assert len(made) == 4


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


def test_refused_capture_leaves_the_cache_releasable(cuda):
    """After a capture refused for a host read, memory freed later goes
    back to the card on ``empty_cache``: the allocator no longer counts
    the failed capture as under way."""
    def reads_host(p):
        return torch.tensor(p.abs().max().item(), device=p.device)

    with pytest.raises(RuntimeError, match="cannot be captured"):
        fused.cheby_propagate_fused(_state(2 ** L, 6, cuda), _chain(cuda),
                                    TLIST, kernel="dd",
                                    observable_fn=reads_host, **ENVELOPE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(cuda)
    x = torch.empty(1 << 28, device=cuda)
    del x
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(cuda) <= before


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

    def step(psi, _, out=None):
        return cheby_step_fused_dd(plan, dmb, psi, c64, 30.0, -15.0,
                                   0.05, out=out), None

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
    # one capture: the step's two graphs
    assert len(made) == 2 and run._graph.carry_copies == 0


@pytest.mark.parametrize("n", [2, 3, 6, 7])
@pytest.mark.parametrize("name", ["dd single tail", "pallas f32", "xla",
                                  "banded static", "leja"])
def test_two_graphs_equal_the_loop_at_every_count(cuda, name, n,
                                                  monkeypatch):
    """``n`` intervals (the last carry in buffer 1 for even ``n``, in
    buffer 0 for odd) against the loop: the final carry and the outputs
    bit for bit, no carry copy."""
    tlist = np.linspace(0.0, 0.05 * n, n + 1)
    scans = _captured_scans(monkeypatch)
    graph = _path(name, cuda, tlist)
    assert [s.carry_copies for s in scans] == [0]
    with monkeypatch.context() as m:
        _eager(m)
        eager = _path(name, cuda, tlist)
    torch.cuda.synchronize()
    for g, e in zip(graph, eager):
        assert g.shape == e.shape and torch.equal(g, e)


def test_rerun_after_odd_then_even_counts(cuda):
    """One capture of a step without ``xs`` and outputs, called at 3, 4,
    7 and 2 intervals: each call starts from the caller's carry in
    buffer 0 and returns the buffer its last replay wrote."""
    from quantumpropagators_torch.ops.fused_cheby_dd import (
        cheby_step_fused_dd, make_flip_plan)

    plan = make_flip_plan(L, 1.1)
    c64 = np.asarray(ChebyWorkspace.create(30.0, -15.0, 0.05).coeffs)
    dmb = torch.zeros(2 ** L, dtype=torch.float64, device=cuda)

    def step(psi, _, out=None):
        return cheby_step_fused_dd(plan, dmb, psi, c64, 30.0, -15.0, 0.05,
                                   f32_tail=2, out=out), None

    run = scan_mod.GraphedScan(step)
    psi = _state(2 ** L, 10, cuda)
    graph = None
    for n in (3, 4, 7, 2):
        got, _ = run(psi, None, n)
        graph = graph or run._graph
        assert run._graph is graph and graph.carry_copies == 0
        assert torch.equal(got, scan_mod._loop(step, psi, None, n)[0])


def test_first_interval_eager_then_two_graphs(cuda):
    """A real state becomes complex at interval 0: that interval runs
    eagerly, without ``out``, on every call, then the two graphs."""
    ws = ChebyWorkspace.create(2.0 * BOUND + 1.0, -BOUND - 0.5, 0.05)
    step = fused._with_outputs(fused._generic_step(
        list(_chain(cuda).ops), np.asarray(ws.coeffs), ws.delta, ws.e_min,
        ws.dt, True, None), _obs, False)
    table = torch.as_tensor(np.random.default_rng(3).uniform(
        0.8, 1.4, (5, 2)), device=cuda)
    psi = _state(2 ** L, 5, cuda).real.contiguous()
    run = scan_mod.GraphedScan(step)
    for scale in (1.0, 1.1):
        got = run(psi, table * scale)
        want = scan_mod._loop(step, psi, table * scale, 5)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert run._graph.first_eager and run._graph.carry_copies == 0


def test_out_step_returning_other_tensors_raises(cuda):
    """A step that takes ``out`` but returns another tensor is refused
    at capture, naming it; the card runs on."""
    def doubles(c, x, out=None):
        return c * x, None

    xs = torch.linspace(0.5, 1.5, 3, device=cuda, dtype=torch.float64)
    c0 = torch.ones(8, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="doubles takes out= but returned"):
        scan_mod.scan(doubles, c0, xs)
    out, _ = scan_mod.scan(lambda c, x: (c * x, None), c0, xs)
    torch.cuda.synchronize()
    assert torch.equal(out, c0 * 0.5 * 1.0 * 1.5)


def test_no_garbage_collection_while_capturing(cuda):
    """A graph left in a reference cycle and destroyed by the garbage
    collector during a capture would end that capture ("operation not
    permitted when stream is capturing"): the collector is off while
    each of the two graphs captures, and on again after."""
    import gc

    seen = []

    def step(c, x, out=None):
        seen.append(gc.isenabled())
        return torch.mul(c, x, out=out), None

    xs = torch.linspace(0.5, 1.5, 4, device=cuda, dtype=torch.float64)
    c0 = torch.ones(8, device=cuda, dtype=torch.float64)
    got, _ = scan_mod.scan(step, c0, xs)
    assert seen == [True, False, False] and gc.isenabled()
    torch.cuda.synchronize()
    assert torch.equal(got, scan_mod._loop(step, c0, xs, 4)[0])


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


# -- the scan's gradient ------------------------------------------------------

def _loop_scans(monkeypatch):
    """Route every :class:`GraphedScan` through the plain loop: the scan
    under autograd before the tape."""
    monkeypatch.setattr(scan_mod.GraphedScan, "_run",
                        lambda self, carry, xs, length: (scan_mod._loop(
                            self.step, carry, xs,
                            scan_mod._length(xs, length)), False))


def _grad_problem(name, device, output):
    """``(fn, psi0, table)``: the two-level GRAPE problem of
    ``examples/grape_state_transfer_torch.py`` (80 intervals) or the
    L = 12 driven chain (5 intervals), through
    ``make_fused_cheby_propagator`` with ``output`` per interval."""
    if name == "grape":
        sx = torch.tensor([[0, 1], [1, 0]], dtype=torch.complex128,
                          device=device)
        sz = torch.tensor([[1, 0], [0, -1]], dtype=torch.complex128,
                          device=device)
        gen = qt.hamiltonian(0.0 * sz, (sx, lambda t: 0.3 * qt.flattop(
            t, T=2.0, t_rise=0.5)))
        tlist = np.linspace(0, 2.0, 81)
        psi = torch.tensor([1, 0], dtype=torch.complex128, device=device)
        env = dict(E_min=-4.0, E_max=4.0, specrange_method="manual")
    else:
        gen, tlist, psi, env = _chain(device), TLIST, _state(2 ** L, 12,
                                                              device), ENVELOPE
    kw = {"observable": dict(observable_fn=_obs),
          "states": dict(store_states=True), "final": {}}[output]
    fn = fused.make_fused_cheby_propagator(psi, gen, tlist, **kw, **env)
    return fn, psi, qt.coeff_table(gen, tlist).to(device)


def _grads(fn, psi, table):
    """A loss of the final state and the outputs, and its gradients with
    respect to the table and ``psi0``."""
    t = table.clone().requires_grad_(True)
    p = psi.clone().requires_grad_(True)
    fin, ys = fn(p, t)
    w = torch.linspace(0.5, 1.5, fin.numel(), device=fin.device,
                       dtype=torch.float64)
    loss = (fin.abs() ** 2 * w).sum()
    if ys is not None:
        loss = loss + (ys.abs() ** 2).sum() * 0.5
    return fin, loss, torch.autograd.grad(loss, (t, p))


@pytest.mark.parametrize("output", ["final", "observable", "states"])
@pytest.mark.parametrize("name", ["grape", "chain"])
def test_graphed_gradient_equals_the_loop(cuda, name, output, monkeypatch):
    """Forward and backward as replays of the tape's two graphs against
    the loop under autograd: the final state, the loss and the table's
    and ``psi0``'s gradients bit for bit, on the first call (interval 0
    eager, slot 0 from it) and on the second (every interval
    replayed)."""
    fn, psi, table = _grad_problem(name, cuda, output)
    got = [_grads(fn, psi, table), _grads(fn, psi, table * 1.1)]
    assert type(got[0][0].grad_fn).__name__ == "_ScanVJPBackward"
    _loop_scans(monkeypatch)
    for (fin, loss, grads), tb in zip(got, (table, table * 1.1)):
        w_fin, w_loss, want = _grads(fn, psi, tb)
        assert torch.equal(fin, w_fin) and torch.equal(loss, w_loss)
        for g, w in zip(grads, want):
            assert torch.equal(g, w)


def test_one_forward_and_one_backward_capture_for_three_tables(cuda,
                                                               monkeypatch):
    """GRAPE's loop on the card: three tables, each a forward and a
    backward, replay one forward and one backward graph."""
    fn, psi, table = _grad_problem("grape", cuda, "final")
    made = _counting_graphs(monkeypatch)
    grads = [_grads(fn, psi, table * s)[2][0] for s in (1.0, 0.8, 1.3)]
    assert len(made) == 2
    assert all(bool(torch.isfinite(g).all()) for g in grads)


class _ReadsHostInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return g * (2 + 0 * g.abs().max().item())


def test_vjp_reading_the_host_raises(cuda):
    """A step whose backward calls ``.item()``: the forward replays, the
    backward's capture raises naming the step; the card runs on."""
    def host_vjp_step(c, x):
        return _ReadsHostInBackward.apply(c) * x, None

    xs = torch.linspace(0.5, 1.0, 4, device=cuda,
                        dtype=torch.float64).requires_grad_(True)
    c0 = torch.ones(8, device=cuda, dtype=torch.float64)
    with pytest.raises(RuntimeError,
                       match="scan backward: step .*host_vjp_step.* cannot "
                             "be captured"):
        scan_mod.scan(host_vjp_step, c0, xs)
    out, _ = scan_mod.scan(lambda c, x: (c * x, None), c0, xs)
    g, = torch.autograd.grad(out.sum(), xs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(g).all())


def test_stack_of_a_2_16_chain_holds_no_constant(cuda):
    """At 2^16 the chain's diagonal is kept by reference and no stack
    holds it; the stacks take one slot an interval and one stack a saved
    storage."""
    L16 = 16
    H_diag, H_x = qt.transverse_field_ising(L16, J=1.0, g=1.0, h=0.3,
                                            dtype=torch.float64,
                                            device=cuda)
    gen = qt.hamiltonian((H_diag, lambda t: 1.0 + 0.3 * np.sin(0.9 * t)),
                         (H_x, lambda t: 1.2 + 0.4 * np.cos(1.7 * t)),
                         check=False)
    bound = 1.3 * (1.0 * (L16 - 1) + 0.3 * L16) + 1.6 * L16
    psi = _state(2 ** L16, 13, cuda)
    fn = fused.make_fused_cheby_propagator(
        psi, gen, TLIST, specrange_method="manual", E_min=-bound - 0.5,
        E_max=bound)
    table = qt.coeff_table(gen, TLIST).to(cuda).requires_grad_(True)
    fn(psi, table)
    run = fn.__closure__[fn.__code__.co_freevars.index("run")].cell_contents
    saved = run._tape.saved
    views = [e for e in saved.entries if e[0] is not None]
    kept = {e[1].untyped_storage().data_ptr() for e in saved.entries
            if e[0] is None}
    assert H_diag.diag.untyped_storage().data_ptr() in kept
    assert all(t.shape[0] == len(TLIST) - 1 for t in saved.stacks)
    assert not any(dtype == torch.float64 and shape == (2 ** L16,)
                   for _, dtype, shape, _, _ in views)
