"""The scan's ``out`` protocol on the CPU (``utils/scan.py``): every
routed step of the port, taken from its entry point, writes its new
state into a given buffer and returns it, equal bit for bit to the same
step without ``out``, and leaves its input state as it was.  The steps
without ``out`` are held against the JAX package by the
``test_torch_fused_*`` and ``test_torch_scan*`` files, so bit equality
carries that comparison over.

Then the two-graph replay (``_Graph``) with each capture stood in for by
a recorded interval: graph against loop for odd and even interval
counts, a second call of one capture at other lengths, the first
interval eager where the carry changes type, no carry copy on the port's
steps, one copy a replay for a step without ``out``, and a step that
takes ``out`` but returns other tensors refused at capture."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import quantumpropagators_torch as qt
from quantumpropagators_torch import fused, set_default_device
from quantumpropagators_torch.ops import newton_leja
from quantumpropagators_torch.ops.cheby import ChebyWorkspace
from quantumpropagators_torch.utils import scan as scan_mod

set_default_device("cpu")

L = 10
BOUND = 1.3 * (1.0 * (L - 1) + 0.3 * L) + 1.6 * L
ENVELOPE = dict(specrange_method="manual", E_min=-BOUND - 0.5, E_max=BOUND)
TLIST = np.linspace(0.0, 0.15, 4)


def _state(n, seed, dtype=torch.complex128):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return torch.as_tensor(v / np.linalg.norm(v)).to(dtype)


def _chain():
    H_diag, H_x = qt.transverse_field_ising(L, J=1.0, g=1.0, h=0.3,
                                            dtype=torch.float64)
    return qt.hamiltonian((H_diag, lambda t: 1.0 + 0.3 * np.sin(0.9 * t)),
                          (H_x, lambda t: 1.2 + 0.4 * np.cos(1.7 * t)),
                          check=False)


def _banded(banded=True, N=64):
    """A static real pentadiagonal operator of blocks of 8 (the banded
    route on the CPU), or with couplings at every block distance (the
    blocked-ELL product)."""
    rng = np.random.default_rng(91)
    A = sp.diags([rng.normal(size=N - 2), rng.normal(size=N - 1),
                  rng.normal(size=N), rng.normal(size=N - 1),
                  rng.normal(size=N - 2)], [-2, -1, 0, 1, 2]).tolil()
    if not banded:
        for d in range(1, N // 8):
            A[0, 8 * d] = A[8 * d, 0] = 0.1 * d
    A = A.tocsr()
    return qt.bsr_from_scipy((0.5 * (A + A.T)).tocsr(), block_size=8)


def _obs(p):
    return torch.vdot(p, p).real


def _run(name, tlist):
    """Run the routed path ``name`` over ``tlist`` at its entry point."""
    psi = _state(2 ** L, 3)
    if name.startswith("dd"):
        return fused.cheby_propagate_fused(
            psi, _chain(), tlist, kernel="dd",
            f32_tail=2 if name.endswith("tail") else 0,
            observable_fn=_obs, **ENVELOPE)
    if name.startswith("flip"):
        dtype = torch.complex64 if name.endswith("64") else torch.complex128
        return fused.cheby_propagate_fused(
            psi.to(dtype), _chain(), tlist, kernel="pallas",
            store_states=name.startswith("flip states"), **ENVELOPE)
    if name == "generic":
        return fused.cheby_propagate_fused(psi, _chain(), tlist,
                                           kernel="xla", observable_fn=_obs,
                                           **ENVELOPE)
    ws = ChebyWorkspace.create(12.0, -6.5, 0.05)
    if name in ("banded dd states", "bsr static"):
        return fused.cheby_propagate_fused(
            _state(64, 4), _banded(name == "banded dd states"), tlist,
            workspace=ws, kernel="dd", store_states=True)
    if name == "leja":
        return newton_leja.newton_leja_propagate_dd(
            _state(64, 4), _banded(), tlist, e_min=-6.5, e_max=5.5,
            observable_fn=_obs)
    raise KeyError(name)


def _recorded(name, monkeypatch, tlist=TLIST):
    """The ``(step, carry, xs, length)`` of the scan that ``name`` starts
    over ``tlist``."""
    calls = []

    def recorded(step, carry, xs=None, length=None):
        calls.append((step, carry, xs, length))
        return scan_mod.scan(step, carry, xs, length)

    with monkeypatch.context() as m:
        for mod in (fused, newton_leja):
            m.setattr(mod, "scan", recorded)
        _run(name, tlist)
    return calls[-1]


STEPS = ["flip complex64", "flip complex128", "flip states complex64",
         "dd tail", "dd", "generic", "banded dd states", "bsr static", "leja"]


@pytest.mark.parametrize("name", STEPS)
def test_step_writes_out(name, monkeypatch):
    """``step(psi, x, out=buf)`` returns ``buf``, equal bit for bit to
    ``step(psi, x)``, with the same output, and ``psi`` untouched (one
    case stores the state itself as its output, through
    ``fused._with_outputs``)."""
    step, carry, xs, _ = _recorded(name, monkeypatch)
    assert scan_mod._takes_out(step)
    x = scan_mod._map(lambda t: t[1], xs)
    before = carry.clone()
    want, want_y = step(carry, x)
    buf = torch.full_like(want, float("nan"))
    got, got_y = step(carry, x, out=buf)
    assert got is buf
    assert torch.equal(got, want) and torch.equal(carry, before)
    assert (got_y is None) == (want_y is None)
    if want_y is not None:
        assert torch.equal(got_y, want_y)
        if "states" in name:
            assert got_y.data_ptr() == buf.data_ptr()


# -- the two-graph replay, each capture a recorded interval ------------------

class _Recorded:
    """A captured graph's stand-in: a replay runs the interval."""

    def __init__(self, fn):
        self.replay = fn


@pytest.fixture
def recorded_graphs(monkeypatch):
    """``_Graph`` on the CPU as on the card, each capture a recorded
    interval: the interval runs once at the capture (its checks) and its
    buffers are put back, as a capture runs nothing on the device."""
    monkeypatch.setattr(scan_mod, "_on_card", lambda carry, xs: True)
    monkeypatch.setattr(scan_mod, "_first_on_side",
                        lambda step, device, fn: fn())

    capturing = []

    def captured(device, fn, refused):
        graph = capturing[-1]
        kept = scan_mod._leaves(graph.bufs) + [graph.counter] \
            + scan_mod._leaves(graph.ys)
        saved = [t.clone() for t in kept]
        try:
            fn()
        finally:
            for t, v in zip(kept, saved):
                t.copy_(v)
        return _Recorded(fn), None, ()

    monkeypatch.setattr(scan_mod, "_captured", captured)
    capture = scan_mod._Graph._capture

    def dry(self):
        capturing.append(self)
        capture(self)

    monkeypatch.setattr(scan_mod._Graph, "_capture", dry)


def _equal(a, b):
    la, lb = scan_mod._leaves(a), scan_mod._leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def _rows(xs, n):
    return scan_mod._map(lambda t: t[:n], xs)


@pytest.mark.parametrize("name", ["dd", "flip states complex64",
                                  "banded dd states", "leja"])
def test_two_graphs_equal_the_loop(name, monkeypatch, recorded_graphs):
    """Graph against loop for 2, 3, 6 and 7 intervals (the last carry in
    either buffer), with no carry copy; a second call replays all of
    them from the caller's carry (at n = 2 capturing graph B then)."""
    step, carry, xs, _ = _recorded(name, monkeypatch,
                                   np.linspace(0.0, 0.35, 8))
    for n in (2, 3, 6, 7):
        run = scan_mod.GraphedScan(step)
        want = scan_mod._loop(step, carry, _rows(xs, n), n)
        assert _equal(run(carry, _rows(xs, n), n), want)
        # graph B is captured at its first replay: none at n = 2
        graph = run._graph
        assert len(graph.graphs) == min(n - 1, 2) and graph.carry_copies == 0
        assert _equal(run(carry, _rows(xs, n), n), want)
        assert len(graph.graphs) == 2


def test_one_capture_at_every_length(recorded_graphs):
    """A step without ``xs`` and outputs (``bench_torch.py``'s loops):
    one capture replays an odd count, then even ones, each equal to the
    loop of that length."""
    from quantumpropagators_torch.ops.fused_cheby_dd import (
        cheby_step_fused_dd, make_flip_plan)

    plan = make_flip_plan(L, 1.1)
    c64 = np.asarray(ChebyWorkspace.create(30.0, -15.0, 0.05).coeffs)
    dmb = torch.zeros(2 ** L, dtype=torch.float64)

    def step(psi, _, out=None):
        return cheby_step_fused_dd(plan, dmb, psi, c64, 30.0, -15.0, 0.05,
                                   out=out), None

    run = scan_mod.GraphedScan(step)
    psi = _state(2 ** L, 9)
    graph = None
    for n in (3, 6, 2, 5):
        got, _ = run(psi, None, n)
        graph = graph or run._graph
        assert run._graph is graph and graph.carry_copies == 0
        assert torch.equal(got, scan_mod._loop(step, psi, None, n)[0])


def test_first_interval_eager_then_two_graphs(recorded_graphs):
    """A real state becomes complex at interval 0: that interval runs
    eagerly (without ``out``) on every call, then the two graphs."""
    ws = ChebyWorkspace.create(2.0 * BOUND + 1.0, -BOUND - 0.5, 0.05)
    step = fused._with_outputs(fused._generic_step(
        list(_chain().ops), np.asarray(ws.coeffs), ws.delta, ws.e_min,
        ws.dt, True, None), _obs, False)
    table = torch.as_tensor(np.random.default_rng(3).uniform(
        0.8, 1.4, (5, 2)))
    psi = _state(2 ** L, 5).real.contiguous()
    run = scan_mod.GraphedScan(step)
    for scale in (1.0, 1.1):
        want = scan_mod._loop(step, psi, table * scale, 5)
        assert _equal(run(psi, table * scale), want)
    assert run._graph.first_eager and run._graph.carry_copies == 0


def test_step_without_out_copies_its_carry(recorded_graphs):
    """A step of the caller's without ``out``: one graph that copies its
    new carry, one leaf a replay."""
    xs = torch.linspace(0.5, 1.5, 5, dtype=torch.float64)

    def step(c, x):
        a, b = c
        return (a * x + b, b - 0.5 * a), a.sum()

    c0 = (torch.ones(4, dtype=torch.float64),
          torch.arange(4, dtype=torch.float64))
    run = scan_mod.GraphedScan(step)
    assert _equal(run(c0, xs), scan_mod._loop(step, c0, xs, 5))
    assert len(run._graph.graphs) == 1 and run._graph.carry_copies == 2


def test_out_step_returning_other_tensors_raises(recorded_graphs):
    def doubles(c, x, out=None):
        return c * x, None

    with pytest.raises(ValueError, match="doubles takes out= but returned"):
        scan_mod.scan(doubles, torch.ones(4, dtype=torch.float64),
                      torch.linspace(0.5, 1.5, 3, dtype=torch.float64))
