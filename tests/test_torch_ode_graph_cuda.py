"""The ODE and expprop intervals as graphed sites on the card: each ODE
interval replays captured chunks of masked DP5 attempts, its step
control on the card and one flag read a chunk (``utils/scan.while_loop``
in a ``graphed(..., loop=True)`` site, the port of the JAX package's
``lax.while_loop`` under ``jax.jit``), and each expprop interval replays
one graph (``expm``'s choices on the card).  Each path equals its eager
body (``chip_smoke.bodies_only``) bit for bit, captures once a
propagator and not again after ``reinit_prop`` or for a new time grid of
the same length, reads the host at most ``⌈attempts / K⌉ + 2`` times an
ODE interval and never during an expprop interval, synchronizes
nothing during its replays but the flag's event, and raises where a
capture meets a host read instead of running eagerly.  Small sizes.
Needs an NVIDIA GPU (``-m cuda``); skips without one.  Imports no jax:
run with ``--noconftest``."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
import quantumpropagators_torch as qt
from quantumpropagators_torch.utils import scan

pytestmark = pytest.mark.cuda

# name: (propagate keywords, a drive the variant takes)
PATHS = {
    "ode pwc": (dict(method="ode", pwc=True),
                lambda t: float(np.cos(3.0 * t))),
    "ode continuous": (dict(method="ode", pwc=False),
                       lambda t: torch.cos(3.0 * t)),
    "expprop": (dict(method="expprop"), lambda t: float(np.cos(3.0 * t))),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _driven(device, drive, N=64, n=6):
    """A driven tridiagonal system as DIA terms, ``n`` intervals."""
    main = np.linspace(-2.0, 2.0, N)
    off = 0.5 * np.ones(N - 1)
    H0 = sp.diags([off, main, off], [-1, 0, 1]).tocsr()
    H1 = sp.diags(np.cos(np.arange(N))).tocsr()
    gen = qt.hamiltonian(qt.dia_from_scipy(H0, device=device),
                         (qt.dia_from_scipy(H1, device=device), drive))
    rng = np.random.default_rng(7)
    psi = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    psi = torch.as_tensor(psi / np.linalg.norm(psi), device=device)
    return gen, psi, np.linspace(0.0, 1.0, n + 1)


def _states(prop, psi):
    qt.reinit_prop(prop, psi)
    out = []
    while (s := prop.prop_step()) is not None:
        out.append(s)
    torch.cuda.synchronize()
    return out


def _prop(cuda, name):
    kw, drive = PATHS[name]
    gen, psi, tlist = _driven(cuda, drive)
    return qt.init_prop(psi, gen, tlist, **kw), psi


@pytest.mark.parametrize("name", list(PATHS))
def test_graph_equals_eager(cuda, name):
    prop, psi = _prop(cuda, name)
    _states(prop, psi)  # the first interval eager, then the capture
    graph = _states(prop, psi)
    with chip_smoke.bodies_only():
        eager = _states(prop, psi)
    assert isinstance(prop._step, scan.Graphed) and prop._step.captures == 1
    assert len(graph) == 6
    assert all(torch.equal(g, e) for g, e in zip(graph, eager))


@pytest.mark.parametrize("name", list(PATHS))
def test_no_capture_after_reinit_or_for_a_new_grid(cuda, name):
    prop, psi = _prop(cuda, name)
    _states(prop, psi)
    _states(prop, psi)
    prop.tlist = 0.8 * prop.tlist  # the same length
    moved = _states(prop, psi)
    assert prop._step.captures == 1
    with chip_smoke.bodies_only():
        assert all(torch.equal(g, e)
                   for g, e in zip(moved, _states(prop, psi)))


@pytest.mark.parametrize("name", list(PATHS))
def test_host_reads_an_interval(cuda, name):
    """At most ``⌈attempts / K⌉ + 2`` flag reads an ODE interval (the
    attempts read from the site's loop state), none for expprop."""
    prop, psi = _prop(cuda, name)
    _states(prop, psi)
    qt.reinit_prop(prop, psi)
    K = scan.WHILE_CHUNK
    while True:
        before = scan.FLAG_READS["graph"]
        if prop.prop_step() is None:
            break
        reads = scan.FLAG_READS["graph"] - before
        if name == "expprop":
            assert reads == 0
            continue
        (state,) = [loop[1] for _, _, loop in prop._step._call.graph.parts
                    if loop is not None]
        attempts = int(state[5])
        assert 0 < reads <= -(-attempts // K) + 2


@pytest.mark.parametrize("name", list(PATHS))
def test_replays_synchronize_nothing_but_the_flag(cuda, name):
    prop, psi = _prop(cuda, name)
    _states(prop, psi)
    qt.reinit_prop(prop, psi)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        while prop.prop_step() is not None:
            pass
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert prop._step.captures == 1


def test_a_host_read_in_the_loop_raises(cuda):
    """A drive that computes on an abstract time (so the continuous
    variant takes the graphed route) but copies a host number to the card
    at each call: the capture raises, naming the step, and does not run
    eagerly in its place."""
    drive = lambda t: torch.cos(t) + torch.tensor(0.0, device=t.device)
    gen, psi, tlist = _driven(cuda, drive)
    prop = qt.init_prop(psi, gen, tlist, method="ode", pwc=False)
    assert isinstance(prop._step, scan.Graphed)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        prop.prop_step()
