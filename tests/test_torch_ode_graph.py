"""The ODE integrator's while loop and expprop's step as graphed sites, on
the CPU (the port of the JAX package's ``lax.while_loop`` in
``ops/ode.py``, the ``jax.jit`` of ``_pwc_ode_step`` and ``_cont_step``
in ``propagators/ode.py`` and of ``_exp_step`` in
``propagators/expprop.py``).

On the card each ODE interval replays captured chunks of masked DP5
attempts (``utils/scan.while_loop`` inside a ``graphed(..., loop=True)``
site) and each expprop interval one graph.  Here:

- (a) ``dopri5_integrate``'s masked loop against the JAX
  ``dopri5_integrate`` at 1e-12, forward and backward: a loop that ends
  inside a chunk, ``max_steps`` reached inside a chunk ("whatever was
  reached"), and chunks of ``WHILE_CHUNK`` against one attempt a read,
  bit for bit.  Where the loop stops at ``max_steps`` the time reached
  hangs on every step size before it, and a step size on the error
  estimate's last bits (a difference of two nearly equal sums), so two
  correct integrators of a driven system stop apart (the JAX function
  compiled and run as a Python loop reach states 233 apart on a
  quadratic solution).  That case is a constant right-hand side at a
  loose tolerance: its error estimate stays below the controller's
  floor of 1e-10, so the step sizes are the floor's, the same in both;
- (b) ``expm`` against ``jax.scipy.linalg.expm`` at 1e-13 at 1-norms
  that select each Padé degree and 0, 1 and 16 squarings, NaN beyond 16;
- (c) each site's body, given its per-call data as tensors, under a
  guard that raises on every host read but the loop's flag;
- (d) the card's route with the CPU standing for the card: ``propagate``
  with ``method="ode"`` (``pwc=True`` and a continuous ``torch.cos``
  drive) and ``method="expprop"`` against ``qp.propagate`` at 1e-10, bit
  for bit against the eager body, one capture a propagator and none
  after ``reinit_prop`` or for a new time grid of the same length.

The card's half is ``test_torch_ode_graph_cuda.py``."""

import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.ops.ode import dopri5_integrate as jax_dopri5
from quantumpropagators_torch.ops import ode as ode_mod
from quantumpropagators_torch.ops.expprop import expm
from quantumpropagators_torch.ops.ode import dopri5_integrate
from quantumpropagators_torch.propagators import expprop as texp
from quantumpropagators_torch.propagators import ode as tode
from quantumpropagators_torch.utils import scan as scan_mod
from test_torch_scan import HostRead
from test_torch_step_graph import Guard

qt.set_default_device("cpu")

T = torch.as_tensor
N = 8
THETA13 = 5.371920351148152  # the double-precision scaled-norm bound


def _hermitian(rng, n, scale=1.0):
    X = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = X + X.conj().T
    return scale * H / np.abs(np.linalg.eigvalsh(H)).max()


@pytest.fixture(scope="module")
def system():
    """A driven N = 8 system: ``H0``, ``H1``, a state and a time grid."""
    rng = np.random.default_rng(25)
    H0, H1 = _hermitian(rng, N, 2.0), _hermitian(rng, N, 0.5)
    psi = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    return H0, H1, psi / np.linalg.norm(psi), np.linspace(0.0, 1.0, 6)


# -- (a) the masked loop against the JAX while_loop ---------------------------

# name: (driven, t0, t1, keywords)
_LOOPS = {
    "forward": (True, 0.0, 1.5, dict(rtol=1e-10, atol=1e-10)),
    "backward": (True, 1.5, 0.0, dict(rtol=1e-10, atol=1e-10)),
    "max_steps inside a chunk": (False, 0.0, 1e6, dict(
        rtol=1e-3, atol=1e-3, first_step=1e-3, max_steps=13)),
}


def _rhs(system, driven, lib):
    """The driven system's ``-i·(H0 + cos(3t)·H1)·y`` or a constant."""
    H0, H1, psi, _ = system
    cos, conv = (jnp.cos, jnp.asarray) if lib == "jax" else (torch.cos, T)
    A, B = conv(H0), conv(H1)
    if driven:
        return lambda t, y: -1j * (A @ y + cos(3.0 * t) * (B @ y))
    a = conv(H0[0])
    return lambda t, y: a + 0.0 * y


@pytest.fixture(scope="module")
def jax_loops(system):
    psi = jnp.asarray(system[2])
    return {name: np.asarray(jax_dopri5(_rhs(system, driven, "jax"), psi,
                                        t0, t1, **kw))
            for name, (driven, t0, t1, kw) in _LOOPS.items()}


def _port_loop(system, name, monkeypatch):
    """The port's ``dopri5_integrate`` on :data:`_LOOPS` ``[name]``, and
    its final loop state."""
    driven, t0, t1, kw = _LOOPS[name]
    finals = []

    def recorded(cond, body, state):
        finals.append(scan_mod.while_loop(cond, body, state))
        return finals[-1]

    monkeypatch.setattr(ode_mod, "while_loop", recorded)
    y = dopri5_integrate(_rhs(system, driven, "torch"), T(system[2]), t0,
                         t1, **kw)
    return y, finals[0]


@pytest.mark.parametrize("name", list(_LOOPS))
def test_masked_loop_matches_jax(system, jax_loops, name, monkeypatch):
    y, (t, _, _, _, done, n, _) = _port_loop(system, name, monkeypatch)
    K = scan_mod.WHILE_CHUNK
    assert int(n) % K != 0  # the loop ends inside a chunk
    if name == "max_steps inside a chunk":
        assert int(n) == 13 and not bool(done)
    else:
        assert bool(done) and float(t) == _LOOPS[name][2]
    assert np.abs(y.numpy() - jax_loops[name]).max() <= 1e-12


@pytest.mark.parametrize("name", list(_LOOPS))
def test_chunks_equal_one_attempt_a_read(system, name, monkeypatch):
    reads = scan_mod.FLAG_READS["eager"]
    chunked, (*_, n, _) = _port_loop(system, name, monkeypatch)
    assert scan_mod.FLAG_READS["eager"] - reads \
        == -(-int(n) // scan_mod.WHILE_CHUNK)
    monkeypatch.setattr(scan_mod, "WHILE_CHUNK", 1)
    single, (*_, n1, _) = _port_loop(system, name, monkeypatch)
    assert int(n1) == int(n) and torch.equal(chunked, single)


# -- (b) expm against jax.scipy.linalg.expm -----------------------------------

def _scaled(M, norm):
    return M * (norm / np.abs(M).sum(axis=0).max())


def _expm_cases():
    rng = np.random.default_rng(26)
    S = -1j * _hermitian(rng, 6)
    cases = {f"degree {m}": _scaled(S, norm) for m, norm in
             ((3, 0.01), (5, 0.2), (7, 0.9), (9, 2.0), (13, 4.0))}
    cases["degree 13, 0 squarings"] = _scaled(S, 1.9 * THETA13)
    cases["1 squaring"] = _scaled(S, 3.0 * THETA13)
    cases["real, 1 squaring"] = _scaled(S.imag, 3.0 * THETA13)
    # 16 squarings: exp of a nilpotent block is exact through the
    # squarings, so a wrong count shows (a generic matrix amplifies the
    # two packages' last bits 2^16 times: 2e-11 apart)
    big = 1.3 * THETA13 * 2 ** 16
    cases["16 squarings"] = np.array([[0.0, big], [0.0, 0.0]],
                                     dtype=complex)
    return cases


@pytest.mark.parametrize("name", list(_expm_cases()))
def test_expm_matches_jax(name):
    M = _expm_cases()[name]
    want = np.asarray(jsl.expm(jnp.asarray(M)))
    got = expm(T(M)).numpy()
    assert np.abs(got - want).max() <= 1e-13 * max(1.0, np.abs(want).max())


def test_expm_beyond_16_squarings_is_nan():
    M = np.diag([-1j, 0.5j]) * 1.1 * THETA13 * 2 ** 17
    assert np.isnan(np.asarray(jsl.expm(jnp.asarray(M)))).all()
    assert torch.isnan(expm(T(M))).all()
    assert not torch.isnan(expm(T(M / 2.0))).any()


# -- (c) the bodies read nothing from the host --------------------------------

class _Loops:
    """:class:`scan_mod._Segments` on the CPU: each :func:`while_loop`
    runs its chunks where it is called (under the guard) and reads its
    flag outside the guard, as the card reads it outside the graph, and
    counts the read as the card's."""

    def loop(self, cond, body, state):
        while True:
            state = scan_mod._chunk(cond, body, state)
            scan_mod.FLAG_READS["graph"] += 1
            with torch._C.DisableTorchFunction():
                if not bool(cond(state)):
                    return state


def _bodies(system):
    """Each site's body with its per-call data as tensors, made here,
    outside the guard (the sites' first, eager call makes the device
    tables first)."""
    H0, H1, psi, _ = system
    ops, p = (T(H0), T(H1)), T(psi)
    amps = T(np.array([0.7]))
    t0, t1, dt = (torch.tensor(x, dtype=torch.float64)
                  for x in (0.0, 0.2, 0.2))
    return {
        "pwc ode": lambda: tode._pwc_interval(ops, amps, p, t0, t1, 1e-10,
                                              1e-10, 1000),
        "continuous ode": lambda: tode._continuous_interval(
            (lambda t: torch.cos(3.0 * t),), ops, p, t0, t1, 1e-10, 1e-10,
            1000),
        "expprop": lambda: texp._exp_step(ops, amps, p, dt),
    }


@pytest.mark.parametrize("body", ["pwc ode", "continuous ode", "expprop"])
def test_body_reads_nothing_from_the_host(system, body, monkeypatch):
    call = _bodies(system)[body]
    want = call()
    monkeypatch.setattr(scan_mod._Segments, "active", _Loops())
    with Guard():
        got = call()
    assert torch.equal(got, want)


def test_guard_sees_the_eager_loops_read(system):
    with Guard(), pytest.raises(HostRead):
        _bodies(system)["pwc ode"]()


# -- (d) the card's route on the CPU ------------------------------------------

class _Replayed:
    """A captured call's stand-in: a replay runs the body again on the
    static buffers, under the guard, into the static outputs."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        new = self.fn()
        for o, n in zip(scan_mod._leaves(self.out), scan_mod._leaves(new)):
            o.copy_(n)


def _on_the_card(monkeypatch):
    """Every :class:`Graphed` call takes the card's route with CPU
    tensors: a first call run where it is, a capture a guarded call of
    the body on the static buffers (its loops as :class:`_Loops`), a
    replay another."""

    def route(self, arguments):
        tensors = []
        scan_mod._walk(arguments, tensors, set(), keyed=False)
        return (tensors[0].device if tensors else None), False

    def captured(device, fn, refused, pool=None, split=False):
        def guarded():
            scan_mod._Segments.active = _Loops() if split else None
            try:
                with Guard():
                    return fn()
            finally:
                scan_mod._Segments.active = None

        out = guarded()
        return _Replayed(guarded, out), out, ()

    monkeypatch.setattr(scan_mod.Graphed, "_route", route)
    monkeypatch.setattr(scan_mod, "_first_on_side",
                        lambda step, device, fn, what="scan": fn())
    monkeypatch.setattr(scan_mod, "_captured", captured)


def _run(prop, psi):
    qt.reinit_prop(prop, psi)
    states = []
    while (s := prop.prop_step()) is not None:
        states.append(s)
    return states


# name: (propagate keywords, port drive, JAX drive)
_PATHS = {
    "ode pwc": (dict(method="ode", pwc=True), lambda t: np.cos(3.0 * t),
                lambda t: np.cos(3.0 * t)),
    "ode continuous": (dict(method="ode", pwc=False),
                       lambda t: torch.cos(3.0 * t),
                       lambda t: jnp.cos(3.0 * t)),
    "expprop": (dict(method="expprop"), lambda t: np.cos(3.0 * t),
                lambda t: np.cos(3.0 * t)),
}


@pytest.fixture(scope="module")
def jax_paths(system):
    H0, H1, psi, tlist = system
    out = {}
    for name, (kw, _, drive) in _PATHS.items():
        gen = qp.hamiltonian(jnp.asarray(H0), (jnp.asarray(H1), drive))
        out[name] = np.asarray(qp.propagate(jnp.asarray(psi), gen, tlist,
                                            check=False, **kw))
    return out


@pytest.mark.parametrize("name", list(_PATHS))
def test_graphed_route_matches_jax_and_the_body(system, jax_paths, name,
                                                monkeypatch):
    H0, H1, psi, tlist = system
    kw, drive, _ = _PATHS[name]
    gen = qt.hamiltonian(T(H0), (T(H1), drive))
    eager = _run(qt.init_prop(T(psi), gen, tlist, **kw), T(psi))
    _on_the_card(monkeypatch)
    prop = qt.init_prop(T(psi), gen, tlist, **kw)
    assert isinstance(prop._step, scan_mod.Graphed)
    graph = _run(prop, T(psi))
    assert prop._step.captures == 1
    assert all(torch.equal(g, e) for g, e in zip(graph, eager))
    assert np.abs(graph[-1].numpy() - jax_paths[name]).max() <= 1e-10
    _run(prop, T(psi))
    prop.tlist = 0.9 * tlist  # a new grid of the same length
    again = _run(prop, T(psi))
    assert prop._step.captures == 1
    monkeypatch.undo()
    assert all(torch.equal(g, e) for g, e in zip(again, _run(prop, T(psi))))


def test_explicit_continuous_host_drive_runs_the_eager_body(system):
    """An explicit ``pwc=False`` with a ``numpy`` drive, which the JAX
    package refuses to trace: no graphed site, the amplitudes called at a
    CPU time, the same result as the continuous ``torch.cos`` drive."""
    H0, H1, psi, tlist = system
    host = qt.hamiltonian(T(H0), (T(H1), lambda t: np.cos(3.0 * t)))
    prop = qt.init_prop(T(psi), host, tlist, method="ode", pwc=False)
    assert not isinstance(prop._step, scan_mod.Graphed)
    traced = qt.hamiltonian(T(H0), (T(H1), lambda t: torch.cos(3.0 * t)))
    want = qt.propagate(T(psi), traced, tlist, method="ode", pwc=False,
                        check=False)
    assert np.abs(_run(prop, T(psi))[-1].numpy() - want.numpy()).max() \
        <= 1e-13


def test_expprop_hooks_stay_on_the_host(system):
    H0, H1, psi, tlist = system
    gen = qt.hamiltonian(T(H0), (T(H1), lambda t: np.cos(3.0 * t)))
    prop = qt.init_prop(T(psi), gen, tlist, method="expprop",
                        convert_state=lambda s: s)
    assert not prop._graphed
    want = qt.propagate(T(psi), gen, tlist, method="expprop", check=False)
    assert np.abs(_run(prop, T(psi))[-1].numpy() - want.numpy()).max() \
        <= 1e-13


def test_autograd_runs_the_loop_eagerly(system, monkeypatch):
    """Under autograd the loop site runs its body (``jax.grad`` refuses a
    ``while_loop``): no capture, and a gradient."""
    H0, H1, psi, tlist = system
    _on_the_card(monkeypatch)
    amp = torch.tensor(0.4, dtype=torch.float64, requires_grad=True)
    gen = qt.hamiltonian(T(H0), (T(H1), lambda t: amp * torch.cos(t)))
    prop = qt.init_prop(T(psi), gen, tlist[:3], method="ode", pwc=False)
    psi1 = qt.propagate(T(psi), gen, tlist[:3], method="ode", pwc=False,
                        check=False)
    grad, = torch.autograd.grad(psi1.abs()[0], amp)
    assert torch.isfinite(grad) and prop._step.captures == 0
