"""The scan's gradient (``utils/scan._Tape``, the port's ``jax.grad`` of
``lax.scan``) on the CPU: the same ``autograd.Function`` as on the card,
with its interval functions called in place of the graphs' replays.

Held against ``jax.grad`` of the JAX package's
``make_fused_cheby_propagator`` (1e-10 relative, the tolerance of
``test_torch_gradients.py``) and of ``jax.lax.scan`` (1e-14 relative
on a toy step: six intervals of float64 sums), and against the loop
under autograd bit for bit: the tape runs the loop's operations on the
same values, and each interval's VJP sums the same cotangents in the
loop's order.  Second derivatives
(``create_graph=True``, the loop's forward rerun inside the backward)
equal the loop's to 1e-13 relative: the double backward meets the
first-order VJP through the ``Function`` and adds the same terms in
another order."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumpropagators as qp
from quantumpropagators.fused import make_fused_cheby_propagator as jmake
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.fused import make_fused_cheby_propagator
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch.models.generators import coeff_table
from quantumpropagators_torch.utils import scan as scan_mod
from quantumpropagators_torch.utils.scan import GraphedScan, scan

set_default_device("cpu")

SX = np.array([[0, 1], [1, 0]], dtype=complex)
SZ = np.array([[1, 0], [0, -1]], dtype=complex)
L = 6
BOUND = 1.3 * (L - 1 + 0.3 * L) + 1.6 * L
PROBLEMS = {
    # (tlist, spectral envelope)
    "grape": (np.linspace(0.0, 2.0, 9),
              dict(E_min=-3.0, E_max=3.0, specrange_method="manual")),
    "chain": (np.linspace(0.0, 0.5, 6),
              dict(E_min=-BOUND, E_max=BOUND, specrange_method="manual")),
}
OUTPUTS = ["final", "observable", "states"]


@functools.cache
def _generator(name):
    """The JAX generator: the two-level transfer problem of
    ``test_torch_gradients.py``, or the L = 6 chain with a driven
    diagonal and driven flips."""
    if name == "grape":
        return qp.hamiltonian(0.0 * jnp.asarray(SZ),
                              (jnp.asarray(SX), lambda t: 0.2))
    H_diag, H_x = qp.transverse_field_ising(L, J=1.0, g=1.0, h=0.3,
                                            dtype=jnp.float64)
    return qp.hamiltonian((H_diag, lambda t: 1.0 + 0.3 * np.sin(0.9 * t)),
                          (H_x, lambda t: 1.2 + 0.4 * np.cos(1.7 * t)),
                          check=False)


def _psi0(name):
    if name == "grape":
        return np.array([1, 0], dtype=complex)
    rng = np.random.default_rng(3)
    v = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    return v / np.linalg.norm(v)


def _weights(n, psi0):
    """Fixed weights of the loss: on the final state's populations and on
    each output."""
    rng = np.random.default_rng(17)
    return rng.uniform(0.5, 1.5, psi0.size), rng.uniform(0.5, 1.5,
                                                         (n, psi0.size))


def _observable(xp, dim):
    diag = xp.asarray(np.linspace(-1.0, 1.0, dim))
    return lambda p: xp.real(xp.vdot(p, diag * p)) if xp is jnp \
        else torch.vdot(p, diag.to(p.dtype) * p).real


def _outputs_kw(xp, output, dim):
    if output == "observable":
        return dict(observable_fn=_observable(xp, dim))
    return dict(store_states=output == "states")


def _loss(xp, fin, ys, w_fin, w_ys):
    """A real loss of the final state and the outputs."""
    absq = (lambda z: z.abs() ** 2) if xp is torch else (
        lambda z: jnp.abs(z) ** 2)
    loss = (absq(fin) * w_fin).sum()
    if ys is not None:
        w = w_ys[:, 0] if ys.ndim == 1 else w_ys
        loss = loss + (absq(ys) * w).sum()
    return loss


def _port(name, output):
    """The port's propagator of the problem, its start and table."""
    tlist, env = PROBLEMS[name]
    psi0 = _psi0(name)
    gen = from_jax(_generator(name))
    fn = make_fused_cheby_propagator(
        torch.as_tensor(psi0), gen, tlist,
        **_outputs_kw(torch, output, psi0.size), **env)
    return fn, torch.as_tensor(psi0), coeff_table(gen, tlist)


def _port_grads(fn, psi0, table, output):
    w_fin, w_ys = (torch.as_tensor(w) for w in _weights(len(table),
                                                        psi0.numpy()))
    t = table.clone().requires_grad_(True)
    p = psi0.clone().requires_grad_(True)
    fin, ys = fn(p, t)
    loss = _loss(torch, fin, ys, w_fin, w_ys)
    return fin, loss, torch.autograd.grad(loss, (t, p))


def _loop_scans(monkeypatch):
    """Route every :class:`GraphedScan` through the plain loop: the scan
    under autograd before the tape."""
    monkeypatch.setattr(GraphedScan, "_run", lambda self, carry, xs, length: (
        scan_mod._loop(self.step, carry, xs, scan_mod._length(xs, length)),
        False))


@pytest.mark.parametrize("name,output", [("grape", "observable"),
                                         ("chain", "states")])
def test_gradients_match_jax(name, output):
    """Table and ``psi0`` gradients of a loss on the final state and the
    outputs against ``jax.grad`` of the JAX package's propagator
    (PyTorch's gradient of a complex input is the conjugate of
    JAX's)."""
    tlist, env = PROBLEMS[name]
    psi0 = _psi0(name)
    fn, tpsi, table = _port(name, output)
    _, loss, (g_table, g_psi) = _port_grads(fn, tpsi, table, output)
    jfn = jmake(jnp.asarray(psi0), _generator(name), tlist,
                **_outputs_kw(jnp, output, psi0.size), **env)
    w_fin, w_ys = _weights(len(table), psi0)

    def jloss(tb, p):
        fin, ys = jfn(p, tb)
        return _loss(jnp, fin, ys, w_fin, w_ys)

    jl, (jg_table, jg_psi) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1)))(jnp.asarray(table.numpy()),
                                jnp.asarray(psi0))
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-10)
    np.testing.assert_allclose(g_table.numpy(), np.asarray(jg_table),
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(g_psi.numpy(), np.conj(np.asarray(jg_psi)),
                               rtol=1e-10, atol=0)


@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_gradients_equal_the_loop(name, output, monkeypatch):
    """The tape against the loop under autograd, bit for bit: the final
    state, the loss, the table's and ``psi0``'s gradients; the result is
    the tape's autograd node."""
    fn, psi0, table = _port(name, output)
    fin, loss, grads = _port_grads(fn, psi0, table, output)
    assert type(fin.grad_fn).__name__ == "_ScanVJPBackward"
    _loop_scans(monkeypatch)
    want_fin, want_loss, want = _port_grads(fn, psi0, table, output)
    assert type(want_fin.grad_fn).__name__ != "_ScanVJPBackward"
    assert torch.equal(fin, want_fin) and torch.equal(loss, want_loss)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_one_tape_for_three_tables(monkeypatch):
    """One :class:`GraphedScan` keeps its tape: three tables, each equal
    to the loop bit for bit; two forwards before their backwards (the
    first's stacks overwritten by the second) still equal the loop."""
    fn, psi0, table = _port("grape", "states")
    tables = [table * s for s in (1.0, 0.9, 1.2)]
    got = [_port_grads(fn, psi0, tb, "states")[2] for tb in tables]
    run = fn.__closure__[fn.__code__.co_freevars.index("run")].cell_contents
    tape = run._tape
    assert tape is not None and tape.generation == 3
    ts = [tb.clone().requires_grad_(True) for tb in tables[:2]]
    outs = [fn(psi0, t) for t in ts]
    assert run._tape is tape and tape.generation == 5
    stale = [torch.autograd.grad(outs[i][1].abs().sum(), ts[i])[0]
             for i in (0, 1)]
    _loop_scans(monkeypatch)
    for tb, g in zip(tables, got):
        want = _port_grads(fn, psi0, tb, "states")[2]
        assert all(torch.equal(a, b) for a, b in zip(g, want))
    for i, g in enumerate(stale):
        t = tables[i].clone().requires_grad_(True)
        want, = torch.autograd.grad(fn(psi0, t)[1].abs().sum(), t)
        assert torch.equal(g, want)


def test_constants_are_kept_once():
    """The chain's diagonal is saved by reference, once; what the
    intervals produce is stacked, one slot an interval and one stack a
    storage (the site matrices, cast to complex each interval, are saved
    as 0-d views: their storage is stacked once), and no saved view of
    a stack is the real diagonal."""
    tlist, env = PROBLEMS["chain"]
    gen = from_jax(_generator("chain"))
    psi0 = torch.as_tensor(_psi0("chain"))
    fn = make_fused_cheby_propagator(psi0, gen, tlist, **env)
    table = coeff_table(gen, tlist).requires_grad_(True)
    fn(psi0, table)
    run = fn.__closure__[fn.__code__.co_freevars.index("run")].cell_contents
    saved = run._tape.saved
    views = [e for e in saved.entries if e[0] is not None]
    kept = {e[1].untyped_storage().data_ptr() for e in saved.entries
            if e[0] is None}
    assert all(t.shape[0] == len(tlist) - 1 for t in saved.stacks)
    assert len(saved.stacks) < len(views)
    assert gen.ops[0].diag.untyped_storage().data_ptr() in kept
    assert not any(dtype == torch.float64 and shape == (2 ** L,)
                   for _, dtype, shape, _, _ in views)


def _toy_step(cos, sin, w=None):
    def step(c, x):
        a, b = x
        c = c * cos(a) + sin(b) * 0.25 * c.sum()
        if w is not None:
            c = c * w
        return c, (c.sum(), 2.0 * c)

    return step


def _toy():
    rng = np.random.default_rng(5)
    return (rng.uniform(-1, 1, 4), rng.uniform(-1, 1, (6, 4)),
            rng.uniform(-1, 1, 6))


def _toy_loss(xp, c, s, v):
    return (c ** 2).sum() + (s * xp.arange(6.0)).sum() + (v ** 3).sum()


def test_scan_gradient_matches_jax_lax_scan():
    c0, a, b = _toy()

    def jloss(c, a, b):
        c, (s, v) = jax.lax.scan(_toy_step(jnp.cos, jnp.sin), c, (a, b))
        return _toy_loss(jnp, c, s, v)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (c0, a, b)))
    ins = [torch.as_tensor(v).requires_grad_(True) for v in (c0, a, b)]
    c, (s, v) = scan(_toy_step(torch.cos, torch.sin), ins[0],
                     (ins[1], ins[2]))
    got = torch.autograd.grad(_toy_loss(torch, c, s, v), ins)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-14 * np.abs(w).max()


def test_closed_over_leaf_runs_the_loop():
    """A step that closes over a tensor requiring grad: not the tape's
    node (that leaf is no input of it), the loop's results and
    gradients, the closed-over leaf's included, bit for bit."""
    c0, a, b = _toy()
    w = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    step = _toy_step(torch.cos, torch.sin, w)
    ins = [torch.as_tensor(v).requires_grad_(True) for v in (c0, a, b)]
    got = scan(step, ins[0], (ins[1], ins[2]))
    want = scan_mod._loop(step, ins[0], (ins[1], ins[2]), 6)
    assert type(got[0].grad_fn).__name__ != "_ScanVJPBackward"
    g_got = torch.autograd.grad(_toy_loss(torch, got[0], *got[1]),
                                ins + [w])
    g_want = torch.autograd.grad(_toy_loss(torch, want[0], *want[1]),
                                 ins + [w])
    for g, v in zip(g_got, g_want):
        assert torch.equal(g, v)


def test_create_graph_gives_the_loops_second_derivatives():
    """``create_graph=True``: the backward reruns the loop from the saved
    inputs, so a Hessian-vector product equals the loop's (1e-13
    relative); the first derivatives stay bit for bit."""
    c0, a, b = _toy()
    step = _toy_step(torch.cos, torch.sin)
    ins = [torch.as_tensor(v).requires_grad_(True) for v in (c0, a, b)]
    hv = []
    for run in (lambda: scan(step, ins[0], (ins[1], ins[2])),
                lambda: scan_mod._loop(step, ins[0], (ins[1], ins[2]), 6)):
        c, (s, v) = run()
        g = torch.autograd.grad(_toy_loss(torch, c, s, v), ins,
                                create_graph=True)
        h = torch.autograd.grad(sum((gi * gi.detach()).sum() for gi in g),
                                ins)
        hv.append((g, h))
    (g_got, h_got), (g_want, h_want) = hv
    for g, w in zip(g_got, g_want):
        assert torch.equal(g.detach(), w.detach())
    for h, w in zip(h_got, h_want):
        assert float((h - w).abs().max()) <= 1e-13 * float(w.abs().max())


def test_carry_changing_type_at_interval_0():
    """A real carry the step makes complex: interval 0 keeps its own
    graph and its VJP runs eagerly; two calls of one
    :class:`GraphedScan`, each equal to the loop bit for bit."""
    rng = np.random.default_rng(8)

    def step(c, x):
        c = c.to(torch.complex128) * torch.exp(1j * x) + 0.1 * c.sum()
        return c, c.real.sum()

    run = GraphedScan(step)
    for k in range(2):
        xs = torch.as_tensor(rng.uniform(-1, 1, (5, 3))).requires_grad_(True)
        c = torch.as_tensor(rng.uniform(-1, 1, 3)).requires_grad_(True)
        out = run(c, xs)
        assert run._tape.first_eager
        want = scan_mod._loop(step, c, xs, 5)
        got = torch.autograd.grad(out[0].abs().sum() + out[1].sum(), (c, xs))
        ref = torch.autograd.grad(want[0].abs().sum() + want[1].sum(),
                                  (c, xs))
        assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_tensors_made_from_host_data_are_stacked():
    """A step that makes a saved tensor from host data every interval
    (``torch.tensor``): stacked per interval, the loop's gradient bit for
    bit."""
    rng = np.random.default_rng(9)

    def step(c, x):
        c = torch.sin(c) * torch.tensor(1.5, dtype=torch.float64) * x
        return c, c.sum()

    c = torch.as_tensor(rng.uniform(-1, 1, 3)).requires_grad_(True)
    xs = torch.as_tensor(rng.uniform(-1, 1, 5)).requires_grad_(True)
    out = scan(step, c, xs)
    want = scan_mod._loop(step, c, xs, 5)
    assert type(out[0].grad_fn).__name__ == "_ScanVJPBackward"
    got = torch.autograd.grad(out[0].sum() + (out[1] ** 2).sum(), (c, xs))
    ref = torch.autograd.grad(want[0].sum() + (want[1] ** 2).sum(), (c, xs))
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
