"""The port's scan (``quantumpropagators_torch.utils.scan``) on the CPU:
against ``jax.lax.scan``, every routed step run under a guard that
raises on a host read (on the card such a step cannot be captured as a
CUDA graph), and the fused paths' per-step outputs against the JAX
package's same calls.

Tolerances: the toy scans 1e-15 (a few float64 operations a step);
the complex128 paths 1e-12 and the complex64 one 1e-5, as the existing
``test_torch_fused_*`` files hold the final states."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.overrides import TorchFunctionMode

import quantumpropagators as qp
from quantumpropagators.fused import (
    cheby_propagate_fused as jax_fused,
    make_fused_cheby_propagator as jax_make,
)
from quantumpropagators.models.lattice import SiteOperatorSum as JSites
from quantumpropagators.ops.newton_leja import (
    newton_leja_propagate_dd as jax_leja,
)
import quantumpropagators_torch as qt
from quantumpropagators_torch import fused, set_default_device
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch.ops import newton_leja
from quantumpropagators_torch.ops.cheby import ChebyWorkspace
from quantumpropagators_torch.utils import scan as scan_mod
from quantumpropagators_torch.utils.scan import GraphedScan, scan

set_default_device("cpu")

L = 10
J, H_FIELD = 1.0, 0.3
BOUND = 1.3 * (J * (L - 1) + H_FIELD * L) + 1.6 * L
ENVELOPE = dict(specrange_method="manual", E_min=-BOUND - 0.5, E_max=BOUND)
TLIST = np.linspace(0.0, 0.15, 4)


# -- scan against jax.lax.scan ----------------------------------------------

def _toy_step(cos, sin):
    def step(c, x):
        a, b = x
        c = c * cos(a) + sin(b) * 0.25 * c.sum()
        return c, (c.sum(), 2.0 * c)

    return step


def _toy_inputs():
    rng = np.random.default_rng(5)
    return (rng.uniform(-1, 1, 4), rng.uniform(-1, 1, (6, 4)),
            rng.uniform(-1, 1, 6))


def test_scan_with_xs_and_tuple_ys_matches_jax():
    c0, a, b = _toy_inputs()
    jc, (js, jv) = jax.lax.scan(_toy_step(jnp.cos, jnp.sin), jnp.asarray(c0),
                                (jnp.asarray(a), jnp.asarray(b)))
    tc, (ts, tv) = scan(_toy_step(torch.cos, torch.sin),
                        torch.as_tensor(c0),
                        (torch.as_tensor(a), torch.as_tensor(b)))
    assert ts.shape == (6,) and tv.shape == (6, 4)
    for got, want in ((tc, jc), (ts, js), (tv, jv)):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-15


def test_scan_without_xs_matches_jax():
    c0, _, _ = _toy_inputs()

    def step(c, _):
        c = 0.9 * c + 0.1 * c.sum()
        return c, c.prod()

    jc, jy = jax.lax.scan(step, jnp.asarray(c0), None, length=5)
    tc, ty = scan(step, torch.as_tensor(c0), length=5)
    assert ty.shape == (5,)
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 1e-15
    assert np.abs(ty.numpy() - np.asarray(jy)).max() <= 1e-15
    # no outputs: None, as the JAX scan's
    _, none = scan(lambda c, _: (c + 1, None), torch.zeros(2), length=3)
    assert none is None


def test_scan_rejects_inconsistent_lengths():
    with pytest.raises(ValueError):
        scan(lambda c, x: (c, None), torch.zeros(1), torch.zeros(3), length=4)
    with pytest.raises(ValueError):
        scan(lambda c, x: (c, None), torch.zeros(1))


# -- the host-read guard ----------------------------------------------------

class HostRead(AssertionError):
    pass


class HostReadGuard(TorchFunctionMode):
    """Raises :class:`HostRead` on every tensor operation that reads the
    host or copies host data to the device: on the card each waits for
    the device or is a pageable copy, and neither can be captured."""

    READS = {"item", "tolist", "__float__", "__complex__", "__bool__",
             "__int__", "cpu", "numpy", "__array__"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.READS:
            raise HostRead(name)
        if name in ("as_tensor", "tensor") and args \
                and not isinstance(args[0], torch.Tensor):
            raise HostRead(f"{name} of {type(args[0]).__name__}")
        if name in ("__getitem__", "__setitem__") and len(args) > 1 \
                and _has_list(args[1]):
            raise HostRead(f"{name} with a list index")
        return func(*args, **(kwargs or {}))


def _has_list(index):
    if isinstance(index, list):
        return True
    return isinstance(index, tuple) and any(isinstance(i, list)
                                            for i in index)


_READS = {
    "item": lambda t: t[0].item(),
    "tolist": lambda t: t.tolist(),
    "float": lambda t: float(t[0]),
    "complex": lambda t: complex(t[0]),
    "bool": lambda t: bool(t[0] > 0),
    "int": lambda t: int(t[0]),
    "cpu": lambda t: t.cpu(),
    "numpy": lambda t: t.numpy(),
    "np.asarray": lambda t: np.asarray(t),
    "as_tensor of a list": lambda t: torch.as_tensor([1.0, 2.0]),
    "tensor of a float": lambda t: torch.tensor(1.0),
    "list index": lambda t: t[[0, 1]],
}


@pytest.mark.parametrize("read", sorted(_READS))
def test_guard_catches_each_host_read(read):
    t = torch.arange(3.0)
    with HostReadGuard(), pytest.raises(HostRead):
        _READS[read](t)


def test_guard_passes_device_work():
    t = torch.arange(4.0)
    with HostReadGuard():
        out = torch.as_tensor(t) * t[1] + t[0:2].sum() + t.index_select(
            0, torch.zeros(1, dtype=torch.int64))
    assert out.shape == (4,)


@pytest.fixture
def guarded(monkeypatch):
    """Every scan (and :class:`GraphedScan`) of the fused layer, the Leja
    loop and ``bench_torch.py`` runs its steps under
    :class:`HostReadGuard`, all but the first: that one is the eager
    warm-up on the card too, where the kernels are built and one-time
    device constants made.  Returns, per scan run, the
    number of intervals run under the guard."""
    runs = []

    def guard(step):
        runs.append(0)
        first = [True]

        def checked(c, x):
            if first[0]:
                first[0] = False
                return step(c, x)
            runs[-1] += 1
            with HostReadGuard():
                return step(c, x)

        return checked

    class GuardedGraphedScan(GraphedScan):
        def _run(self, carry, xs, length):
            step = self.step
            self.step = guard(step)
            try:
                return super()._run(carry, xs, length)
            finally:
                self.step = step

    # scan and bench_torch.py's loops make theirs through scan_mod
    for mod in (scan_mod, fused):
        monkeypatch.setattr(mod, "GraphedScan", GuardedGraphedScan)
    return runs


# -- the problems -----------------------------------------------------------

def _state(n, seed, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return (v / np.linalg.norm(v)).astype(dtype)


def _chain(driven_diag=True):
    """The driven TFIM chain (JAX objects): amplitudes on the flips and,
    with ``driven_diag``, on the diagonal."""
    H_diag, H_x = qp.transverse_field_ising(L, J=J, g=1.0, h=H_FIELD,
                                            dtype=jnp.float64)
    eps_g = lambda t: 1.2 + 0.4 * np.cos(1.7 * t)
    eps_d = lambda t: 1.0 + 0.3 * np.sin(0.9 * t)
    if driven_diag:
        return qp.hamiltonian((H_diag, eps_d), (H_x, eps_g), check=False)
    return qp.hamiltonian(H_diag, (H_x, eps_g), check=False)


def _multi():
    """Two independently driven flip groups and a driven diagonal."""
    H_diag, _ = qp.transverse_field_ising(L, J=J, g=1.0, h=H_FIELD,
                                          dtype=jnp.float64)
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    g_site = np.random.default_rng(29).uniform(0.9, 1.3, L)

    def group(parity):
        mats = np.zeros((L, 2, 2))
        for i in range(L):
            if i % 2 == parity:
                mats[i] = g_site[i] * sx
        return JSites(jnp.asarray(mats), L=L,
                      active=tuple(i % 2 == parity for i in range(L)))

    return qp.hamiltonian(
        (H_diag, lambda t: 1.0 + 0.3 * np.sin(0.9 * t)),
        (group(1), lambda t: 1.2 + 0.4 * np.cos(1.7 * t)),
        (group(0), lambda t: 0.9 + 0.5 * np.sin(2.3 * t)), check=False)


def _banded():
    """A static real pentadiagonal operator (the banded route at b = 8)
    and the JAX BSR operator of it."""
    from quantumpropagators.ops.operators import bsr_from_scipy

    rng = np.random.default_rng(91)
    N = 48
    A = sp.diags([rng.normal(size=N - 2), rng.normal(size=N - 1),
                  rng.normal(size=N), rng.normal(size=N - 1),
                  rng.normal(size=N - 2)], [-2, -1, 0, 1, 2]).tocsr()
    A = (0.5 * (A + A.T)).tocsr()
    return A, bsr_from_scipy(A, block_size=8)


def _leja_problem(N=32, seed=24):
    rng = np.random.default_rng(seed)
    M0, M1 = rng.normal(size=(N, N)), rng.normal(size=(N, N))
    H0, H1 = M0 + M0.T, 0.3 * (M1 + M1.T)
    return qp.hamiltonian(jnp.asarray(H0, dtype=complex),
                          (jnp.asarray(H1, dtype=complex),
                           lambda t: np.cos(3 * t)))


def _norm2_t(p):
    return torch.vdot(p, p).real


def _norm2_j(p):
    return jnp.vdot(p, p).real


# -- one guarded step of each routed path -----------------------------------

def _run_dd(multi, tail):
    gen = _multi() if multi else _chain()
    psi = torch.as_tensor(_state(2 ** L, 3))
    return fused.cheby_propagate_fused(psi, from_jax(gen), TLIST,
                                       kernel="dd", f32_tail=tail,
                                       observable_fn=_norm2_t, **ENVELOPE)


def _run_flip_f32():
    psi = torch.as_tensor(_state(2 ** L, 4, np.complex64))
    return fused.cheby_propagate_fused(psi, from_jax(_chain()), TLIST,
                                       kernel="pallas", store_states=True,
                                       **ENVELOPE)


def _run_generic():
    psi = torch.as_tensor(_state(2 ** L, 5))
    return fused.cheby_propagate_fused(psi, from_jax(_chain()), TLIST,
                                       kernel="xla",
                                       observable_fn=_norm2_t, **ENVELOPE)


def _run_static(banded):
    A, jbsr = _banded()
    if not banded:
        # a coupling at every block distance: 11 bands > 9 at b = 8, so
        # the blocked-ELL product runs
        A = A.tolil()
        for d in range(1, A.shape[0] // 8):
            A[0, 8 * d] = A[8 * d, 0] = 0.1 * d
        A = A.tocsr()
    op = from_jax(jbsr) if banded else qt.csr_from_scipy(A)
    ws = ChebyWorkspace.create(12.0, -6.5, float(TLIST[1] - TLIST[0]))
    psi = torch.as_tensor(_state(A.shape[0], 6))
    return fused.cheby_propagate_fused(psi, op, TLIST, workspace=ws,
                                       kernel="dd", store_states=True)


def _run_leja():
    psi = torch.as_tensor(_state(32, 7))
    return newton_leja.newton_leja_propagate_dd(
        psi, from_jax(_leja_problem()), TLIST, e_min=-30.0, e_max=30.0,
        observable_fn=_norm2_t)


_GUARDED = {
    "cheby_step_fused_dd single, tail": lambda: _run_dd(False, 2),
    "cheby_step_fused_dd single, no tail": lambda: _run_dd(False, 0),
    "cheby_step_fused_dd multi, tail": lambda: _run_dd(True, 2),
    "cheby_step_fused_dd multi, no tail": lambda: _run_dd(True, 0),
    "flip_cheby_step f32": _run_flip_f32,
    "banded static dd": lambda: _run_static(True),
    "BSR static dd": lambda: _run_static(False),
    "generic Operator": _run_generic,
    "Leja": _run_leja,
}


@pytest.mark.parametrize("path", sorted(_GUARDED))
def test_routed_step_reads_nothing_from_the_host(path, guarded):
    out = _GUARDED[path]()
    assert guarded == [len(TLIST) - 2]
    assert out[1] is not None and out[1].shape[0] == len(TLIST) - 1
    assert torch.isfinite(torch.view_as_real(out[0].to(torch.complex128))
                          ).all()


@pytest.mark.parametrize("kernel", ["dd", "fused", "planar", "complex"])
def test_bench_headline_steps_read_nothing_from_the_host(kernel, guarded):
    import bench_torch

    line = bench_torch.bench_headline(torch.device("cpu"), L=L, L_ref=8,
                                      kernel=kernel, steps=2, oracle=False)
    # two warm-ups and the two timed runs, of 2 and 6 steps
    assert guarded == [1, 5, 1, 5]
    assert abs(line["extra"]["state_norm_after"] - 1.0) < 1e-5


# -- the per-step outputs against the JAX package ---------------------------

def _j2np(x):
    return np.asarray(x)


@pytest.mark.parametrize("what", ["observables", "states"])
@pytest.mark.parametrize("kernel, gen", [("dd", "chain"), ("dd", "multi"),
                                         ("xla", "chain"),
                                         ("pallas", "chain")])
def test_fused_outputs_match_jax(kernel, gen, what):
    jgen = _chain() if gen == "chain" else _multi()
    dtype = np.complex64 if kernel == "pallas" else np.complex128
    psi = _state(2 ** L, 8, dtype)
    kw = (dict(observable_fn=_norm2_j) if what == "observables"
          else dict(store_states=True))
    jfin, jout = jax_fused(jnp.asarray(psi), jgen, TLIST, kernel=kernel,
                           **kw, **ENVELOPE)
    if what == "observables":
        kw = dict(observable_fn=_norm2_t)
    fin, out = fused.cheby_propagate_fused(torch.as_tensor(psi),
                                           from_jax(jgen), TLIST,
                                           kernel=kernel, **kw, **ENVELOPE)
    tol = 1e-5 if kernel == "pallas" else 1e-12
    want = _j2np(jout)
    assert out.shape == want.shape
    assert np.abs(out.numpy() - want).max() <= tol
    assert np.abs(fin.numpy() - _j2np(jfin)).max() <= tol


def test_static_banded_states_match_jax():
    """The static banded route's stored states (its observables are held
    in ``test_torch_fused_static.py``) against the JAX package's generic
    path on the same operator: the JAX banded kernel's interpret mode
    costs 15 s a call here."""
    from quantumpropagators.ops.cheby import ChebyWorkspace as JWorkspace

    A, jbsr = _banded()
    args = (12.0, -6.5, float(TLIST[1] - TLIST[0]))
    psi = _state(A.shape[0], 9)
    _, jout = jax_fused(jnp.asarray(psi), jbsr, TLIST,
                        workspace=JWorkspace.create(*args), kernel="xla",
                        store_states=True)
    _, out = fused.cheby_propagate_fused(
        torch.as_tensor(psi), from_jax(jbsr), TLIST,
        workspace=ChebyWorkspace.create(*args), kernel="dd",
        store_states=True)
    assert out.shape == (len(TLIST) - 1, A.shape[0])
    assert np.abs(out.numpy() - _j2np(jout)).max() <= 1e-12


@pytest.mark.parametrize("what", ["observables", "states"])
def test_leja_outputs_match_jax(what):
    jgen = _leja_problem()
    psi = _state(32, 10)
    kw = dict(e_min=-30.0, e_max=30.0)
    jkw = dict(observable_fn=_norm2_j) if what == "observables" \
        else dict(store_states=True)
    _, jout, _ = jax_leja(jnp.asarray(psi), jgen, TLIST, **kw, **jkw)
    tkw = dict(observable_fn=_norm2_t) if what == "observables" \
        else dict(store_states=True)
    _, out, _ = newton_leja.newton_leja_propagate_dd(
        torch.as_tensor(psi), from_jax(jgen), TLIST, **kw, **tkw)
    want = _j2np(jout)
    assert out.shape == want.shape
    assert np.abs(out.numpy() - want).max() <= 1e-12


def test_make_fused_cheby_propagator_two_tables_match_jax():
    jgen = _chain(driven_diag=False)
    psi = _state(2 ** L, 11)
    tl = np.linspace(0.0, 0.2, 5)
    kw = dict(observable_fn=None, **ENVELOPE)
    jfn = jax_make(jnp.asarray(psi), jgen, tl, **kw)
    tfn = fused.make_fused_cheby_propagator(torch.as_tensor(psi),
                                            from_jax(jgen), tl, **kw)
    rng = np.random.default_rng(12)
    for _ in range(2):
        table = rng.uniform(0.8, 1.6, (len(tl) - 1, 1))
        jfin, _ = jfn(jnp.asarray(psi), jnp.asarray(table))
        fin, none = tfn(torch.as_tensor(psi), torch.as_tensor(table))
        assert none is None
        assert np.abs(fin.numpy() - _j2np(jfin)).max() <= 1e-12


def test_graphed_scan_on_the_cpu_is_the_loop():
    """Off the card :class:`GraphedScan` is the loop: equal to
    :func:`scan` bit for bit, on every call."""
    c0, a, b = _toy_inputs()
    step = _toy_step(torch.cos, torch.sin)
    run = GraphedScan(step)
    xs = (torch.as_tensor(a), torch.as_tensor(b))
    want = scan(step, torch.as_tensor(c0), xs)
    for _ in range(2):
        got = run(torch.as_tensor(c0), xs)
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(g, w) for g, w in zip(got[1], want[1]))


def test_loop_resumed_after_the_first_interval_equals_the_loop():
    """The scan's autograd branch (the first interval's results require
    grad) finishes as the loop from interval 1: equal to the whole loop,
    gradient included."""
    c0, a, b = _toy_inputs()
    w = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    toy = _toy_step(torch.cos, torch.sin)

    def step(c, x):
        return toy(w * c, x)

    xs = (torch.as_tensor(a), torch.as_tensor(b))
    c = torch.as_tensor(c0)
    carry1, y0 = step(c, scan_mod._map(lambda t: t[0], xs))
    got = scan_mod._loop(step, carry1, xs, 6, 1, [y0])
    want = scan_mod._loop(step, c, xs, 6)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(g, v) for g, v in zip(got[1], want[1]))
    g_got, = torch.autograd.grad(got[0].sum() + got[1][0].sum(), w)
    g_want, = torch.autograd.grad(want[0].sum() + want[1][0].sum(), w)
    assert torch.equal(g_got, g_want)


def test_graphed_scan_without_xs_on_the_cpu_any_length():
    """A step without ``xs`` and outputs: one :class:`GraphedScan` runs
    every length, each equal to the loop of that length."""
    step = lambda c, _: (0.9 * c + 0.1 * c.sum(), None)  # noqa: E731
    c0 = torch.as_tensor(_toy_inputs()[0])
    run = GraphedScan(step)
    for n in (2, 5, 3):
        got, ys = run(c0, None, n)
        assert ys is None
        assert torch.equal(got, scan_mod._loop(step, c0, None, n)[0])


def test_flip_coefficients_are_owned_by_the_plan():
    """The flip vector a captured step reads lives as long as its plan:
    made once per (extra bits, dtype, device) and kept on the plan, not
    in a cache that could free it under a live graph."""
    from quantumpropagators_torch.ops.fused_cheby import (make_flip_plan,
                                                          plan_coeffs)

    plan = make_flip_plan(L, np.linspace(0.5, 1.5, L))
    a = plan_coeffs(plan, torch.float64, "cpu")
    assert plan_coeffs(plan, torch.float64, torch.device("cpu")) is a
    assert plan_coeffs(plan, torch.float32, "cpu") is not a
    ext = plan_coeffs(plan, torch.float64, "cpu", (0.25,))
    assert ext.tolist() == list(plan.gs) + [0.25]
    assert a.tolist() == list(plan.gs)
    assert set(plan.device_gs.values()) >= {a, ext}
    assert plan == make_flip_plan(L, np.linspace(0.5, 1.5, L))
