"""Gradients through the differentiable sharded sites of
``quantumpropagators_torch.parallel`` against ``jax.grad`` of the JAX
package's ``jax.jit(shard_map(...))`` steps on its 8 virtual CPU
devices.

Sites: the BSR Chebyshev step (``make_sharded_bsr_cheby_step``), the
chain step over ``sharded_apply`` (``make_sharded_cheby_step``, with the
operator's amplitude a tensor), the BSR halo and all-gather applies, the
CSR all-gather and halo applies, and the BSR dd step (complex128 in the
port, so held against ``jax.grad`` of the JAX complex128 step on the
same real operator).  The loss is ``Σ w |out|²`` with seeded weights, of
one call and of three chained calls; the gradients with respect to the
state, a tensor of Chebyshev coefficients and the chain's amplitude
equal ``conj(jax.grad)`` for the state (PyTorch's gradient of a complex
input is the conjugate of JAX's) and ``jax.grad`` for the real inputs,
within 1e-12 relative for the steps and 1e-13 for the applies, on
meshes of 1, 2 and 8 slots in one process.  Each case runs two routes:
the body under autograd (the CPU's route) and the card's
``autograd.Function`` (``utils/scan._GradCall``) with the CPU taken
for the card and its graphs replaced by direct calls
(:func:`_as_on_the_card`).  That route is also
held bit for bit against the eager loop of three calls and one
backward.  The JAX package's three Pallas-bodied sites have no
``jax.grad`` (a ``pallas_call`` has no transpose) and are not here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.models.lattice import transverse_field_ising
from quantumpropagators.ops.cheby import cheby_coeffs
from quantumpropagators.parallel import mesh as jax_mesh
from quantumpropagators.parallel import sharded_bsr as jax_sbsr
from quantumpropagators.parallel import sharded_chain as jax_sch
from quantumpropagators.parallel import sharded_csr as jax_scsr
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch.parallel import sharded_bsr as sbsr
from quantumpropagators_torch.parallel import sharded_chain as sch
from quantumpropagators_torch.parallel import sharded_csr as scsr
from quantumpropagators_torch.parallel.mesh import chain_mesh
from quantumpropagators_torch.utils import scan as scan_mod
from test_torch_sharded_sparse import (block_tridiag, random_banded,
                                       _state)

qt.set_default_device("cpu")

SLOTS = [1, 2, 8]
ROUTES = ["body", "function"]
L_CHAIN, DT, AMP, N_CHAINED = 10, 0.1, 0.9, 3
STEPS = ["chain step", "BSR step", "BSR dd step"]
APPLIES = ["BSR halo apply", "BSR all-gather apply", "CSR all-gather apply",
           "CSR halo apply"]


def _loss(xp, out, w):
    return (w * (out.real ** 2 + out.imag ** 2)).sum()


@functools.cache
def _problem():
    """The operators, states, weights and coefficients of every site:
    the L = 10 chain, the R = 16, b = 4 block-tridiagonal BSR matrices of
    ``test_torch_sharded_sparse.py`` (complex, real, and one with a far
    coupling) and its N = 256 CSR matrices."""
    rng = np.random.default_rng(23)
    H_diag, H_x = transverse_field_ising(L_CHAIN, J=1.0, g=1.2, h=0.3,
                                         dtype=jnp.complex128)
    bound = (L_CHAIN - 1) + 0.3 * L_CHAIN + 1.2 * L_CHAIN
    R, b = 16, 4
    A = block_tridiag(R, b, rng)
    A = (0.5 * (A + A.conj().T)).tocsr()
    Ar = block_tridiag(R, b, rng, dtype=float)
    Ar = (0.5 * (Ar + Ar.T)).tocsr()
    far = A.tolil()
    far[0, R * b - 1] = far[R * b - 1, 0] = 0.3
    bsr_bound = max(float(np.abs(M).sum(axis=1).max()) for M in (A, Ar))
    N = 256
    B = random_banded(N, 12, rng)
    C = (0.3 * random_banded(N, 200, rng, density=0.05)).tocsr()
    return dict(
        chain=(H_diag, H_x, bound), A=A, Ar=Ar, far=far.tocsr(), b=b,
        bsr_bound=bsr_bound, csr_banded=B, csr_any=C,
        psi={n: _state(rng, n) for n in (2 ** L_CHAIN, R * b, N)},
        w={n: rng.uniform(0.5, 1.5, n) for n in (2 ** L_CHAIN, R * b, N)},
        coeffs=cheby_coeffs(2 * bound, DT),
        bsr_coeffs=cheby_coeffs(2 * bsr_bound, DT))


def _jax_grads(fn, args, w, calls):
    """``jax.grad`` of the loss of ``n`` chained calls of
    ``fn(state, *rest)`` with respect to every argument, for each ``n``
    of ``calls`` (one program)."""
    def loss(n, *a):
        out = a[0]
        for _ in range(n):
            out = fn(out, *a[1:])
        return _loss(jnp, out, w)

    argnums = tuple(range(1, len(args) + 1))
    got = jax.jit(lambda *a: [jax.grad(loss, argnums)(n, *a)
                              for n in calls])(*args)
    return {n: [np.asarray(g) for g in gs] for n, gs in zip(calls, got)}


@pytest.fixture(scope="module")
def want():
    """Every site's JAX gradients, of one call and of three chained
    calls (steps), on the JAX package's 8-device mesh."""
    p = _problem()
    mesh = jax_mesh.chain_mesh(8)
    out = {}
    H_diag, H_x, bound = p["chain"]
    op_sh = jax_sch.prepare_sharded_operator(
        qp.Operator([H_diag, H_x], np.array([AMP])), 8, group_bits=4)
    step = jax_sch.make_sharded_cheby_step(mesh, op_sh, delta=2 * bound,
                                           e_min=-bound, dt=DT)
    n = 2 ** L_CHAIN
    args = (jax_mesh.shard_vector(mesh, jnp.asarray(p["psi"][n])),
            jnp.asarray(p["coeffs"]), jnp.asarray([AMP]))
    fn = lambda v, c, a: step(qp.Operator(op_sh.ops, a), v, c)
    for calls, g in _jax_grads(fn, args, p["w"][n],
                               (1, N_CHAINED)).items():
        out["chain step", calls] = g
    n = p["A"].shape[0]
    kw = dict(delta=2 * p["bsr_bound"], e_min=-p["bsr_bound"], dt=DT)
    sv = jax_mesh.shard_vector(mesh, jnp.asarray(p["psi"][n]))
    for name, M in (("BSR step", p["A"]), ("BSR dd step", p["Ar"])):
        pb = jax_sbsr.partition_bsr(M, 8, block_size=p["b"])
        step = jax_sbsr.make_sharded_bsr_cheby_step(mesh, pb, **kw)
        for calls, g in _jax_grads(
                lambda v, c, step=step, pb=pb: step(pb, v, c),
                (sv, jnp.asarray(p["bsr_coeffs"])), p["w"][n],
                (1, N_CHAINED)).items():
            out[name, calls] = g
    pb = jax_sbsr.partition_bsr(p["A"], 8, block_size=p["b"])
    pg = jax_sbsr.partition_bsr(p["far"], 8, block_size=p["b"],
                                mode="allgather")
    N = p["csr_banded"].shape[0]
    svN = jax_mesh.shard_vector(mesh, jnp.asarray(p["psi"][N]))
    pa = jax_scsr.partition_csr_rows(p["csr_any"], 8)
    pc = jax_scsr.partition_csr_banded(p["csr_banded"], 8)
    for name, part, make, v in (
            ("BSR halo apply", pb, jax_sbsr.make_banded_bsr_apply, sv),
            ("BSR all-gather apply", pg, jax_sbsr.make_allgather_bsr_apply,
             sv),
            ("CSR all-gather apply", pa, jax_scsr.make_allgather_csr_apply,
             svN),
            ("CSR halo apply", pc, jax_scsr.make_banded_csr_apply, svN)):
        apply = make(mesh, part)
        out[name, 1] = _jax_grads(lambda x, f=apply, q=part: f(q, x), (v,),
                                  p["w"][v.shape[0]], (1,))[1]
    return out


def _site(name, slots):
    """The port's site on ``slots`` slots: ``(step, call, inputs)``,
    ``call(step, state, inputs)`` one call, ``inputs`` the tensors to
    differentiate (the state first)."""
    p = _problem()
    mesh = chain_mesh(slots, device="cpu")
    if name == "chain step":
        H_diag, H_x, bound = p["chain"]
        op = sch.prepare_sharded_operator(
            qt.Operator([from_jax(H_diag), from_jax(H_x)],
                        torch.tensor([AMP], dtype=torch.float64)),
            slots, group_bits=4)
        amp = torch.tensor([AMP], dtype=torch.float64)
        step = sch.make_sharded_cheby_step(mesh, op, delta=2 * bound,
                                           e_min=-bound, dt=DT)
        inputs = [torch.as_tensor(p["psi"][2 ** L_CHAIN]),
                  torch.as_tensor(p["coeffs"]), amp]

        def call(step, v, ins):
            return step(qt.Operator(op.ops, ins[2]), v, ins[1])

        return step, call, inputs
    if name in ("BSR step", "BSR dd step"):
        M = p["A"] if name == "BSR step" else p["Ar"]
        kw = dict(delta=2 * p["bsr_bound"], e_min=-p["bsr_bound"], dt=DT)
        if name == "BSR step":
            part = sbsr.partition_bsr(M, slots, block_size=p["b"])
            step = sbsr.make_sharded_bsr_cheby_step(mesh, part, **kw)
        else:
            part = sbsr.partition_bsr_dd(M, slots, block_size=p["b"])
            step = sbsr.make_sharded_bsr_cheby_step_dd(mesh, part, **kw)
        inputs = [torch.as_tensor(p["psi"][M.shape[0]]),
                  torch.as_tensor(p["bsr_coeffs"])]
        return step, (lambda step, v, ins: step(part, v, ins[1])), inputs
    part, make = {
        "BSR halo apply": (
            lambda: sbsr.partition_bsr(p["A"], slots, block_size=p["b"]),
            sbsr.make_banded_bsr_apply),
        "BSR all-gather apply": (
            lambda: sbsr.partition_bsr(p["far"], slots, block_size=p["b"],
                                       mode="allgather"),
            sbsr.make_allgather_bsr_apply),
        "CSR all-gather apply": (
            lambda: scsr.partition_csr_rows(p["csr_any"], slots),
            scsr.make_allgather_csr_apply),
        "CSR halo apply": (
            lambda: scsr.partition_csr_banded(p["csr_banded"], slots),
            scsr.make_banded_csr_apply),
    }[name]
    part = part()
    n = part.shape[0]
    return (make(mesh, part), (lambda step, v, ins: step(part, v)),
            [torch.as_tensor(p["psi"][n])])


def _leaves(inputs):
    return [t.clone().requires_grad_(True) for t in inputs]


def _grads(step, call, ins, n_calls, fn=None):
    """The loss of ``n_calls`` chained calls and its gradients with
    respect to the leaves ``ins``."""
    out = ins[0]
    for _ in range(n_calls):
        out = call(fn or step, out, ins)
    loss = _loss(torch, out, torch.as_tensor(_problem()["w"][out.numel()]))
    return out, loss, torch.autograd.grad(loss, ins)


class _Direct:
    """A captured graph's stand-in on the CPU: a replay calls the
    captured function again."""

    def __init__(self, fn):
        self.replay = fn

    def pool(self):
        return None


def _as_on_the_card(monkeypatch):
    """The card's route of a :class:`Graphed` call under autograd, on
    CPU tensors: the CPU taken for the card (as long as grad mode is on
    and a tensor requires grad, outside any recording), a first call
    run where it is, a capture a call of its function and a replay
    another, as ``scan``'s tape runs on the CPU."""

    def route(self, arguments):
        tensors = []
        scan_mod._walk(arguments, tensors, set(), keyed=False)
        if not tensors or scan_mod._Saved.depth or not (
                torch.is_grad_enabled()
                and any(t.requires_grad for t in tensors)):
            return None, False
        return tensors[0].device, True

    monkeypatch.setattr(scan_mod.Graphed, "_route", route)
    monkeypatch.setattr(scan_mod, "_first_on_side",
                        lambda step, device, fn, what="scan": fn())
    monkeypatch.setattr(scan_mod, "_captured",
                        lambda device, fn, refused, pool=None:
                        (_Direct(fn), fn(), ()))


def _route(route, monkeypatch):
    if route == "function":
        _as_on_the_card(monkeypatch)


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _hold(grads, want, tol):
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        w = np.conj(w) if i == 0 else w  # the state's: conj(jax.grad)
        assert g.shape == w.shape and _rel(g.detach().numpy(), w) < tol


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("name", STEPS)
def test_step_gradients_match_jax(want, name, slots, route, monkeypatch):
    """One call, and three chained calls with one backward: the state,
    the coefficients (and the chain's amplitude) against ``jax.grad``
    to 1e-12 relative.  The function route's results are its node's."""
    _route(route, monkeypatch)
    step, call, inputs = _site(name, slots)
    for calls in (1, N_CHAINED):
        out, _, grads = _grads(step, call, _leaves(inputs), calls)
        _hold(grads, want[name, calls], 1e-12)
    graphed = type(out.grad_fn).__name__ == "_GraphedVJPBackward"
    assert graphed == (route == "function")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("name", APPLIES)
def test_apply_gradients_match_jax(want, name, slots, route, monkeypatch):
    """The state's gradient through each apply against ``jax.grad`` to
    1e-13 relative; a second call (the function route's template)
    too."""
    _route(route, monkeypatch)
    step, call, inputs = _site(name, slots)
    ins = _leaves(inputs)
    for _ in range(2):
        _, _, grads = _grads(step, call, ins, 1)
        _hold(grads, want[name, 1], 1e-13)


@pytest.mark.parametrize("name", STEPS + APPLIES)
def test_function_route_equals_the_eager_loop(name, monkeypatch):
    """The card's bookkeeping with calls for replays, on 2 slots: the
    first call's warm-up and two captures, then every call replaying the
    template, each node holding its residuals: three chained calls and
    one backward
    equal the body's loop bit for bit (the chain's amplitude, read in
    place by every call, within 1e-12 relative), twice over (the second
    time every call is a later call); ``create_graph=True`` reruns the
    body from its inputs as views (second derivatives of one and of two
    chained calls within 1e-13 relative of the body's; chained calls
    with the amplitude read in place are refused)."""
    step, call, inputs = _site(name, 2)
    ins = _leaves(inputs)
    want = _grads(step, call, ins, N_CHAINED, fn=step.body)
    _as_on_the_card(monkeypatch)
    for _ in range(2):
        got = _grads(step, call, ins, N_CHAINED)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for g, w, read_in_place in zip(got[2], want[2], (0, 0, 1)):
            # the amplitude's gradient is each call's sum, then the sum
            # over calls (as jax.grad adds the cotangents of a loop of
            # jitted calls); the loop adds all terms in one running sum
            assert _rel(g.numpy(), w.numpy()) < 1e-12 if read_in_place \
                else torch.equal(g, w)
    assert step._grad is not None and step.captures == 2

    def second(fn, calls):
        out = ins[0]
        for _ in range(calls):
            out = call(fn, out, ins)
        g = torch.autograd.grad(_loss(torch, out, 1.0), ins[0],
                                create_graph=True)[0]
        return torch.autograd.grad(_loss(torch, g, torch.as_tensor(
            _problem()["w"][g.numel()])), ins)

    for calls in (1, 2):
        if calls == 2 and name == "chain step":
            # the amplitude read in place is also in the second call's
            # input's history: refused rather than counted twice
            with pytest.raises(RuntimeError, match="create_graph"):
                second(step, calls)
            continue
        for g, w in zip(second(step, calls), second(step.body, calls)):
            # atol: the amplitude's second derivative here is ~1e-14
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-13,
                                       atol=1e-15)


def test_scan_over_a_graphed_step_records_its_body(monkeypatch):
    """Inside a recording scan (``_Tape``) a graphed step runs its body,
    whose saves are the interval's own: the scan's gradient equals the
    loop's bit for bit, and the step keeps no autograd key."""
    _as_on_the_card(monkeypatch)
    step, call, inputs = _site("BSR step", 2)
    ins = [inputs[0].clone().requires_grad_(True), inputs[1]]

    def interval(v, _):
        return call(step, v, ins), None

    got = scan_mod.scan(interval, ins[0], length=N_CHAINED)[0]
    assert type(got.grad_fn).__name__ == "_ScanVJPBackward"
    w = torch.as_tensor(_problem()["w"][got.numel()])
    grad, = torch.autograd.grad(_loss(torch, got, w), ins[0])
    want = ins[0]
    for _ in range(N_CHAINED):
        want = call(step.body, want, ins)
    assert torch.equal(got, want) and step._grad is None
    assert torch.equal(grad, torch.autograd.grad(_loss(torch, want, w),
                                                 ins[0])[0])


@pytest.mark.parametrize("wrapper", ["cheby_flip_first", "cheby_flip_iter",
                                     "cheby_flip_high"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(wrapper,
                                                         monkeypatch):
    """On the card a flip wrapper given an input that requires grad
    (grad mode on) raises naming its kernel: the launch takes no part in
    autograd.  Run here with the device check and the launches
    replaced, so that the wrappers' CUDA branch runs on CPU tensors
    (``banded_spmv``'s refusal: ``test_torch_sharded_graph_cuda.py``)."""
    from quantumpropagators_torch.ops import cheby_flip as cf

    class Launched(Exception):
        pass

    def launched(*args, **kwargs):
        raise Launched

    L = 10
    rng = np.random.default_rng(5)
    v0, v1, phi = (torch.as_tensor(rng.standard_normal(2 ** L) + 0j)
                   for _ in range(3))
    dmb = torch.as_tensor(rng.standard_normal(2 ** L))
    G = torch.as_tensor(rng.uniform(0.5, 1.5, L))
    monkeypatch.setattr(cf, "_device_kind", lambda v: "cuda")
    for launch in ("_launch_first", "_launch_iter", "_launch_high"):
        monkeypatch.setattr(cf, launch, launched)
    args = {"cheby_flip_first": (v0, dmb, G, 0.1, 0.5, 0.2),
            "cheby_flip_iter": (v0, v1, phi, dmb, G, 0.2, 0.3),
            "cheby_flip_high": (v1, G, 2)}[wrapper]
    name, fn = f"{wrapper}<double>", getattr(cf, wrapper)
    for i, t in enumerate(args):
        if not isinstance(t, torch.Tensor) or not t.is_floating_point() \
                and not t.is_complex():
            continue
        given = list(args)
        given[i] = t.clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
            fn(*given)
        with torch.no_grad(), pytest.raises(Launched):
            fn(*given)


def test_residuals_are_cloned_only_when_overwritten(monkeypatch):
    """A call's residuals stay in the stacks until the next call
    overwrites them: a call and its backward clone nothing, three
    chained calls and one backward clone two; a second backward
    (``retain_graph=True``) after a later call overwrote the stacks
    reruns the body and gives the same gradients."""
    _as_on_the_card(monkeypatch)
    step, call, inputs = _site("BSR step", 2)
    ins = _leaves(inputs)
    cloned = []
    evict = scan_mod._GradCall._evict

    def counted(self):
        ctx = self.holder and self.holder()
        cloned.append(ctx is not None and not ctx.done)
        evict(self)

    monkeypatch.setattr(scan_mod._GradCall, "_evict", counted)
    _grads(step, call, ins, 1)  # the first call: warm-up, captures
    for _ in range(3):
        _grads(step, call, ins, 1)
    assert cloned and not any(cloned)
    cloned.clear()
    want = _grads(step, call, ins, N_CHAINED)
    assert sum(cloned) == N_CHAINED - 1
    out = ins[0]
    for _ in range(N_CHAINED):
        out = call(step, out, ins)
    loss = _loss(torch, out, torch.as_tensor(_problem()["w"][out.numel()]))
    first = torch.autograd.grad(loss, ins, retain_graph=True)
    call(step, ins[0], ins)  # overwrites the stacks
    again = torch.autograd.grad(loss, ins)
    for a, b, c in zip(first, again, want[2]):
        assert torch.equal(a, c) and torch.equal(b, c)
