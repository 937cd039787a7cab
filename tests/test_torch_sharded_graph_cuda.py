"""The sharded steps of ``quantumpropagators_torch.parallel`` as replayed
CUDA graphs on the card (``utils/scan.graphed``): each site against its
own body run eagerly, bit for bit, with equal kernel launches a call,
one capture over calls whose flip scale (a tensor, a host array or a
Python float) and coefficients change, and one more for a new operator
(``chip_smoke.hold_graphed``, as phase 17 holds them at full width); a
body that reads the host raises at capture; a scan over a graphed step
captures straight through it; a multi-rank mesh runs the body.  Under
autograd each differentiable site (``chip_smoke.GRAD_SITES``) replays
its forward graph and the graph of its VJP, its gradients equal to the
body's (``chip_smoke.hold_graphed_grad``), also with other graphs
replayed between a call and its backward, and a kernel-bodied site
raises naming its kernel.  Small sizes: L = 14 on 4 slots, 2^12 banded, 2^12 sparse.  Needs
an NVIDIA GPU with nvcc (``-m cuda``); skips without one.  Imports no
jax: run with ``--noconftest``."""

from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
import quantumpropagators_torch as qt
from quantumpropagators_torch.ops.bsr_dd import banded_dd_from_scipy
from quantumpropagators_torch.ops.cheby import cheby_coeffs
from quantumpropagators_torch.ops.operators import DiagonalOperator
from quantumpropagators_torch.parallel import sharded_banded as sbd
from quantumpropagators_torch.parallel import sharded_bsr as sbsr
from quantumpropagators_torch.parallel import sharded_chain as sch
from quantumpropagators_torch.parallel import sharded_csr as scsr
from quantumpropagators_torch.parallel import sharded_fused as sf
from quantumpropagators_torch.parallel.mesh import (chain_mesh, replicate,
                                                    shard_vector)
from quantumpropagators_torch.utils import scan as scan_mod

pytestmark = pytest.mark.cuda

L, SLOTS, N_CALLS, DT = 14, 4, 4, 0.05
G, H_FIELD = 1.2, 0.3
BOUND = (L - 1) + L * (G + H_FIELD)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", 0)
    scan_mod._graph_pool(device)
    return device


def _state(n, seed, device):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return torch.as_tensor(v / np.linalg.norm(v)).to(device)


def _chain_parts(device):
    mesh = chain_mesh(SLOTS, device=device)
    H_diag, H_x = qt.transverse_field_ising(L, J=1.0, g=G, h=H_FIELD,
                                            dtype=torch.float64,
                                            device=device)
    c = cheby_coeffs(2 * BOUND, DT)
    return mesh, H_diag, H_x, c, _state(2 ** L, 3, device)


def _site(name, device):
    """``(step, state, call, renew)`` of one site at a small size."""
    mesh, H_diag, H_x, c, psi = _chain_parts(device)
    kw = dict(delta=2 * BOUND, e_min=-BOUND, dt=DT)
    scales = np.random.default_rng(5).uniform(0.6, 1.4, N_CALLS)
    diag = H_diag.diag.real.to(torch.float64)
    if name.startswith("dd"):
        step = sf.make_sharded_fused_cheby_step_dd(mesh, L, G, **kw)
        dmb = shard_vector(mesh, diag)  # β = Δ/2 + E_min = 0
        if name == "dd tensor":
            fs = torch.as_tensor(np.outer(scales, np.ones(L)), device=device)
            scale = fs.__getitem__
        elif name == "dd per-bit tensor":
            # every bit its own scale, new each call: the slot bits'
            # partner weights must reach the replayed high pass
            fs = torch.as_tensor(np.random.default_rng(6).uniform(
                0.5, 1.5, (N_CALLS, L)), device=device)
            scale = fs.__getitem__
        elif name == "dd host array":
            scale = lambda k: np.full(L, scales[k])
        else:
            scale = lambda k: float(scales[k])
        return (step, shard_vector(mesh, psi),
                lambda k, st: ((dmb, st, c), {"flip_scale": scale(k)}),
                chip_smoke._renew_first)
    if name.startswith("f32"):
        step = sf.make_sharded_fused_cheby_step(mesh, L, G, **kw)
        p32 = psi.to(torch.complex64)
        ri = (shard_vector(mesh, p32.real.contiguous()),
              shard_vector(mesh, p32.imag.contiguous()))
        d = shard_vector(mesh, diag)
        table = torch.as_tensor(scales, dtype=torch.float32, device=device)
        scale = table.__getitem__ if name == "f32 tensor" \
            else (lambda k: float(scales[k]))
        return (step, ri,
                lambda k, st: ((d, *st, c), {"flip_scale": scale(k)}),
                chip_smoke._renew_first)
    if name == "chain step":
        op = sch.prepare_sharded_operator(qt.Operator([H_diag, H_x], [1.0]),
                                          SLOTS)
        step = sch.make_sharded_cheby_step(mesh, op, **kw)
        cc = replicate(mesh, torch.as_tensor(c))

        def renew(args, kwargs):
            o = args[0]
            new = qt.Operator([DiagonalOperator(o.ops[0].diag.clone()),
                               *o.ops[1:]], o.coeffs)
            return (new,) + tuple(args[1:]), kwargs

        return step, psi, lambda k, st: ((op, st, cc), {}), renew
    rng = np.random.default_rng(7)
    N = 2 ** 12
    A = sp.diags([rng.standard_normal(N - abs(k)) for k in range(-9, 10)],
                 list(range(-9, 10))).tocsr()
    A = (0.5 * (A + A.T)).tocsr()
    bound = float(np.abs(A).sum(axis=1).max())
    bkw = dict(delta=2 * bound, e_min=-bound, dt=DT)
    cb = cheby_coeffs(2 * bound, DT)
    x = _state(N, 9, device)
    xs = [_state(N, 10 + k, device) for k in range(N_CALLS)]
    if name == "banded step":
        pb, step, kind = sbd.make_sharded_dd_cheby_step(
            mesh, banded_dd_from_scipy(A, block=128, device=device), SLOTS,
            tile_rows=1, **bkw)
        assert kind == "banded_pallas"
        return (step, x, lambda k, st: ((pb, st, cb), {}),
                chip_smoke._renew_field("edge_left"))
    pbsr = sbsr.partition_bsr(A, SLOTS, block_size=64, device=device)
    if name == "BSR step":
        cc = replicate(mesh, torch.as_tensor(cb))
        return (sbsr.make_sharded_bsr_cheby_step(mesh, pbsr, **bkw), x,
                lambda k, st: ((pbsr, st, cc), {}),
                chip_smoke._renew_field("cols"))
    if name == "BSR dd step":
        pdd = sbsr.partition_bsr_dd(A, SLOTS, block_size=64, device=device)
        return (sbsr.make_sharded_bsr_cheby_step_dd(mesh, pdd, **bkw), x,
                lambda k, st: ((pdd, st, cb), {}),
                chip_smoke._renew_field("cols"))
    parts = {
        "BSR halo apply": (pbsr, sbsr.make_banded_bsr_apply, "cols"),
        "BSR all-gather apply": (
            sbsr.partition_bsr(A, SLOTS, block_size=64, mode="allgather",
                               device=device),
            sbsr.make_allgather_bsr_apply, "cols"),
        "CSR all-gather apply": (
            scsr.partition_csr_rows(A, SLOTS, device=device),
            scsr.make_allgather_csr_apply, "data"),
        "CSR halo apply": (
            scsr.partition_csr_banded(A, SLOTS, device=device),
            scsr.make_banded_csr_apply, "data"),
    }
    part, make, field = parts[name]
    return (make(mesh, part), x, lambda k, _: ((part, xs[k]), {}),
            chip_smoke._renew_field(field))


SITES = ["dd tensor", "dd per-bit tensor", "dd host array", "dd float", "f32 tensor", "f32 float",
         "banded step", "BSR step", "BSR dd step", "chain step",
         "BSR halo apply", "BSR all-gather apply", "CSR all-gather apply",
         "CSR halo apply"]


@pytest.mark.parametrize("name", SITES)
def test_site_graph_equals_eager(cuda, name):
    """Bit for bit, equal launches, one capture over the calls (new flip
    scales and coefficient rows every call) and one more for a new
    operator (``hold_graphed`` raises otherwise)."""
    step, state, call, renew = _site(name, cuda)
    out = chip_smoke.hold_graphed(name, step, state, call, N_CALLS, renew,
                                  "test")
    if name.startswith(("dd", "f32", "banded")):
        assert any(out["launches"].values())


def test_body_that_reads_the_host_raises(cuda):
    mesh = chain_mesh(SLOTS, device=cuda)
    step = scan_mod.graphed(lambda x: x * float(x.abs().max()), mesh=mesh)
    x = _state(64, 1, cuda)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        step(x)
    assert step.captures == 0
    # the card goes on: a good step captures on the new side stream
    good = scan_mod.graphed(lambda x: 2.0 * x, mesh=mesh)
    assert torch.equal(good(x), 2.0 * x) and good.captures == 1


def test_scan_over_a_graphed_step_captures_through_it(cuda):
    step, state, call, _ = _site("dd tensor", cuda)
    (dmb, _, c), kw = call(0, state)
    flip = kw["flip_scale"]

    def scan_step(st, _):
        return step(dmb, st, c, flip_scale=flip), None

    chip_smoke._reset_launches()
    got, _ = scan_mod.GraphedScan(scan_step)(state, None, N_CALLS)
    n_scan = chip_smoke._launch_counts()
    assert step.captures == 1  # the scan's eager first interval
    chip_smoke._reset_launches()
    want = state
    for _ in range(N_CALLS):
        want = step.body(dmb, want, c, flip_scale=flip)
    assert torch.equal(got, want)
    assert n_scan == chip_smoke._launch_counts()


def test_multi_rank_mesh_runs_the_body(cuda):
    x = _state(64, 2, cuda)
    wide = scan_mod.graphed(lambda x: 3.0 * x,
                            mesh=SimpleNamespace(world_size=2))
    assert torch.equal(wide(x), 3.0 * x) and wide.captures == 0


def test_autograd_replays_the_forward_and_its_vjp(cuda):
    """Under autograd a call is the graphed forward and VJP: two
    captures at the first call, none after; each call's gradient its
    own, accumulated over calls."""
    x = _state(64, 2, cuda)
    step = scan_mod.graphed(lambda x: 3.0 * x)
    y = x.real.clone().requires_grad_(True)
    for k in range(3):
        out = step(y)
        assert type(out.grad_fn).__name__ == "_GraphedVJPBackward"
        out.sum().backward()
        assert step.captures == 2
        assert torch.equal(y.grad, torch.full_like(y, 3 * (k + 1)))


# -- under autograd: the forward graph and the graph of its VJP -------------

def _grad_site(name, device):
    """``(step, inputs, call)`` of one differentiable site on 4 slots:
    the L = 14 chain, the 2^12 banded matrix of :func:`_site`."""
    rng = np.random.default_rng(7)
    N = 2 ** 12
    A = sp.diags([rng.standard_normal(N - abs(k)) for k in range(-9, 10)],
                 list(range(-9, 10))).tocsr()
    A = (0.5 * (A + A.T)).tocsr()
    mesh = chain_mesh(SLOTS, device=device)
    return chip_smoke.grad_sites(mesh, device, L, A, names=(name,))[name]


@pytest.mark.parametrize("calls", [1, 3])
@pytest.mark.parametrize("name", chip_smoke.GRAD_SITES)
def test_graphed_gradients_equal_eager(cuda, name, calls):
    """One call, and three chained calls with one backward: every
    gradient equal to the body's loop bit for bit (the CSR applies
    within 1e-14 relative: their backward adds with atomics; over
    chained calls the chain's amplitude within 1e-12), the first call
    too; two captures for the key and none after; two graph replays a
    call and no call of the body (``chip_smoke.hold_graphed_grad``
    raises otherwise)."""
    step, inputs, call = _grad_site(name, cuda)
    chip_smoke.hold_graphed_grad(name, step, inputs, call, calls, "test",
                                 chip_smoke.grad_tols(name, calls))


@pytest.mark.parametrize("name", chip_smoke.GRAD_SITES)
def test_create_graph_reruns_the_body(cuda, name):
    """A backward with ``create_graph=True`` reruns the call's body:
    second derivatives equal the body's double backward within 1e-13
    relative."""
    step, inputs, call = _grad_site(name, cuda)
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]

    def second(fn):
        out = call(fn, ins[0], ins)
        g, = torch.autograd.grad((out.real ** 2 + out.imag ** 2).sum(),
                                 ins[0], create_graph=True)
        return torch.autograd.grad((g.real ** 2 + g.imag ** 2).sum(), ins)

    second(step)  # the first call: the warm-up, then the two captures
    for got, want in zip(second(step), second(step.body)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-13 * scale + 1e-15
    assert step.captures == 2


def test_other_graphs_between_forward_and_backward(cuda):
    """A call's residuals stay in its forward graph's own pool: graphs
    of other steps captured and replayed between its forward and its
    backward (the shared pool of the no-grad route) leave its gradient
    equal to the body's loop bit for bit."""
    step, inputs, call = _grad_site("BSR step", cuda)
    other, o_inputs, o_call = _grad_site("BSR halo apply", cuda)
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]

    def grads(fn, between=()):
        out = call(fn, call(fn, ins[0], ins), ins)
        for k in between:
            with torch.no_grad():
                o_call(other, o_inputs[0] * (k + 1), o_inputs)
        return torch.autograd.grad((out.real ** 2 + out.imag ** 2).sum(),
                                   ins)

    want = grads(step.body)
    grads(step)  # the first call: the warm-up, then the two captures
    for got, w in zip(grads(step, between=range(3)), want):
        assert torch.equal(got, w)
    assert step.captures == 2 and other.captures == 1


@pytest.mark.parametrize("name", ["dd tensor", "f32 tensor", "banded step",
                                  "BSR step", "chain step"])
def test_no_grad_keeps_the_forward_graph(cuda, name):
    """Under ``torch.no_grad()`` a state that requires grad takes the
    forward's one graph: bit for bit, equal launches, one capture
    (``hold_graphed``), no autograd key."""
    step, state, call, renew = _site(name, cuda)
    state = scan_mod._map(lambda t: t.detach().clone().requires_grad_(True),
                          state)
    with torch.no_grad():
        chip_smoke.hold_graphed(name, step, state, call, N_CALLS, renew,
                                "test")
    assert step._grad is None


def test_kernel_launch_under_autograd_raises(cuda):
    """A launch takes no part in autograd: its result would be cut from
    the graph (the raw launch shows it), so a wrapper given an input
    that requires grad raises naming the kernel, and a kernel-bodied
    site under autograd raises at its first call; under ``no_grad`` both
    run."""
    from quantumpropagators_torch.ops import banded_spmv as bs
    from quantumpropagators_torch.ops import cheby_flip as cf

    Lk = 12
    _, v1, _, _, G, _ = chip_smoke.kernel_inputs(Lk, "double", cuda, 3)
    leaf = v1.clone().requires_grad_(True)
    cut = cf._launch_high(leaf, G, None, Lk, 2)
    assert not cut.requires_grad  # the fault the wrappers refuse
    with pytest.raises(RuntimeError,
                       match=r"cheby_flip_high<double>.*no backward"):
        cf.cheby_flip_high(leaf, G, 2)
    with torch.no_grad():
        assert torch.equal(cf.cheby_flip_high(leaf, G, 2), cut)
    planes = torch.ones((1, 8, 4, 8), dtype=torch.float64, device=cuda)
    x = _state(32, 4, cuda).requires_grad_(True)
    with pytest.raises(RuntimeError, match=r"banded_spmv<double>"):
        bs.banded_spmv(planes, (0,), x)
    step, state, call, _ = _site("dd tensor", cuda)
    args, kwargs = call(0, state.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match=r"cheby_flip_\w+<double>"):
        step(*args, **kwargs)
    assert step._grad is None and step.captures == 0
    with torch.no_grad():
        step(*args, **kwargs)
    assert step.captures == 1
