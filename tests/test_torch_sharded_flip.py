"""Port vs JAX package: the sharded fused flip step (mirrors
``test_sharded_fused.py``) on meshes of 1, 2 and 8 shard slots in one
process.

The JAX references are computed once per module: the JAX package's
sharded f32-tier step on its 8-device mesh (Pallas in interpret mode,
float64 arrays as its tests use), and its complex128 ``cheby_apply`` on
the same operator for the reference tier (the JAX tests hold their
sharded dd step against that ``cheby_apply`` to 1e-12; one interpret-mode
call of the dd step costs about 20 s here).  Per-bit flip scales and the
weak-site permutation are held against an f64 numpy oracle, as the JAX
tests hold them."""

import inspect
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.models.lattice import transverse_field_ising
from quantumpropagators.ops.cheby import cheby_apply as jax_cheby_apply
from quantumpropagators.ops.cheby import cheby_coeffs
from quantumpropagators.parallel import mesh as jax_mesh
from quantumpropagators.parallel import sharded_fused as jax_sf
from quantumpropagators_torch.ops import cheby_flip as cf
from quantumpropagators_torch.ops import fused_cheby as fc
from quantumpropagators_torch.ops import fused_cheby_dd as fcd
from quantumpropagators_torch.parallel import sharded_fused as sf
from quantumpropagators_torch.parallel.mesh import Mesh, chain_mesh

qt.set_default_device("cpu")

L, J, G, H = 13, 1.0, 1.2, 0.3
DT = 0.06
FS = 0.7342915  # g(t)/g at one interval
SLOTS = [1, 2, 8]


def _np_cheby_oracle(diag64, g_bits, Lb, psi, coeffs, delta, e_min, dt):
    """f64 numpy oracle: exp(-i H dt) for H = diag + Σ_j g_j X_j."""
    idx = np.arange(1 << Lb)
    beta = delta / 2 + e_min
    c = -2.0j / delta

    def mv(v):
        out = diag64 * v
        for j in range(Lb):
            if g_bits[j] != 0.0:
                out = out + g_bits[j] * v[idx ^ (1 << j)]
        return out

    v0 = np.asarray(psi, np.complex128)
    v1 = c * (mv(v0) - beta * v0)
    phi = coeffs[0] * v0 + coeffs[1] * v1
    for a in coeffs[2:]:
        v2 = 2.0 * c * (mv(v1) - beta * v1) + v0
        phi = phi + a * v2
        v0, v1 = v1, v2
    return np.exp(-1j * beta * dt) * phi


@pytest.fixture(scope="module")
def problem():
    H_diag, _ = transverse_field_ising(L, J=J, g=G, h=H, dtype=jnp.float64)
    bound = J * (L - 1) + abs(H) * L + G * L
    rng = np.random.default_rng(23)
    psi = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi /= np.linalg.norm(psi)
    return np.array(H_diag.diag, np.float64), psi, -bound, 2 * bound


@pytest.fixture(scope="module")
def jax_ref(problem):
    diag, psi, e_min, delta = problem
    coeffs = jnp.asarray(cheby_coeffs(delta, DT))
    mesh = jax_mesh.chain_mesh(8)
    step = jax_sf.make_sharded_fused_cheby_step(
        mesh, L, G, delta=delta, e_min=e_min, dt=DT, tile_rows=8,
        interpret=True,
    )

    def sv(x):
        return jax_mesh.shard_vector(mesh, jnp.asarray(x))

    r, i = step(sv(diag), sv(psi.real), sv(psi.imag), coeffs, 0.65)
    H_diag, H_x = transverse_field_ising(L, J=J, g=G, h=H, dtype=jnp.float64)

    def xla(scale):
        op = qp.Operator([H_diag, H_x.grouped(7)], np.array([scale]))
        return np.asarray(jax_cheby_apply(op, jnp.asarray(psi), coeffs,
                                          delta, e_min, DT))

    return {"f32_0.65": np.asarray(r) + 1j * np.asarray(i),
            "dd": xla(1.0), f"dd_{FS}": xla(FS)}


def _dd_inputs(problem, slots, **kw):
    diag, psi, e_min, delta = problem
    step = sf.make_sharded_fused_cheby_step_dd(
        chain_mesh(slots, device="cpu"), L, G, delta=delta, e_min=e_min,
        dt=DT, **kw)
    beta = delta / 2 + e_min
    return (step, torch.as_tensor(diag - beta), torch.as_tensor(psi),
            cheby_coeffs(delta, DT))


def test_sharded_flip_plan_split():
    plan, dev_gs = sf.sharded_flip_plan(16, 2.0, 8, tile_rows=8)
    jplan, jdev_gs = jax_sf.sharded_flip_plan(16, 2.0, 8, tile_rows=8)
    assert plan.L == jplan.L == 13 and plan.gs == jplan.gs
    assert dev_gs == jdev_gs == (2.0, 2.0, 2.0)
    with pytest.raises(ValueError, match="power of two"):
        sf.sharded_flip_plan(16, 1.0, 6)


@pytest.mark.parametrize("slots", SLOTS)
def test_sharded_fused_step_matches_jax(problem, jax_ref, slots):
    """f32-tier step with a time-dependent flip scale (float64 arrays, as
    the JAX test runs it) against the JAX sharded step."""
    diag, psi, e_min, delta = problem
    step = sf.make_sharded_fused_cheby_step(
        chain_mesh(slots, device="cpu"), L, G, delta=delta, e_min=e_min,
        dt=DT, tile_rows=8, interpret=True,
    )
    r, i = step(torch.as_tensor(diag), torch.as_tensor(psi.real),
                torch.as_tensor(psi.imag), cheby_coeffs(delta, DT), 0.65)
    got = r.numpy() + 1j * i.numpy()
    assert np.abs(got - jax_ref["f32_0.65"]).max() < 1e-12


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("fs", [None, FS])
def test_sharded_fused_dd_step_matches_jax(problem, jax_ref, slots, fs):
    step, dmb, psi, coeffs = _dd_inputs(problem, slots)
    got = step(dmb, psi, coeffs, flip_scale=fs).numpy()
    want = jax_ref["dd" if fs is None else f"dd_{FS}"]
    assert np.abs(got - want).max() < 1e-12


@pytest.mark.parametrize("slots", SLOTS)
def test_sharded_fused_dd_per_bit_flip_scale(problem, slots):
    """A per-bit flip-scale vector of length L, slot bits included: the
    step keeps the slot-local bits and the coupled slot bits of it."""
    diag, psi_np, e_min, delta = problem
    scale_bits = np.random.default_rng(41).uniform(0.5, 1.5, size=L)
    step, dmb, psi, coeffs = _dd_inputs(problem, slots)
    got = step(dmb, psi, coeffs, flip_scale=scale_bits).numpy()
    want = _np_cheby_oracle(diag, G * scale_bits, L, psi_np, coeffs, delta,
                            e_min, DT)
    assert np.abs(got - want).max() < 1e-12
    with pytest.raises(ValueError, match="per-bit flip_scale"):
        step(dmb, psi, coeffs, flip_scale=scale_bits[:-1])


WIDE_L = 16  # 2^10 amplitudes a slot at 64 slots: the flip plan's least


@pytest.fixture(scope="module")
def wide_problem():
    """The chain at L = WIDE_L, its envelope, a state and per-bit flip
    scales, all from seeds."""
    H_diag, _ = transverse_field_ising(WIDE_L, J=J, g=G, h=H,
                                       dtype=jnp.float64)
    bound = J * (WIDE_L - 1) + abs(H) * WIDE_L + G * WIDE_L
    rng = np.random.default_rng(43)
    psi = rng.standard_normal(2 ** WIDE_L) + 1j * rng.standard_normal(
        2 ** WIDE_L)
    psi /= np.linalg.norm(psi)
    scale_bits = rng.uniform(0.5, 1.5, size=WIDE_L)
    return np.array(H_diag.diag, np.float64), psi, -bound, 2 * bound, \
        scale_bits


@pytest.mark.parametrize("slots", [32, 64])
@pytest.mark.parametrize("kind", ["f32", "dd", "dd f32 tail"])
@pytest.mark.parametrize("per_bit", [False, True])
def test_sharded_steps_on_wide_meshes(wide_problem, slots, kind, per_bit,
                                      monkeypatch):
    """Meshes of 32 and 64 slots on one rank: every flip call reads its
    5 or 6 slot bits as partners, so a partner weight ``G[L + r]`` with
    r >= 4 is read, and under a uniform or a per-bit flip scale the
    f32-tier step (float64 arrays) and the dd step, with and without
    its complex64 tail, match the f64 oracle to 1e-12."""
    diag, psi, e_min, delta, scale_bits = wide_problem
    mesh = chain_mesh(slots, device="cpu")
    kernels = _KernelCalls(monkeypatch)
    coeffs = cheby_coeffs(delta, DT)
    kw = dict(delta=delta, e_min=e_min, dt=DT)
    g_bits = G * (scale_bits if per_bit else np.ones(WIDE_L))
    if kind == "f32":
        step = sf.make_sharded_fused_cheby_step(mesh, WIDE_L, g_bits, **kw)
        r, i = step(torch.as_tensor(diag), torch.as_tensor(psi.real),
                    torch.as_tensor(psi.imag), coeffs, FS)
        got = r.numpy() + 1j * i.numpy()
        g_bits = FS * g_bits
    else:
        step = sf.make_sharded_fused_cheby_step_dd(
            mesh, WIDE_L, G, f32_tail=4 if kind == "dd f32 tail" else 0,
            **kw)
        got = step(torch.as_tensor(diag - (delta / 2 + e_min)),
                   torch.as_tensor(psi), coeffs,
                   flip_scale=scale_bits if per_bit else FS).numpy()
        if not per_bit:
            g_bits = FS * g_bits
    p = slots.bit_length() - 1
    assert kernels.calls and all(len(parts) == p
                                 for _, _, parts in kernels.calls)
    want = _np_cheby_oracle(diag, g_bits, WIDE_L, psi, coeffs, delta,
                            e_min, DT)
    assert np.abs(got - want).max() < 1e-12


class _RecordingMesh:
    """Wraps a mesh's ``ppermute`` to record the dtype of each exchange."""

    def __init__(self, mesh):
        self.seen = []
        inner = mesh.ppermute

        def ppermute(x, perm):
            self.seen.append(x.dtype)
            return inner(x, perm)

        mesh.ppermute = ppermute


class _KernelCalls:
    """Wraps the steps' flip calls (``cheby_flip_first`` and
    ``cheby_flip_iter`` as the dd and f32 drivers call them) to record,
    per call, the state whose flips it sums, its ``w`` and its
    partners."""

    def __init__(self, monkeypatch):
        self.calls = []
        for mod in (fc, fcd):
            for name in ("cheby_flip_first", "cheby_flip_iter"):
                fn = getattr(mod, name)
                sig = inspect.signature(fn)
                x_name = "v1" if name == "cheby_flip_iter" else "v0"

                def wrapped(*args, _fn=fn, _sig=sig, _x=x_name, **kw):
                    a = _sig.bind(*args, **kw).arguments
                    self.calls.append((a[_x], a.get("w"),
                                       list(a.get("partners", ()))))
                    return _fn(*args, **kw)

                monkeypatch.setattr(mod, name, wrapped)

    @property
    def partners(self):
        """``(dtype, slot_xor)`` of every partner of every call."""
        return [(st.dtype, xor) for _, _, parts in self.calls
                for st, xor in parts]

    def read_in_place(self) -> bool:
        """Every call took no ``w`` and read its slot bits from the
        state it sums itself (no copy)."""
        return all(w is None and all(st is x and xor for st, xor in parts)
                   for x, w, parts in self.calls)


@pytest.mark.parametrize("slots", SLOTS)
def test_sharded_fused_dd_f32_tail(problem, jax_ref, slots, monkeypatch):
    """A forced 4-order complex64 tail: its slot-bit partners are rows of
    the complex64 stack (the JAX step's hi-only planes), read in the
    kernels without an exchange on one rank; the result still matches
    the complex128 reference to 1e-12."""
    diag, psi_np, e_min, delta = problem
    mesh = chain_mesh(slots, device="cpu")
    rec = _RecordingMesh(mesh)
    kernels = _KernelCalls(monkeypatch)
    step = sf.make_sharded_fused_cheby_step_dd(
        mesh, L, G, delta=delta, e_min=e_min, dt=DT, f32_tail=4)
    coeffs = cheby_coeffs(delta, DT)
    assert len(coeffs) >= 8 and step.exchange_plan["f32_tail_orders"] == 4
    p = int(np.log2(slots))
    assert step.exchange_plan["bytes_per_elem_per_order_dd"] == 16 * p
    assert step.exchange_plan["bytes_per_elem_per_order_tail"] == 8 * p
    got = step(torch.as_tensor(diag - (delta / 2 + e_min)),
               torch.as_tensor(psi_np), coeffs).numpy()
    assert np.abs(got - jax_ref["dd"]).max() < 1e-12
    n_orders = len(coeffs)
    assert rec.seen == []
    assert kernels.read_in_place()
    seen = kernels.partners
    assert seen.count((torch.complex64, 1)) == 4 * (p > 0)
    assert [d for d, _ in seen].count(torch.complex64) == 4 * p
    assert [d for d, _ in seen].count(torch.complex128) == (
        n_orders - 4 - 1) * p


def test_weak_site_device_bits_skip_exchange(monkeypatch):
    """Slot bits assigned to zero-coupling sites emit no exchange, and
    the step still matches the f64 oracle in the original bit order."""
    Lb = 13
    rng = np.random.default_rng(31)
    g_bits = rng.uniform(0.8, 1.5, size=Lb)
    g_bits[[4, 9, 11]] = 0.0
    diag64 = rng.normal(size=1 << Lb)
    bound = float(np.abs(diag64).max() + np.abs(g_bits).sum())
    e_min, delta = -bound, 2 * bound

    bit_order, g_perm = sf.weak_site_permutation(Lb, g_bits, 8)
    j_order, j_perm = jax_sf.weak_site_permutation(Lb, g_bits, 8)
    assert bit_order == j_order and np.array_equal(g_perm, j_perm)
    assert set(bit_order[-3:]) == {4, 9, 11}

    mesh = chain_mesh(8, device="cpu")
    rec = _RecordingMesh(mesh)
    kernels = _KernelCalls(monkeypatch)
    step = sf.make_sharded_fused_cheby_step_dd(
        mesh, Lb, g_perm, delta=delta, e_min=e_min, dt=DT)
    assert step.exchange_plan["device_bits"] == 3
    assert step.exchange_plan["skipped_zero_coupling_bits"] == 3
    assert step.exchange_plan["bytes_per_elem_per_order_dd"] == 0

    psi = rng.standard_normal(1 << Lb) + 1j * rng.standard_normal(1 << Lb)
    psi /= np.linalg.norm(psi)
    psi_p = sf.permute_index_bits(torch.as_tensor(psi), bit_order)
    assert np.array_equal(
        psi_p.numpy(),
        np.asarray(jax_sf.permute_index_bits(jnp.asarray(psi), bit_order)))
    diag_p = sf.permute_index_bits(torch.as_tensor(diag64), bit_order)
    coeffs = cheby_coeffs(delta, DT)
    out = step(diag_p - (delta / 2 + e_min), psi_p, coeffs)
    assert rec.seen == [] and kernels.calls
    assert kernels.partners == []
    inv = sf.invert_bit_order(bit_order)
    assert inv == jax_sf.invert_bit_order(bit_order)
    z = sf.permute_index_bits(out, inv).numpy()
    want = _np_cheby_oracle(diag64, g_bits, Lb, psi, coeffs, delta, e_min,
                            DT)
    assert np.abs(z - want).max() < 1e-12


def test_sharded_fused_step_skips_zero_coupling_bits(monkeypatch):
    """The f32-tier step (float64 arrays) with one coupled and two
    zero-coupling slot bits: one partner per product, the coupled bit's
    rows of the state itself (no exchange on one rank), and the result
    matches the f64 oracle under a flip scale."""
    Lb = 13
    rng = np.random.default_rng(33)
    g_bits = rng.uniform(0.8, 1.5, size=Lb)
    g_bits[[10, 12]] = 0.0
    diag64 = rng.normal(size=1 << Lb)
    bound = float(np.abs(diag64).max() + np.abs(g_bits).sum())
    e_min, delta = -bound, 2 * bound
    psi = rng.standard_normal(1 << Lb) + 1j * rng.standard_normal(1 << Lb)
    psi /= np.linalg.norm(psi)

    mesh = chain_mesh(8, device="cpu")
    rec = _RecordingMesh(mesh)
    kernels = _KernelCalls(monkeypatch)
    step = sf.make_sharded_fused_cheby_step(
        mesh, Lb, g_bits, delta=delta, e_min=e_min, dt=DT, tile_rows=8)
    coeffs = cheby_coeffs(delta, DT)
    r, i = step(torch.as_tensor(diag64), torch.as_tensor(psi.real),
                torch.as_tensor(psi.imag), coeffs, FS)
    assert rec.seen == []
    # slot bits 10, 11, 12 of the index: only bit 11 (slot bit 1) couples
    assert kernels.partners == [(torch.complex128, 2)] * (len(coeffs) - 1)
    assert kernels.read_in_place()
    want = _np_cheby_oracle(diag64, FS * g_bits, Lb, psi, coeffs, delta,
                            e_min, DT)
    assert np.abs(r.numpy() + 1j * i.numpy() - want).max() < 1e-12


@pytest.mark.parametrize("slots", SLOTS)
def test_sharded_fused_backward_roundtrip(problem, slots):
    diag, psi_np, e_min, delta = problem
    mesh = chain_mesh(slots, device="cpu")
    kw = dict(delta=delta, e_min=e_min, tile_rows=8)
    fwd = sf.make_sharded_fused_cheby_step(mesh, L, G, dt=DT, **kw)
    bwd = sf.make_sharded_fused_cheby_step(mesh, L, G, dt=-DT, forward=False,
                                           **kw)
    d = torch.as_tensor(diag)
    re, im = fwd(d, torch.as_tensor(psi_np.real), torch.as_tensor(psi_np.imag),
                 cheby_coeffs(delta, DT))
    re, im = bwd(d, re, im, cheby_coeffs(delta, -DT))
    assert np.linalg.norm(re.numpy() + 1j * im.numpy() - psi_np) < 1e-12


@pytest.mark.parametrize("cdtype, tol", [(torch.complex64, 1e-6),
                                         (torch.complex128, 1e-15)])
def test_flip_wrappers_take_slot_stacks(cdtype, tol):
    """A ``(slots, 2^L)`` stack through the flip wrappers equals each
    slot alone (the sharded steps' per-slot calls)."""
    rdtype = cdtype.to_real()
    rng = np.random.default_rng(5)
    Lb, S = 6, 4

    def vec():
        return torch.as_tensor(rng.standard_normal((S, 1 << Lb))
                               + 1j * rng.standard_normal((S, 1 << Lb))
                               ).to(cdtype)

    v0, v1, phi, w = vec(), vec(), vec(), vec()
    dmb = torch.as_tensor(rng.standard_normal((S, 1 << Lb))).to(rdtype)
    Gv = torch.as_tensor(rng.uniform(0.5, 1.5, Lb)).to(rdtype)
    got_v1, got_phi = cf.cheby_flip_first(v0, dmb, Gv, -0.1, 0.8, 0.3, w)
    got_it = cf.cheby_flip_iter(v0.clone(), v1, phi.clone(), dmb, Gv, -0.2,
                                0.4, w)
    got_hi = cf.cheby_flip_high(v1, Gv, 2, w)
    for s in range(S):
        a, b = cf.cheby_flip_first(v0[s], dmb[s], Gv, -0.1, 0.8, 0.3, w[s])
        it = cf.cheby_flip_iter(v0[s].clone(), v1[s], phi[s].clone(), dmb[s],
                                Gv, -0.2, 0.4, w[s])
        hi = cf.cheby_flip_high(v1[s], Gv, 2, w[s])
        for x, y in ((got_v1[s], a), (got_phi[s], b), (got_it[s], it),
                     (got_hi[s], hi)):
            assert float((x - y).abs().max()) <= tol


def _stack_copy(stack, slot_xor, slots):
    """The copied rows the partners replace: row ``s ^ slot_xor``."""
    return torch.stack([stack[s ^ slot_xor] for s in range(slots)])


@pytest.mark.parametrize("cdtype, tol", [(torch.complex64, 1e-6),
                                         (torch.complex128, 1e-14)])
@pytest.mark.parametrize("h", [0, 2])
@pytest.mark.parametrize("kinds", [("own 1",), ("own 2",), ("received",),
                                   ("own 2", "received"),
                                   ("own 1", "received", "own 2", "received",
                                    "own 2", "own 1")])
def test_flip_wrappers_read_partners(cdtype, tol, h, kinds):
    """Partners ``(stack, slot_xor)`` through every flip wrapper (P = 1,
    2 and 6; the state's own stack with ``slot_xor = 2^r`` and received
    rows with ``slot_xor = 0``, mixed) equal the same call without
    partners whose ``w`` is the explicit stacked copies' weighted sum
    plus ``w``."""
    rdtype = cdtype.to_real()
    rng = np.random.default_rng(7)
    Lb, S = 6, 4

    def vec():
        return torch.as_tensor(rng.standard_normal((S, 1 << Lb))
                               + 1j * rng.standard_normal((S, 1 << Lb))
                               ).to(cdtype)

    v0, v1, phi, w, received = vec(), vec(), vec(), vec(), vec()
    dmb = torch.as_tensor(rng.standard_normal((S, 1 << Lb))).to(rdtype)
    G_all = torch.as_tensor(rng.uniform(0.5, 1.5, Lb + len(kinds))
                            ).to(rdtype)
    G = G_all[:Lb].contiguous()

    def partners(x):
        """``own k``: the state's own stack with ``slot_xor = k``."""
        return [(received, 0) if kind == "received"
                else (x, int(kind.split()[1])) for kind in kinds]

    def w_ref(x, with_w=True):
        out = w.clone() if with_w else torch.zeros_like(w)
        acc = torch.zeros_like(w)
        for r, (st, xor) in enumerate(partners(x)):
            acc = acc + G_all[Lb + r] * _stack_copy(st, xor, S)
        return acc + out

    got = cf.cheby_flip_high(v1, G_all, h, w, partners=partners(v1))
    want = cf.cheby_flip_high(v1, G, h, w_ref(v1))
    assert float((got - want).abs().max()) <= tol
    got = cf.cheby_flip_high(v1, G_all, h, partners=partners(v1))
    want = cf.cheby_flip_high(v1, G, h, w_ref(v1, with_w=False))
    assert float((got - want).abs().max()) <= tol
    pairs = [
        (cf.cheby_flip_first(v0, dmb, G_all, -0.1, 0.8, 0.3, w,
                             partners=partners(v0)),
         cf.cheby_flip_first(v0, dmb, G, -0.1, 0.8, 0.3, w_ref(v0))),
        (cf.cheby_flip_first_low(v0, dmb, G_all, -0.1, 0.8, 0.3, Lb - h, w,
                                 partners=partners(v0)),
         cf.cheby_flip_first_low(v0, dmb, G, -0.1, 0.8, 0.3, Lb - h,
                                 w_ref(v0))),
        ((cf.cheby_flip_iter(v0.clone(), v1, phi.clone(), dmb, G_all, -0.2,
                             0.4, w, partners=partners(v1)),),
         (cf.cheby_flip_iter(v0.clone(), v1, phi.clone(), dmb, G, -0.2, 0.4,
                             w_ref(v1)),)),
        ((cf.cheby_flip_iter_low(v0.clone(), v1, phi.clone(), dmb, G_all,
                                 -0.2, 0.4, Lb - h, w,
                                 partners=partners(v1)),),
         (cf.cheby_flip_iter_low(v0.clone(), v1, phi.clone(), dmb, G, -0.2,
                                 0.4, Lb - h, w_ref(v1)),)),
    ]
    for got, want in pairs:
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= tol


def test_flip_partners_refused():
    """More partners than the kernel takes, or a partner whose dtype,
    shape or slot map does not fit the state, raise (no fallback)."""
    Lb, S = 5, 4
    v = torch.zeros((S, 1 << Lb), dtype=torch.complex128)
    G = torch.ones(Lb + cf.MAX_PARTNERS + 1, dtype=torch.float64)
    many = [(v, 1)] * (cf.MAX_PARTNERS + 1)
    with pytest.raises(ValueError, match="at most"):
        cf.cheby_flip_high(v, G, 2, partners=many)
    G1 = G[:Lb + 1].contiguous()
    for bad, match in (((v.to(torch.complex64), 1), "must be"),
                       ((v[:2], 1), "stack of"),
                       ((v, 4), "leaves")):
        with pytest.raises(ValueError, match=match):
            cf.cheby_flip_high(v, G1, 2, partners=[bad])
    with pytest.raises(ValueError, match="shape"):
        cf.cheby_flip_high(v, G[:Lb].contiguous(), 2, partners=[(v, 1)])


def test_one_rank_sharded_steps_make_no_exchange(problem, monkeypatch):
    """On one rank the 4-slot dd and f32 steps call ``Mesh.ppermute`` no
    time and build no ``w``: each flip call reads its two slot bits as
    partners, rows of the very stack it sums (``slot_xor`` 1 and 2)."""
    diag, psi, e_min, delta = problem
    calls = []
    inner = Mesh.ppermute

    def counted(self, x, perm):
        calls.append(x.dtype)
        return inner(self, x, perm)

    monkeypatch.setattr(Mesh, "ppermute", counted)
    kernels = _KernelCalls(monkeypatch)
    step, dmb, st, coeffs = _dd_inputs(problem, 4, f32_tail=4)
    step(dmb, st, coeffs, flip_scale=FS)
    step32 = sf.make_sharded_fused_cheby_step(
        chain_mesh(4, device="cpu"), L, G, delta=delta, e_min=e_min, dt=DT)
    step32(torch.as_tensor(diag).to(torch.float32),
           torch.as_tensor(psi.real).to(torch.float32),
           torch.as_tensor(psi.imag).to(torch.float32), coeffs, 0.65)
    assert calls == []
    n = len(coeffs)
    # dd: the setup and n - 6 complex128 orders, 4 complex64 tail
    # orders; f32: the setup and n - 2 orders
    assert len(kernels.calls) == 2 * (n - 1) and kernels.read_in_place()
    assert Counter(kernels.partners) == {
        (torch.complex128, 1): n - 5, (torch.complex128, 2): n - 5,
        (torch.complex64, 1): n + 3, (torch.complex64, 2): n + 3}
