"""Port vs JAX package: the fused flip-Hamiltonian Chebyshev step in both
tiers and its whole-grid path (mirrors ``test_fused_cheby.py`` and
``test_fused_cheby_dd.py``).

The port's plain versions of the CUDA kernels run here on CPU tensors;
the JAX Pallas kernels run in interpret mode, as the JAX package's own
tests run them.  Every envelope is generic (β = Δ/2 + E_min ≠ 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.fused import cheby_propagate_fused as jax_fused
from quantumpropagators.ops.cheby import cheby_coeffs
from quantumpropagators.ops.fused_cheby import (
    cheby_step_fused as jax_step,
    flip_structure as jax_flip_structure,
    flip_structure_multi as jax_flip_structure_multi,
    make_flip_plan as jax_plan,
)
from quantumpropagators.ops.fused_cheby_dd import cheby_step_fused_dd as jax_dd
from quantumpropagators_torch.fused import cheby_propagate_fused
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch.ops import cheby_flip as cf
from quantumpropagators_torch.ops.fused_cheby import (
    cheby_step_fused,
    flip_structure,
    flip_structure_multi,
    make_flip_plan,
)
from quantumpropagators_torch.ops.fused_cheby_dd import (
    cheby_step_fused_dd,
    dd_tile_rows,
    f32_tail_orders,
)
from quantumpropagators_torch import set_default_device

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")

J, G, H = 1.0, 1.2, 0.3


def dd_split(x64):
    x64 = np.asarray(x64, dtype=np.float64)
    hi = x64.astype(np.float32)
    return jnp.asarray(hi), jnp.asarray((x64 - hi.astype(np.float64))
                                        .astype(np.float32))


def dd_merge(out):
    o = [np.asarray(p, dtype=np.float64) for p in out]
    return o[0] + o[1] + 1j * (o[2] + o[3])


def problem(L, seed):
    """TFIM chain at L with a generic envelope (β ≠ 0)."""
    Hd, Hx = qp.transverse_field_ising(L, J=J, g=G, h=H, dtype=jnp.float64)
    bound = J * (L - 1) + H * L + G * L
    e_min, delta = -1.05 * bound - 0.4, 2.1 * bound + 0.8
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi /= np.linalg.norm(psi)
    return np.array(Hd.diag, dtype=np.float64), psi, e_min, delta


def fields(plan):
    return (plan.L, plan.tile_rows, plan.n_row_bits, plan.n_cross, plan.gs)


def test_plan_matches_jax():
    for L, g, tr in ((16, 1.5, 64), (12, np.arange(1, 13.0), 8), (11, 1.2, 16)):
        assert fields(make_flip_plan(L, g, tile_rows=tr)) == \
            fields(jax_plan(L, g, tile_rows=tr))
    plan = make_flip_plan(16, 1.5, tile_rows=64)
    np.testing.assert_array_equal(plan.lane_mat,
                                  jax_plan(16, 1.5, tile_rows=64).lane_mat)
    assert plan.cross_mat.shape == (8, 8)
    with pytest.raises(ValueError, match="L >="):
        make_flip_plan(8, 1.0)
    assert dd_tile_rows(20) == 1024 and dd_tile_rows(10) == 8


def test_structure_detection_matches_jax():
    L = 10
    Hd, Hx = qp.transverse_field_ising(L, J=J, g=G, h=H, dtype=jnp.float64)
    ops = [Hd, Hx]
    jplan, jdiag, jdp, jfp = jax_flip_structure(ops)
    plan, diag, dp, fp = flip_structure(from_jax(ops))
    assert fields(plan) == fields(jplan) and (dp, fp) == (jdp, jfp)
    np.testing.assert_array_equal(diag.numpy(), np.asarray(jdiag))
    mats = np.zeros((L, 2, 2))
    mats[:, 0, 1] = mats[:, 1, 0] = np.linspace(0.5, 1.5, L)
    Hx2 = qp.SiteOperatorSum(jnp.asarray(mats), L=L,
                             active=tuple(i % 2 == 0 for i in range(L)))
    jm = jax_flip_structure_multi([Hd, Hx, Hx2])
    m = flip_structure_multi(from_jax([Hd, Hx, Hx2]))
    assert m[0] == jm[0]
    for (p, d), (jp, jd) in zip(m[1], jm[1]):
        assert p == jp
        np.testing.assert_array_equal(d.numpy(), jd)
    for (p, g), (jp, jg) in zip(m[2], jm[2]):
        assert p == jp
        np.testing.assert_array_equal(g, jg)
    # not flip structure: Y-type sites, dense terms, too short chains
    ymats = np.tile(np.array([[0, -1j], [1j, 0]]), (L, 1, 1))
    Hy = qt.SiteOperatorSum(torch.as_tensor(ymats), L=L)
    assert flip_structure([from_jax(Hd), Hy]) is None
    assert flip_structure_multi([from_jax(Hd), torch.eye(2 ** L)]) is None
    Hd8, Hx8 = qt.transverse_field_ising(8, dtype=torch.complex128)
    assert flip_structure([Hd8, Hx8]) is None


@pytest.mark.parametrize("tile_rows, scale", [(8, None), (16, 0.8)])
def test_f32_step_vs_jax_pallas(tile_rows, scale):
    """complex64 tier (plain version of the float kernels) vs the JAX
    f32 Pallas kernel, one step at L = 11: 1e-6."""
    L = 11
    diag, psi, e_min, delta = problem(L, 7)
    dt = 0.05
    c = cheby_coeffs(delta, dt)
    re32, im32 = psi.real.astype(np.float32), psi.imag.astype(np.float32)
    jre, jim = jax_step(
        jax_plan(L, G, tile_rows=tile_rows), jnp.asarray(diag, jnp.float32),
        jnp.asarray(re32), jnp.asarray(im32), jnp.asarray(c, jnp.float32),
        delta, e_min, dt, flip_scale=scale, interpret=True,
    )
    re, im = cheby_step_fused(
        make_flip_plan(L, G), torch.as_tensor(diag, dtype=torch.float32),
        torch.as_tensor(re32), torch.as_tensor(im32), c, delta, e_min, dt,
        flip_scale=scale,
    )
    assert re.dtype == torch.float32
    got = re.numpy() + 1j * im.numpy()
    want = np.asarray(jre) + 1j * np.asarray(jim)
    assert np.abs(got - want).max() < 1e-6
    assert abs(np.linalg.norm(got) - 1.0) < 1e-5


def test_extra_w_fn_supplies_missing_bit():
    """``extra_w_fn`` adds flips computed outside the kernel: a plan
    without bit 9 plus a hook that flips bit 9 equals the full plan, and
    the hook's contribution is scaled by ``flip_scale`` like the flips."""
    L = 10
    diag, psi, e_min, delta = problem(L, 8)
    c = cheby_coeffs(delta, 0.05)
    args = (torch.as_tensor(diag), torch.as_tensor(psi.real),
            torch.as_tensor(psi.imag), c, delta, e_min, 0.05)

    def flip_top(vr, vi):
        return (G * vr.view(2, -1).flip(0).reshape(-1),
                G * vi.view(2, -1).flip(0).reshape(-1))

    full = cheby_step_fused(make_flip_plan(L, G), *args, flip_scale=0.7)
    part = cheby_step_fused(make_flip_plan(L, [G] * 9 + [0.0]), *args,
                            flip_scale=0.7, extra_w_fn=flip_top)
    for a, b in zip(full, part):
        assert float((a - b).abs().max()) < 1e-14


def _dd_both(L, seed, dt, *, forward=True, fs=None, tail=0, psi=None):
    """One dd step through the JAX kernel (interpret) and the port's
    complex128 twin on the same inputs."""
    diag, psi0, e_min, delta = problem(L, seed)
    psi = psi0 if psi is None else psi
    c = cheby_coeffs(delta, dt)
    dmb = diag - (delta / 2 + e_min)
    state = (*dd_split(psi.real), *dd_split(psi.imag))
    want = dd_merge(jax_dd(
        jax_plan(L, G, tile_rows=8), *dd_split(dmb), state, *dd_split(c),
        delta, e_min, dt, forward=forward, interpret=True,
        flip_scale=None if fs is None else dd_split(fs), f32_tail=tail,
    ))
    got = cheby_step_fused_dd(
        make_flip_plan(L, G), torch.as_tensor(dmb), torch.as_tensor(psi), c,
        delta, e_min, dt, forward=forward, flip_scale=fs, f32_tail=tail,
    ).numpy()
    return got, want, psi0


def test_dd_step_vs_jax_generic_envelope():
    got, want, _ = _dd_both(11, 3, 0.1)
    assert np.abs(got - want).max() < 1e-13
    assert abs(np.linalg.norm(got) - 1.0) < 1e-13


def test_dd_step_vs_jax_per_bit_flip_scale():
    fs = np.random.default_rng(41).uniform(0.8, 1.2, size=10)
    got, want, _ = _dd_both(10, 5, 0.08, fs=fs)
    assert np.abs(got - want).max() < 1e-13


def _port_step(L, seed, dt):
    diag, psi, e_min, delta = problem(L, seed)
    out = cheby_step_fused_dd(
        make_flip_plan(L, G), torch.as_tensor(diag - (delta / 2 + e_min)),
        torch.as_tensor(psi), cheby_coeffs(delta, dt), delta, e_min, dt,
    )
    return out.numpy()


def test_dd_step_vs_jax_f32_tail():
    _diag, _psi, _e_min, delta = problem(10, 6)
    c = cheby_coeffs(delta, 0.04)
    tail = f32_tail_orders(c, per_step_budget=1e-12)
    assert 0 < tail <= len(c) - 3
    got, want, _ = _dd_both(10, 6, 0.04, tail=tail)
    assert np.abs(got - want).max() < 1e-12
    assert np.abs(got - _port_step(10, 6, 0.04)).max() < 1e-12


def test_dd_backward_round_trip_vs_jax():
    fwd = _port_step(10, 9, 0.09)
    back, want, psi0 = _dd_both(10, 9, -0.09, forward=False, psi=fwd)
    assert np.abs(back - want).max() < 1e-13
    assert np.abs(back - psi0).max() < 1e-12


def test_dd_gates_and_hooks():
    """The tail is capped at n_orders − 3, dropped when the extra-bit
    hook comes without its complex64 companion, and the extra-bit hook
    adds flips of bits outside the state."""
    diag, psi, e_min, delta = problem(10, 12)
    dmb = torch.as_tensor(diag - (delta / 2 + e_min))
    c = cheby_coeffs(delta, 0.05)
    plan = make_flip_plan(10, G)
    st = torch.as_tensor(psi)
    base = cheby_step_fused_dd(plan, dmb, st, c, delta, e_min, 0.05)
    cf.reset_launches()
    capped = cheby_step_fused_dd(plan, dmb, st, c, delta, e_min, 0.05,
                                 f32_tail=10 ** 6)
    assert np.abs(capped.numpy() - base.numpy()).max() < 1e-9
    # a zero-coefficient extra bit changes nothing, and disables the tail
    calls = []

    def hook(v):
        calls.append(v.dtype)
        return [v.flip(0)]

    hooked = cheby_step_fused_dd(plan, dmb, st, c, delta, e_min, 0.05,
                                 f32_tail=5, extra_nb_fn=hook,
                                 extra_gs=(0.0,))
    assert set(calls) == {torch.complex128}
    assert np.abs(hooked.numpy() - base.numpy()).max() < 1e-15
    with pytest.raises(ValueError, match="per-bit flip_scale"):
        cheby_step_fused_dd(plan, dmb, st, c, delta, e_min, 0.05,
                            flip_scale=np.ones(3))
    with pytest.raises(ValueError, match="unknown dd variant"):
        cheby_step_fused_dd(plan, dmb, st, c, delta, e_min, 0.05, fast="x")
    for v in ("lomxu", "xcross", "tlane", "mxq", "rows", "sigma", True, False):
        out = cheby_step_fused_dd(plan, dmb, st, c, delta, e_min, 0.05,
                                  fast=v)
        assert torch.equal(out, base)


@pytest.fixture(scope="module")
def driven_f32():
    L = 11
    Hd, Hx = qp.transverse_field_ising(L, J=J, g=1.0, h=H, dtype=jnp.float32)
    gen = qp.hamiltonian(Hd, (Hx, lambda t: 0.8 + 0.4 * np.sin(t)),
                         check=False)
    tlist = np.linspace(0, 1.0, 11)
    rng = np.random.default_rng(11)
    psi = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi /= np.linalg.norm(psi)
    bound = J * (L - 1) + H * L + 1.2 * L
    kw = dict(specrange_method="manual", E_min=-bound - 0.7, E_max=bound)
    return gen, tlist, psi.astype(np.complex64), kw


def test_pallas_path_vs_jax_xla(driven_f32):
    gen, tlist, psi, kw = driven_f32
    ref, _ = jax_fused(jnp.asarray(psi), gen, tlist, kernel="xla", **kw)
    out, nrm = cheby_propagate_fused(
        torch.as_tensor(psi), from_jax(gen), tlist, kernel="pallas",
        observable_fn=lambda p: torch.linalg.vector_norm(p), **kw,
    )
    assert out.dtype == torch.complex64
    assert np.abs(out.numpy() - np.asarray(ref)).max() < 1e-5
    assert nrm.shape == (len(tlist) - 1,)
    np.testing.assert_allclose(nrm.numpy(), 1.0, atol=1e-5)
    # on CPU tensors "auto" is the generic path, and agrees
    auto, traj = cheby_propagate_fused(torch.as_tensor(psi), from_jax(gen),
                                       tlist, kernel="auto",
                                       store_states=True, **kw)
    assert traj.shape == (len(tlist) - 1, 2 ** 11)
    assert np.abs(auto.numpy() - np.asarray(ref)).max() < 1e-5


def test_dd_without_flip_structure_raises():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((16, 16))
    Hm = torch.as_tensor(A + A.T)
    psi0 = torch.as_tensor(rng.standard_normal(16) + 0j)
    tlist = np.linspace(0, 1, 5)
    # a static operator without flip structure takes the banded route;
    # a time-dependent one still needs flip structure
    out, _ = cheby_propagate_fused(psi0, Hm, tlist, kernel="dd")
    U = scipy.linalg.expm(-1j * (tlist[-1] - tlist[0]) * (A + A.T))
    assert np.abs(out.numpy() - U @ psi0.numpy()).max() < 1e-11
    gen = qt.hamiltonian(Hm, (Hm, lambda t: np.sin(t)))
    with pytest.raises(ValueError, match="diagonal-plus-site-flip"):
        cheby_propagate_fused(psi0, gen, tlist, kernel="dd")
    with pytest.raises(ValueError, match="site-flip"):
        cheby_propagate_fused(psi0, Hm, tlist, kernel="pallas")
    with pytest.raises(ValueError, match="unknown kernel"):
        cheby_propagate_fused(psi0, Hm, tlist, kernel="cuda")


def test_propagate_fused_dd_storage_and_guard():
    """``propagate(fused=True, kernel="dd")`` with observables and with
    stored states, forward and backward; the memory-cliff guard."""
    L = 10
    diag, psi, e_min, delta = problem(L, 2)
    Hd, Hx = qt.transverse_field_ising(L, J=J, g=G, h=H,
                                       dtype=torch.complex128)
    gen = qt.hamiltonian(Hd, (Hx, lambda t: qt.flattop(t, T=0.5,
                                                       t_rise=0.2)))
    tlist = np.linspace(0, 0.5, 11)
    kw = dict(specrange_method="manual", E_min=e_min,
              E_max=e_min + delta)
    psi0 = torch.as_tensor(psi)
    sz = qt.DiagonalOperator(torch.as_tensor(
        1.0 - 2.0 * ((np.arange(2 ** L) >> (L - 1)) & 1)))
    data = qt.propagate(psi0, gen, tlist, fused=True, kernel="dd",
                        observables=(sz,), storage=True, **kw)
    step = qt.propagate(psi0, gen, tlist, method="cheby",
                        observables=(sz,), storage=True, **kw)
    assert data.shape == (len(tlist),)
    assert np.abs(data - step).max() < 1e-12
    states = qt.propagate(psi0, gen, tlist, fused=True, kernel="dd",
                          storage=True, **kw)
    assert states.shape == (2 ** L, len(tlist))
    back = qt.propagate(torch.as_tensor(states[:, -1]), gen, tlist,
                        fused=True, kernel="dd", backward=True,
                        storage=True, **kw)
    assert np.abs(back - states).max() < 1e-12
    with pytest.raises(ValueError, match="GiB"):
        qt.propagate(psi0, gen, tlist, fused=True, kernel="dd",
                     storage=True, max_storage_bytes=1024, **kw)
    with pytest.raises(ValueError, match="callbacks"):
        qt.propagate(psi0, gen, tlist, fused=True,
                     callback=lambda *a: None, **kw)
