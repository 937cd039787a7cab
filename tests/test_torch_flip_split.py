"""The two passes of the flip setup and iteration on the card — the high
pass (flips of the top h bits into ``w_hi``) and the tiled pass (the
setup or the order over the bits below) — composed through their plain
versions, against the one-pass plain setup and order and the JAX
package's operators.

Every split point h in [0, L] at small L, with and without the caller's
``w``, with a generic envelope (β ≠ 0 in ``dmb``).  Composition changes
only the order of the sums: 1e-14 in complex128 and 1e-6 in complex64
(unit-norm states)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumpropagators as qp
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.ops import cheby_flip as cf

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")

TOLS = {torch.complex64: 1e-6, torch.complex128: 1e-14}
SPLITS = [(L, h) for L in (1, 2, 5, 9, 12) for h in range(L + 1)]


def _inputs(L, cdtype, seed=7):
    rdtype = torch.float32 if cdtype == torch.complex64 else torch.float64
    rng = np.random.default_rng(seed + L)

    def vec():
        v = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
        return torch.as_tensor(v / np.linalg.norm(v)).to(cdtype)

    beta = 0.37 * L + 0.2
    dmb = torch.as_tensor(rng.standard_normal(2 ** L) - beta).to(rdtype)
    G = torch.as_tensor(rng.uniform(0.5, 1.5, L)).to(rdtype)
    return vec(), vec(), vec(), vec(), dmb, G


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("L, h", SPLITS)
@pytest.mark.parametrize("with_w", [False, True])
def test_passes_compose_to_the_order(cdtype, L, h, with_w):
    v0, v1, phi, w, dmb, G = _inputs(L, cdtype)
    w = w if with_w else None
    p0, pphi = v0.clone(), phi.clone()
    cf.cheby_flip_iter_plain(p0, v1, pphi, dmb, G, -0.14, 0.3, w)
    # in place on even h, into a separate buffer on odd h
    k0, kphi = v0.clone(), phi.clone()
    out = torch.empty_like(v0) if h % 2 else None
    w_hi = cf.cheby_flip_high_plain(v1, G, h, w)
    res = cf.cheby_flip_iter_low_plain(k0, v1, kphi, dmb, G, -0.14, 0.3,
                                       L - h, w_hi, out=out)
    got = res if h % 2 else k0
    assert res is (out if h % 2 else k0)
    tol = TOLS[cdtype]
    assert float((got - p0).abs().max()) < tol
    assert float((kphi - pphi).abs().max()) < tol
    if h % 2:
        assert torch.equal(k0, v0)


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("L, h", SPLITS)
@pytest.mark.parametrize("with_w", [False, True])
def test_setup_passes_compose_to_the_setup(cdtype, L, h, with_w):
    v0, _, _, w, dmb, G = _inputs(L, cdtype)
    w = w if with_w else None
    want = cf.cheby_flip_first_plain(v0, dmb, G, -0.07, 0.8, -0.4, w)
    w_hi = cf.cheby_flip_high_plain(v0, G, h, w)
    got = cf.cheby_flip_first_low_plain(v0, dmb, G, -0.07, 0.8, -0.4, L - h,
                                        w_hi)
    tol = TOLS[cdtype]
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) < tol


def _jax_tfim(L, g, v):
    """The JAX package's TFIM chain (uniform transverse field: every bit
    has ``G_j = g``): its diagonal and ``H·v``."""
    Hd, Hx = qp.transverse_field_ising(L, J=1.0, g=g, h=0.3,
                                       dtype=jnp.complex128)
    hv = np.asarray(qp.apply(Hd, jnp.asarray(v))) \
        + np.asarray(qp.apply(Hx, jnp.asarray(v)))
    return np.asarray(Hd.diag).real, hv


JAX_SPLITS = [(5, 2), (9, 0), (9, 4), (9, 9)]


@pytest.mark.parametrize("L, h", JAX_SPLITS)
def test_split_order_matches_jax_operators(L, h):
    """One order through the two passes equals
    ``v0 + i·s2·(H − β)v1`` with ``H`` applied by the JAX package's TFIM
    operators."""
    g, beta, s2 = 1.2, 0.9, -0.21
    rng = np.random.default_rng(L + h)
    v0, v1 = (rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
              for _ in range(2))
    diag, hv1 = _jax_tfim(L, g, v1)
    want = v0 + 1j * s2 * (hv1 - beta * v1)
    dmb = torch.as_tensor(diag - beta)
    G = torch.full((L,), g, dtype=torch.float64)
    t0, t1 = torch.as_tensor(v0), torch.as_tensor(v1)
    phi = torch.zeros_like(t0)
    w_hi = cf.cheby_flip_high(t1, G, h)  # CPU tensors: the plain version
    cf.cheby_flip_iter_low(t0, t1, phi, dmb, G, s2, 0.5, L - h, w_hi)
    np.testing.assert_allclose(t0.numpy(), want, rtol=0, atol=1e-13)
    np.testing.assert_allclose(phi.numpy(), 0.5 * want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("L, h", JAX_SPLITS)
def test_split_setup_matches_jax_operators(L, h):
    """The setup through the two passes equals ``v1 = i·s·(H − β)v0``
    and ``Φ = a0·v0 + a1·v1`` with ``H`` applied by the JAX package's
    TFIM operators."""
    g, beta, s, a0, a1 = 1.2, 0.9, -0.105, 0.8, -0.4
    rng = np.random.default_rng(L + h + 1)
    v0 = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    diag, hv0 = _jax_tfim(L, g, v0)
    want_v1 = 1j * s * (hv0 - beta * v0)
    dmb = torch.as_tensor(diag - beta)
    G = torch.full((L,), g, dtype=torch.float64)
    t0 = torch.as_tensor(v0)
    w_hi = cf.cheby_flip_high(t0, G, h)  # CPU tensors: the plain version
    v1, phi = cf.cheby_flip_first_low(t0, dmb, G, s, a0, a1, L - h, w_hi)
    np.testing.assert_allclose(v1.numpy(), want_v1, rtol=0, atol=1e-13)
    np.testing.assert_allclose(phi.numpy(), a0 * v0 + a1 * want_v1, rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("setup", [False, True])
def test_flip_split_invariants(cdtype, setup):
    elem = cdtype.itemsize
    for L in range(1, cf.MAX_BITS + 1):
        tile_bits, h = cf.flip_split(L, cdtype, setup)
        assert h == cf.flip_split(L, cdtype)[1]  # one split for both
        assert 0 <= h <= cf._MAX_HIGH_BITS and tile_bits <= L
        assert 16 <= elem << tile_bits <= cf._SMEM_BYTES
        if L <= tile_bits:
            assert h == 0  # the tile is the whole vector: no high pass
        if h:
            assert tile_bits <= L - h  # the passes share no bit
            line_bits = cf._line_bits(L, h, cdtype)
            assert line_bits + h <= L
            assert elem << (line_bits + h) <= cf._SMEM_BYTES
    # the main path's size runs the high pass in both tiers
    assert cf.flip_split(24, cdtype)[1] > 0


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
def test_flip_check_sizes_cover_tile_and_split(cdtype):
    sizes = cf.flip_check_sizes(cdtype)
    assert sizes == sorted(set(sizes))
    assert 1 <= sizes[0] and sizes[-1] <= cf.MAX_BITS
    for setup in (False, True):
        T = cf.flip_split(cf.MAX_BITS, cdtype, setup)[0]
        assert {1, 2, 4, T - 1, T, T + 1, 16, 20} <= set(sizes)
    h = {L: cf.flip_split(L, cdtype)[1] for L in range(1, cf.MAX_BITS + 1)}
    # the first L with a high pass, and the first with the most high bits
    assert any(h[L] and not h[L - 1] for L in sizes)
    assert any(h[L] == cf._MAX_HIGH_BITS > h[L - 1] for L in sizes)


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
def test_cpu_pass_wrappers_are_plain_and_uncounted(cdtype):
    v0, v1, phi, w, dmb, G = _inputs(6, cdtype)
    cf.reset_launches()
    assert torch.equal(cf.cheby_flip_high(v1, G, 3, w),
                       cf.cheby_flip_high_plain(v1, G, 3, w))
    a, b = v0.clone(), v0.clone()
    pa, pb = phi.clone(), phi.clone()
    cf.cheby_flip_iter_low(a, v1, pa, dmb, G, -0.2, 0.4, 4, w)
    cf.cheby_flip_iter_low_plain(b, v1, pb, dmb, G, -0.2, 0.4, 4, w)
    assert torch.equal(a, b) and torch.equal(pa, pb)
    got = cf.cheby_flip_first_low(v0, dmb, G, -0.1, 0.7, 0.2, 4, w)
    want = cf.cheby_flip_first_low_plain(v0, dmb, G, -0.1, 0.7, 0.2, 4, w)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert all(n == 0 for n in cf.LAUNCHES.values())


def test_pass_wrappers_validate_bit_counts():
    v0, v1, phi, _, dmb, G = _inputs(5, torch.complex128)
    with pytest.raises(ValueError, match="outside \\[0, 5\\]"):
        cf.cheby_flip_high(v1, G, 6)
    with pytest.raises(ValueError, match="outside \\[0, 5\\]"):
        cf.cheby_flip_iter_low(v0, v1, phi, dmb, G, -0.2, 0.4, -1)
    with pytest.raises(ValueError, match="outside \\[0, 5\\]"):
        cf.cheby_flip_first_low(v0, dmb, G, -0.1, 0.7, 0.2, 6)
    with pytest.raises(ValueError, match="G must be"):
        cf.cheby_flip_high(v1, G[:-1], 2)
