"""The two passes of the flip iteration on the card — the high pass
(flips of the top h bits into ``w_hi``) and the iteration pass (the order
over the bits below) — composed through their plain versions, against
the one-pass plain order and the JAX package's operators.

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


@pytest.mark.parametrize("L, h", [(5, 2), (9, 0), (9, 4), (9, 9)])
def test_split_order_matches_jax_operators(L, h):
    """One order through the two passes equals
    ``v0 + i·s2·(H − β)v1`` with ``H`` applied by the JAX package's TFIM
    operators (uniform transverse field: every bit has ``G_j = g``)."""
    g, beta, s2 = 1.2, 0.9, -0.21
    Hd, Hx = qp.transverse_field_ising(L, J=1.0, g=g, h=0.3,
                                       dtype=jnp.complex128)
    rng = np.random.default_rng(L + h)
    v0, v1 = (rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
              for _ in range(2))
    hv1 = np.asarray(qp.apply(Hd, jnp.asarray(v1))) \
        + np.asarray(qp.apply(Hx, jnp.asarray(v1)))
    want = v0 + 1j * s2 * (hv1 - beta * v1)
    dmb = torch.as_tensor(np.asarray(Hd.diag).real - beta)
    G = torch.full((L,), g, dtype=torch.float64)
    t0, t1 = torch.as_tensor(v0), torch.as_tensor(v1)
    phi = torch.zeros_like(t0)
    w_hi = cf.cheby_flip_high(t1, G, h)  # CPU tensors: the plain version
    cf.cheby_flip_iter_low(t0, t1, phi, dmb, G, s2, 0.5, L - h, w_hi)
    np.testing.assert_allclose(t0.numpy(), want, rtol=0, atol=1e-13)
    np.testing.assert_allclose(phi.numpy(), 0.5 * want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
def test_flip_split_invariants(cdtype):
    elem = cdtype.itemsize
    for L in range(1, cf.MAX_BITS + 1):
        tile_bits, h = cf.flip_split(L, cdtype)
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
    T = cf.flip_split(cf.MAX_BITS, cdtype)[0]
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
    assert all(n == 0 for n in cf.LAUNCHES.values())


def test_pass_wrappers_validate_bit_counts():
    v0, v1, phi, _, dmb, G = _inputs(5, torch.complex128)
    with pytest.raises(ValueError, match="outside \\[0, 5\\]"):
        cf.cheby_flip_high(v1, G, 6)
    with pytest.raises(ValueError, match="outside \\[0, 5\\]"):
        cf.cheby_flip_iter_low(v0, v1, phi, dmb, G, -0.2, 0.4, -1)
    with pytest.raises(ValueError, match="G must be"):
        cf.cheby_flip_high(v1, G[:-1], 2)
