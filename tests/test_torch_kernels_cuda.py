"""The hand-written CUDA kernels against their plain PyTorch versions,
and the fused path on the card against the same path on the CPU.
Needs an NVIDIA GPU with nvcc (``-m cuda``); skips without one."""

import numpy as np
import pytest
import torch

import quantumpropagators_torch as qt
from quantumpropagators_torch.fused import cheby_propagate_fused
from quantumpropagators_torch.ops import cheby_flip as cf

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(L, cdtype, device, seed=3):
    rdtype = torch.float32 if cdtype == torch.complex64 else torch.float64
    rng = np.random.default_rng(seed)

    def vec():
        v = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
        return torch.as_tensor(v / np.linalg.norm(v)).to(device, cdtype)

    dmb = torch.as_tensor(rng.standard_normal(2 ** L) - 2.5).to(device, rdtype)
    G = torch.as_tensor(rng.uniform(0.5, 1.5, L)).to(device, rdtype)
    return vec(), vec(), vec(), dmb, G


_TOLS = ((torch.complex64, 1e-6), (torch.complex128, 1e-14))
_CASES = [(cdtype, tol, L) for cdtype, tol in _TOLS
          for L in cf.flip_check_sizes(cdtype)]


# sums are taken in another order than the plain version's: 1e-14 in
# double and 1e-6 in float on unit-norm states
@pytest.mark.parametrize("cdtype, tol, L", _CASES)
@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("separate_out", [False, True])
def test_kernels_match_plain(cuda, cdtype, tol, L, with_w, separate_out):
    v0, v1, phi, dmb, G = _inputs(L, cdtype, cuda)
    w = v1.flip(0).contiguous() if with_w else None
    h = cf.flip_split(L, cdtype)[1]
    cf.reset_launches()
    got = cf.cheby_flip_first(v0, dmb, G, -0.07, 0.8, -0.4, w)
    want = cf.cheby_flip_first_plain(v0, dmb, G, -0.07, 0.8, -0.4, w)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) < tol
    k0, kphi = v0.clone(), phi.clone()
    p0, pphi = v0.clone(), phi.clone()
    kout = torch.empty_like(v0) if separate_out else None
    pout = torch.empty_like(v0) if separate_out else None
    res = cf.cheby_flip_iter(k0, v1, kphi, dmb, G, -0.14, 0.3, w, out=kout)
    cf.cheby_flip_iter_plain(p0, v1, pphi, dmb, G, -0.14, 0.3, w, out=pout)
    torch.cuda.synchronize()
    assert res is (kout if separate_out else k0)
    got_v2, want_v2 = (kout, pout) if separate_out else (k0, p0)
    assert float((got_v2 - want_v2).abs().max()) < tol
    assert float((kphi - pphi).abs().max()) < tol
    if separate_out:
        assert torch.equal(k0, v0)  # v0 untouched
    ctype = "float" if cdtype == torch.complex64 else "double"
    # with a split, the high pass runs before the setup's tiled pass and
    # before the order's
    n_high = 2 if h else 0
    assert cf.LAUNCHES == {
        f"cheby_flip_{kind}<{c}>": (n_high if kind == "high" else 1)
        * int(c == ctype)
        for kind in ("first", "iter", "high") for c in ("float", "double")}
    if h:
        got_hi = cf.cheby_flip_high(v1, G, h, w)
        want_hi = cf.cheby_flip_high_plain(v1, G, h, w)
        torch.cuda.synchronize()
        assert float((got_hi - want_hi).abs().max()) < tol
        assert cf.LAUNCHES[f"cheby_flip_high<{ctype}>"] == 3


@pytest.mark.parametrize("cdtype, tol, L", _CASES)
@pytest.mark.parametrize("with_w", [False, True])
def test_first_low_pass_matches_plain(cuda, cdtype, tol, L, with_w):
    """The setup's tiled pass alone, over no bit, the tile's bits, the
    bits below the split and all bits."""
    v0, v1, _, dmb, G = _inputs(L, cdtype, cuda)
    w = v1 if with_w else None
    tile_bits, h = cf.flip_split(L, cdtype, setup=True)
    for bits in sorted({0, tile_bits, L - h, L}):
        got = cf.cheby_flip_first_low(v0, dmb, G, -0.07, 0.8, -0.4, bits, w)
        want = cf.cheby_flip_first_low_plain(v0, dmb, G, -0.07, 0.8, -0.4,
                                             bits, w)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) < tol


@pytest.mark.parametrize("cdtype, tol", _TOLS)
@pytest.mark.parametrize("h", range(1, 9))
def test_high_pass_every_h_matches_plain(cuda, cdtype, tol, h):
    """The high pass at every h it takes, its cube up to 64 KB (h = 8)."""
    _, v1, w, _, G = _inputs(20, cdtype, cuda)
    got = cf.cheby_flip_high(v1, G, h, w)
    want = cf.cheby_flip_high_plain(v1, G, h, w)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) < tol


def _slot_partners(L, cdtype, device, P=2):
    """A ``(slots, 2^L)`` stack ``v1``, ``v0`` and ``dmb`` alike, ``L + P``
    coefficients and ``P`` partners.  P = 2: a 4-slot state's own rows at
    ``slot_xor = 1`` and received rows at ``slot_xor = 0``.  P > 2: 32
    slots, its own rows at ``slot_xor = 1, 2, 4, ...`` (at most 5) and
    received stacks for the rest, as a rank of a wider mesh reads them."""
    slots = 4 if P == 2 else 32
    p = slots.bit_length() - 1
    v0, v1, w, dmb, G = _inputs(L + p, cdtype, device)
    stack = v1.view(slots, -1)
    own = min(P - 1, p)
    gen = torch.Generator(device=device).manual_seed(P)
    received = [w.view(slots, -1)] + [
        torch.randn(stack.shape, generator=gen, dtype=cdtype, device=device)
        for _ in range(P - own - 1)]
    weights = G[-2:] if P == 2 else torch.as_tensor(
        np.random.default_rng(P).uniform(0.5, 1.5, P)).to(device, G.dtype)
    G_all = torch.cat([G[:L], weights]).contiguous()
    parts = [(stack, 1 << r) for r in range(own)] + [(x, 0)
                                                      for x in received]
    return v0.view(slots, -1), stack, dmb.view(slots, -1), G_all, parts


@pytest.mark.parametrize("cdtype, tol", _TOLS)
@pytest.mark.parametrize("h", [0, 4])
@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("P", [2, 5, 8])
def test_high_pass_partners_match_plain(cuda, cdtype, tol, h, with_w, P):
    """The high pass with P partner rows on a 4-slot (P = 2) or 32-slot
    stack of 2^16, at h = 0 (the partners' weighted sum alone) and
    h = 4: one launch a slot."""
    v0, stack, _, G_all, parts = _slot_partners(16, cdtype, cuda, P)
    w = v0 if with_w else None
    cf.reset_launches()
    got = cf.cheby_flip_high(stack, G_all, h, w, partners=parts)
    want = cf.cheby_flip_high_plain(stack, G_all, h, w, partners=parts)
    torch.cuda.synchronize()
    ctype = "float" if cdtype == torch.complex64 else "double"
    assert cf.LAUNCHES[f"cheby_flip_high<{ctype}>"] == stack.shape[0]
    assert float((got - want).abs().max()) < tol


@pytest.mark.parametrize("cdtype, tol", _TOLS)
@pytest.mark.parametrize("L", [16, 20])
@pytest.mark.parametrize("P", [2, 5, 8])
def test_flip_with_partners_matches_plain(cuda, cdtype, tol, L, P):
    """The setup and the order with P partners on a 4-slot (P = 2) or
    32-slot stack, at a slot size without top bits (L = 16: the
    partners' own pass) and with them (L = 20); more partners than
    ``MAX_PARTNERS`` raise."""
    v0, v1, dmb, G_all, parts = _slot_partners(L, cdtype, cuda, P)
    if P == 2:
        parts = [(v1, 2), (v0, 0)]
    got = cf.cheby_flip_first(v1, dmb, G_all, -0.07, 0.8, -0.4,
                              partners=parts)
    want = cf.cheby_flip_first_plain(v1, dmb, G_all, -0.07, 0.8, -0.4,
                                     partners=parts)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) < tol
    phi = v0.flip(1).contiguous()
    k0, kphi, p0, pphi = (torch.zeros_like(v0), phi.clone(),
                          torch.zeros_like(v0), phi.clone())
    cf.cheby_flip_iter(k0, v1, kphi, dmb, G_all, -0.14, 0.3, partners=parts)
    cf.cheby_flip_iter_plain(p0, v1, pphi, dmb, G_all, -0.14, 0.3,
                             partners=parts)
    torch.cuda.synchronize()
    assert float((k0 - p0).abs().max()) < tol
    assert float((kphi - pphi).abs().max()) < tol
    many = cf.MAX_PARTNERS + 1
    with pytest.raises(ValueError, match="at most"):
        cf.cheby_flip_high(v1, torch.ones(L + many, dtype=G_all.dtype,
                                          device=cuda), 0,
                           partners=[(v1, 1)] * many)


@pytest.mark.parametrize("L", [3, 12, 20])
def test_iter_accepts_complex64_at_odd_offset(cuda, L):
    """A complex64 v1 one element into its buffer (8-byte aligned) is
    staged element by element and gives the same order."""
    v0, v1, phi, dmb, G = _inputs(L, torch.complex64, cuda)
    buf = torch.empty(2 ** L + 1, dtype=torch.complex64, device=cuda)
    odd = buf[1:]
    odd.copy_(v1)
    assert odd.data_ptr() % 16 == 8
    k0, kphi, p0, pphi = v0.clone(), phi.clone(), v0.clone(), phi.clone()
    cf.cheby_flip_iter(k0, odd, kphi, dmb, G, -0.14, 0.3)
    cf.cheby_flip_iter_plain(p0, v1, pphi, dmb, G, -0.14, 0.3)
    torch.cuda.synchronize()
    assert float((k0 - p0).abs().max()) < 1e-6
    assert float((kphi - pphi).abs().max()) < 1e-6


@pytest.mark.parametrize("L", [3, 12, 20])
def test_first_accepts_complex64_at_odd_offset(cuda, L):
    """A complex64 v0 one element into its buffer (8-byte aligned) is
    staged element by element and gives the same setup."""
    v0, _, _, dmb, G = _inputs(L, torch.complex64, cuda)
    buf = torch.empty(2 ** L + 1, dtype=torch.complex64, device=cuda)
    odd = buf[1:]
    odd.copy_(v0)
    assert odd.data_ptr() % 16 == 8
    got = cf.cheby_flip_first(odd, dmb, G, -0.07, 0.8, -0.4)
    want = cf.cheby_flip_first_plain(v0, dmb, G, -0.07, 0.8, -0.4)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) < 1e-6


def test_fused_path_on_card_matches_cpu(cuda):
    L = 11
    tlist = np.linspace(0.0, 0.5, 11)
    rng = np.random.default_rng(4)
    psi = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi = torch.as_tensor(psi / np.linalg.norm(psi))
    bound = (L - 1) + 0.3 * L + 1.2 * L
    kw = dict(specrange_method="manual", E_min=-bound - 0.4, E_max=bound)
    out = {}
    for device in ("cpu", cuda):
        Hd, Hx = qt.transverse_field_ising(L, g=1.2, h=0.3, device=device,
                                           dtype=torch.complex128)
        gen = qt.hamiltonian(Hd, (Hx, lambda t: 0.9 + 0.3 * np.sin(t)))
        for kernel in ("dd", "pallas"):
            p0 = psi.to(device)
            if kernel == "pallas":
                p0 = p0.to(torch.complex64)
            cf.reset_launches()
            res, _ = cheby_propagate_fused(p0, gen, tlist, kernel=kernel, **kw)
            launched = sum(cf.LAUNCHES.values())
            assert launched == 0 if device == "cpu" else launched > 0
            out[str(device), kernel] = res.cpu()
    assert float((out["cuda:0", "dd"] - out["cpu", "dd"]).abs().max()) < 1e-12
    assert float((out["cuda:0", "pallas"]
                  - out["cpu", "pallas"]).abs().max()) < 1e-5


@pytest.mark.parametrize("b, R, halo", [(128, 64, None), (8, 96, None),
                                        (8, 96, 4), (48, 20, 2)])
def test_banded_spmv_matches_plain(cuda, b, R, halo):
    from quantumpropagators_torch.ops import banded_spmv as bs

    rng = np.random.default_rng(b + R)
    offsets = (-2, -1, 0, 1, 2)
    planes = torch.as_tensor(rng.standard_normal((len(offsets), b, R, b)))
    rows = R if halo is None else R + 2 * halo
    x = rng.standard_normal(rows * b) + 1j * rng.standard_normal(rows * b)
    planes, x = planes.to(cuda), torch.as_tensor(x).to(cuda)
    bs.reset_launches()
    got = bs.banded_spmv(planes, offsets, x, halo)
    want = bs.banded_spmv_plain(planes, offsets, x, halo)
    torch.cuda.synchronize()
    assert bs.LAUNCHES["banded_spmv<double>"] == 1
    assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())


def test_static_dd_path_on_card_matches_cpu(cuda):
    import scipy.sparse as sp

    from quantumpropagators_torch.ops import banded_spmv as bs

    rng = np.random.default_rng(9)
    b, R = 128, 12
    N = b * R - 5  # padded inside the banded route
    A = sp.diags([rng.standard_normal(N - d) for d in (0, 1, 130)],
                 [0, 1, 130]).tocsr()
    A = (A + A.T).tocsr()
    psi = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    psi = torch.as_tensor(psi / np.linalg.norm(psi))
    tlist = np.linspace(0.0, 0.3, 4)
    bound = float(abs(A).sum(axis=1).max())
    kw = dict(specrange_method="manual", E_min=-1.1 * bound, E_max=bound,
              kernel="dd")
    out = {}
    for device in ("cpu", cuda):
        op = qt.bsr_from_scipy(A, block_size=128, device=device)
        bs.reset_launches()
        res, _ = cheby_propagate_fused(psi.to(device), op, tlist, **kw)
        launched = bs.LAUNCHES["banded_spmv<double>"]
        assert launched == 0 if device == "cpu" else launched > 0
        out[str(device)] = res.cpu()
    assert float((out["cuda:0"] - out["cpu"]).abs().max()) < 1e-12
