"""The measurement kernels of ``csrc/probes.cu`` against their plain
PyTorch versions on the card, at small sizes.  Needs an NVIDIA GPU with
nvcc (``-m cuda``); skips without one.

Tolerances: bit for bit where the kernel adds in the plain version's
order (copies, permutations, in-order sums); float32 sums in another
order within 2e-6 of the plane's max; FMA chains (the compiler contracts
``t·mul + s``) within 1e-5 of the max; float64 within 1e-14 on unit-norm
states."""

import numpy as np
import pytest
import torch

from quantumpropagators_torch.ops import cheby_flip as cf
from quantumpropagators_torch.ops import probes
from quantumpropagators_torch.profiling import exactness, scatter, time_ms
from quantumpropagators_torch.profiling.dd_stages import order_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _planes(n, count, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(n, dtype=np.float32))
            .to(device) for _ in range(count)]


def _assert_close(got, want, rel):
    got, want = got.cpu(), want.cpu()
    if rel == 0:
        assert torch.equal(got, want)
    else:
        err = float((got.double() - want.double()).abs().max())
        assert err <= rel * float(want.double().abs().max()), err


_STREAM = {
    # name: (op, planes, chain, mul, scale, tolerance)
    "copy": ("sum", 1, 0, 1.0, 1.0, 0),
    "copy*1.0000001": ("sum", 1, 0, 1.0, 1.0000001, 0),
    "add": ("sum", 2, 0, 1.0, 1.0, 0),
    "sum7": ("sum", 7, 0, 1.0, 1.0, 0),
    "triad": ("triad", 3, 0, 1.0, 1.0, 2e-6),
    "fma64": ("chain", 2, 64, 1.0000001, 1.0, 1e-5),
}


@pytest.mark.parametrize("name", sorted(_STREAM))
def test_stream_matches_plain(cuda, name):
    op, n_in, chain, mul, scale, tol = _STREAM[name]
    xs = _planes(1 << 16, n_in, cuda)
    before = probes.LAUNCHES[f"probe_stream<{op}>"]
    (got,) = probes.probe_stream(xs, op, chain=chain, mul=mul, scale=scale)
    (want,) = probes.probe_stream_plain(xs, op, chain=chain, mul=mul,
                                        scale=scale)
    _assert_close(got, want, tol)
    assert probes.LAUNCHES[f"probe_stream<{op}>"] == before + 1


# plane lengths: whole chunks of the kernel's blocks (256 float4s), and
# multiples of 4 that are not
_STREAM_LENGTHS = (1 << 16, (1 << 16) + 4, (1 << 16) + 1028, 4)


@pytest.mark.parametrize("n", _STREAM_LENGTHS)
@pytest.mark.parametrize("name", sorted(_STREAM) + ["sum3"])
def test_stream_lengths_match_plain(cuda, name, n):
    op, n_in, chain, mul, scale, tol = _STREAM.get(
        name, ("sum", 3, 0, 1.0, 1.0, 0))
    xs = _planes(n, n_in, cuda, seed=5)
    (got,) = probes.probe_stream(xs, op, chain=chain, mul=mul, scale=scale)
    (want,) = probes.probe_stream_plain(xs, op, chain=chain, mul=mul,
                                        scale=scale)
    _assert_close(got, want, tol)


@pytest.mark.parametrize("kind", list(probes.MAP_KINDS))
@pytest.mark.parametrize("n_in", [1, 2, 16])
def test_stream_map_kinds_match_plain(cuda, kind, n_in):
    """Each map kind on every plane, in the small bodies and the 16-plane
    sum, on a length that is not a whole number of chunks."""
    n, tile_bits = (1 << 16) + 1024, 10
    xs = _planes(n, n_in, cuda, seed=6)
    maps = [(kind, 0 if kind == "self" else 1 + 2 * (k % 2))
            for k in range(n_in)]
    if kind == "xor":
        n, tile_bits = 1 << 16, 10  # xor needs a power-of-two tile count
        xs = [x[:n] for x in xs]
    got = probes.probe_stream(xs, "sum", maps=maps, tile_bits=tile_bits,
                              n_out=2)
    want = probes.probe_stream_plain(xs, "sum", maps=maps,
                                     tile_bits=tile_bits, n_out=2)
    _assert_close(got[0], want[0], 0)
    _assert_close(got[1], want[1], 0)


@pytest.mark.parametrize("name", ["copy", "triad", "sum7"])
def test_stream_repeated_launches_agree(cuda, name):
    op, n_in, chain, mul, scale, _ = _STREAM[name]
    xs = _planes((1 << 20) + 4, n_in, cuda, seed=7)
    (first,) = probes.probe_stream(xs, op, chain=chain, mul=mul, scale=scale)
    for _ in range(50):
        (got,) = probes.probe_stream(xs, op, chain=chain, mul=mul,
                                     scale=scale)
        assert torch.equal(got, first)


@pytest.mark.parametrize("mode", scatter.MODES)
@pytest.mark.parametrize("flops", [0, 400])
def test_scatter_matches_plain(cuda, mode, flops):
    xs = _planes(1 << 18, scatter.N_IN, cuda)
    tile_bits = 12
    m = scatter.maps(mode, (1 << 18) >> tile_bits)
    kw = dict(maps=m, tile_bits=tile_bits, chain=scatter.chain_of(flops),
              mul=0.9999, n_out=2)
    got = probes.probe_stream(xs, "sum", **kw)
    want = probes.probe_stream_plain(xs, "sum", **kw)
    _assert_close(got[0], want[0], 1e-5 if flops else 0)
    _assert_close(got[1], want[1], 0)


@pytest.mark.parametrize("chunk", [256, 1024])
@pytest.mark.parametrize("flops", [0, 400])
def test_pipelined_matches_plain(cuda, chunk, flops):
    xs = _planes(1 << 17, scatter.N_IN, cuda)
    kw = dict(chain=scatter.chain_of(flops), mul=0.9999, chunk=chunk)
    _assert_close(probes.probe_stream_pipelined(xs, **kw),
                  probes.probe_stream_pipelined_plain(xs, **kw),
                  1e-5 if flops else 0)


def _flip_plane_bits(plane, variant, tile_bits):
    """log2 of the plane: 2^18; 2^22, more tiles than the card holds at
    once (132 SMs: 7 blocks an SM of the tile variant, 264 consumer groups
    of the persistent mma one, which takes 512 tiles unevenly); one stage
    (the tile variant stages at least 2^10 elements, the mma one 64
    rows); 2^11, part of the mma variant's stage."""
    stage = 13 if variant == "mma" else max(tile_bits, 10)
    return {"2^18": 18, "2^22": 22, "one stage": stage, "2^11": 11}[plane]


@pytest.mark.parametrize("variant, tile_bits",
                         [("gather", 12), ("tile", 12), ("tile", 8),
                          ("tile", 14), ("tile", 15), ("shfl", 12),
                          ("mma", 13), ("mma", 11)])
@pytest.mark.parametrize("lo, hi", [(0, 9), (0, 12), (7, 17), (3, 5),
                                    (0, 16), (13, 22)])
@pytest.mark.parametrize("plane", ["2^18", "2^22", "one stage", "2^11"])
def test_flipsum_matches_plain(cuda, variant, tile_bits, lo, hi, plane):
    if variant == "mma" and (lo != 0 or hi < 7):
        pytest.skip("the mma variant sums bits 0-6 on the tensor cores")
    n_bits = _flip_plane_bits(plane, variant, tile_bits)
    if hi > n_bits or tile_bits > n_bits:
        pytest.skip(f"bits [{lo}, {hi}) or tiles of 2^{tile_bits} do not "
                    f"fit a plane of 2^{n_bits}")
    (x,) = _planes(1 << n_bits, 1, cuda)
    got = probes.probe_flipsum(x, lo, hi, variant, tile_bits)
    want = probes.probe_flipsum_plain(x, lo, hi, variant, tile_bits)
    _assert_close(got, want, 2e-6 if variant == "mma" else 0)


@pytest.mark.parametrize("variant, tile_bits", [("tile", 12), ("mma", 13)])
def test_flipsum_repeated_launches_agree(cuda, variant, tile_bits):
    """A race in the ring shows as a launch that differs from the first:
    200 more launches on the same plane, each into memory that held NaNs,
    equal the first bit for bit."""
    (x,) = _planes(1 << 22, 1, cuda, seed=3)
    first = probes.probe_flipsum(x, 0, 9, variant, tile_bits)
    for _ in range(200):
        # freed at once: the next output's block is handed back full of NaNs
        torch.full_like(x, float("nan"))
        got = probes.probe_flipsum(x, 0, 9, variant, tile_bits)
        assert torch.equal(got, first)
        del got


@pytest.mark.parametrize("mode", list(probes.MMA_MODES))
def test_tile_mma_permutations_bit_for_bit(cuda, mode):
    dtype = torch.float64 if mode == "f64" else torch.float32
    (x,) = _planes(64 * 128, 1, cuda)
    x = x.view(64, 128).to(dtype)
    for bit in range(7):
        P = torch.from_numpy(exactness.permutation(bit)).to(cuda, dtype)
        _assert_close(probes.probe_tile_mma(x, P, mode),
                      probes.probe_tile_mma_plain(x, P, mode), 0)
    # a permutation that is not a flip: every fragment position distinct
    perm = np.random.default_rng(1).permutation(128)
    Q = np.zeros((128, 128), np.float32)
    Q[perm, np.arange(128)] = 1.0
    Q = torch.from_numpy(Q).to(cuda, dtype)
    _assert_close(probes.probe_tile_mma(x, Q, mode),
                  probes.probe_tile_mma_plain(x, Q, mode), 0)


@pytest.mark.parametrize("mode", list(probes.MMA_MODES))
def test_tile_mma_random_matches_plain(cuda, mode):
    dtype = torch.float64 if mode == "f64" else torch.float32
    x, m = _planes(256 * 128, 2, cuda)
    x = x.view(256, 128).to(dtype)
    M = m[:128 * 128].view(128, 128).to(dtype)
    _assert_close(probes.probe_tile_mma(x, M, mode),
                  probes.probe_tile_mma_plain(x, M, mode),
                  1e-14 if mode == "f64" else 2e-6)


# row counts that are not multiples of the kernels' tiles (64 rows TF32 and
# 3xTF32, 32 rows FP64), and the timed sizes of chip_smoke.py phase 16b
_RAGGED_ROWS = {"tf32": (16, 48, 80, 1040), "3xtf32": (16, 48, 80, 1040),
                "f64": (8, 24, 72, 1032)}
_TIMED_ROWS = {"tf32": 1 << 19, "3xtf32": 1 << 19, "f64": 1 << 18}
_MMA_TOL = {"tf32": 2e-6, "3xtf32": 2e-6, "f64": 1e-14}


def _mma_operands(mode, rows, cuda, seed=0):
    dtype = torch.float64 if mode == "f64" else torch.float32
    (x,) = _planes(rows * 128, 1, cuda, seed)
    return x.view(rows, 128).to(dtype), \
        _planes(128 * 128, 1, cuda, seed + 1)[0].view(128, 128).to(dtype)


@pytest.mark.parametrize("mode, rows", [(m, r) for m, rs in
                                        _RAGGED_ROWS.items() for r in rs])
def test_tile_mma_ragged_rows_match_plain(cuda, mode, rows):
    x, M = _mma_operands(mode, rows, cuda)
    before = probes.LAUNCHES[f"probe_tile_mma<{mode}>"]
    _assert_close(probes.probe_tile_mma(x, M, mode),
                  probes.probe_tile_mma_plain(x, M, mode), _MMA_TOL[mode])
    assert probes.LAUNCHES[f"probe_tile_mma<{mode}>"] == before + 1


@pytest.mark.parametrize("mode", list(probes.MMA_MODES))
def test_tile_mma_ties_bit_for_bit(cuda, mode):
    """Operands on a TF32 rounding tie, through each flip permutation: a
    kernel that truncated in place of rounding (ties away) would differ."""
    dtype = torch.float64 if mode == "f64" else torch.float32
    ties = exactness.tf32_ties((80, 128), seed=4)
    x = torch.from_numpy(ties).to(cuda, dtype)
    truncated = torch.from_numpy(ties.view(np.int32) & ~0x1FFF).view(
        torch.float32)
    assert not torch.equal(probes.tf32_round(torch.from_numpy(ties)),
                           truncated)
    for bit in range(7):
        P = torch.from_numpy(exactness.permutation(bit)).to(cuda, dtype)
        _assert_close(probes.probe_tile_mma(x, P, mode),
                      probes.probe_tile_mma_plain(x, P, mode), 0)


@pytest.mark.parametrize("mode", list(probes.MMA_MODES))
def test_tile_mma_timed_size_matches_plain(cuda, mode):
    x, M = _mma_operands(mode, _TIMED_ROWS[mode], cuda)
    _assert_close(probes.probe_tile_mma(x, M, mode),
                  probes.probe_tile_mma_plain(x, M, mode), _MMA_TOL[mode])


@pytest.mark.parametrize("mode", list(probes.MMA_MODES))
def test_tile_mma_repeated_launches_agree(cuda, mode):
    """The ring's barriers: 50 launches at the timed size, each output
    equal bit for bit to the first."""
    x, M = _mma_operands(mode, _TIMED_ROWS[mode], cuda)
    first = probes.probe_tile_mma(x, M, mode)
    for _ in range(50):
        assert torch.equal(probes.probe_tile_mma(x, M, mode), first)


@pytest.mark.parametrize("mode", list(probes.MMA_MODES))
def test_tile_mma_records_into_a_cuda_graph(cuda, mode):
    x, M = _mma_operands(mode, 1032 if mode == "f64" else 1040, cuda)
    want = probes.probe_tile_mma(x, M, mode)
    assert time_ms(lambda: probes.probe_tile_mma(x, M, mode), 3) > 0
    out = {}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out["got"] = probes.probe_tile_mma(x, M, mode)
    graph.replay()
    torch.cuda.synchronize()
    _assert_close(out["got"], want, 0)


@pytest.mark.parametrize("mode", list(probes.MMA_MODES))
def test_tile_mma_refuses_a_misaligned_plane(cuda, mode):
    """The ring's bulk copies need 16-byte aligned rows: a plane that
    starts one element into its storage raises, naming the rule, and
    launches nothing."""
    dtype = torch.float64 if mode == "f64" else torch.float32
    x = torch.zeros(64 * 128 + 1, device=cuda, dtype=dtype)[1:].view(64, 128)
    M = torch.eye(128, device=cuda, dtype=dtype)
    before = probes.LAUNCHES[f"probe_tile_mma<{mode}>"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        probes.probe_tile_mma(x, M, mode)
    assert probes.LAUNCHES[f"probe_tile_mma<{mode}>"] == before


def test_smem_limit(cuda):
    (x,) = _planes(4096, 1, cuda)
    for kb in (16, 48, 100, 227):
        _assert_close(probes.probe_smem(x, kb * 1024),
                      probes.probe_smem_plain(x, kb * 1024), 0)
    before = probes.LAUNCHES["probe_smem"]
    with pytest.raises(probes.SmemRefused):
        probes.probe_smem(x, 228 * 1024)
    assert probes.LAUNCHES["probe_smem"] == before
    _assert_close(probes.probe_smem(x, 16 * 1024), 2 * x, 0)


@pytest.mark.parametrize("L", [11, 14, 20])
@pytest.mark.parametrize("body", list(probes.ORDER_BODIES))
@pytest.mark.parametrize("nb", list(probes.ORDER_NBS))
@pytest.mark.parametrize("with_w", [False, True])
def test_flip_order_matches_plain(cuda, L, body, nb, with_w):
    v0, v1, phi, dmb, G = order_inputs(L, cuda, seed=2)
    w = v1.flip(0).contiguous() if with_w else None
    tile_bits = cf.flip_split(L, torch.complex128)[0]
    bits = L - 2 if L > 12 else L
    k0, kphi = v0.clone(), phi.clone()
    p0, pphi = v0.clone(), phi.clone()
    probes.probe_flip_order(k0, v1, kphi, dmb, G, -0.14, 0.3, tile_bits,
                            bits, body, nb, w)
    probes.probe_flip_order_plain(p0, v1, pphi, dmb, G, -0.14, 0.3,
                                  tile_bits, bits, body, nb, w)
    assert float((k0 - p0).abs().max()) < 1e-14
    assert float((kphi - pphi).abs().max()) < 1e-14


def test_flip_order_full_is_the_production_pass(cuda):
    L = 20
    v0, v1, phi, dmb, G = order_inputs(L, cuda, seed=3)
    tile_bits, h = cf.flip_split(L, torch.complex128)
    w = cf.cheby_flip_high(v1, G, h)
    a0, aphi = v0.clone(), phi.clone()
    probes.probe_flip_order(a0, v1, aphi, dmb, G, -0.14, 0.3, tile_bits,
                            L - h, "full", "xor", w)
    cf.cheby_flip_iter_low(v0, v1, phi, dmb, G, -0.14, 0.3, L - h, w)
    assert torch.equal(a0, v0) and torch.equal(aphi, phi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fma_residual_reads_a_named_outcome(cuda, dtype):
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal(4096)).to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal(4096)).to(cuda, dtype)
    for variant in ("inline", "loaded"):
        p, r = probes.probe_fma_residual(a, b, variant)
        assert probes.fma_outcome(a, b, p, r) in ("FUSED", "separate")
    ps, rs = probes.probe_fma_residual(a, b, "separate")
    pp, rp = probes.probe_fma_residual_plain(a, b, "separate")
    _assert_close(ps, pp, 0)
    _assert_close(rs, rp, 0)


def test_extract_matches_plain(cuda):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, 128))
         * np.exp(rng.uniform(-8, 3, (8, 128)))).astype(np.float32)
    x = torch.from_numpy(x).to(cuda)
    q, r = probes.probe_extract(x)
    qp, rp = probes.probe_extract_plain(x)
    _assert_close(q, qp, 0)
    _assert_close(r, rp, 0)
    assert probes.extract_outcome(x, q) == "kept"


@pytest.mark.parametrize("variant, bits",
                         [("shfl", range(5)), ("smem", range(12))])
def test_xor_permute_matches_plain(cuda, variant, bits):
    (x,) = _planes(1 << 14, 1, cuda)
    for bit in bits:
        _assert_close(probes.probe_xor_permute(x, bit, variant),
                      probes.probe_xor_permute_plain(x, bit, variant), 0)


def test_kernels_record_into_a_cuda_graph(cuda):
    """The probe modules time each kernel as a replayed CUDA graph of its
    launches: a recorded launch must set nothing on the host side and
    replay to the eager result."""
    xs = _planes(1 << 18, 16, cuda)
    x2 = xs[0].view(-1, 128)
    M = xs[1][:128 * 128].view(128, 128)
    v0, v1, phi, dmb, G = order_inputs(14, cuda)
    calls = {
        "stream": lambda: probes.probe_stream(xs, "sum", chain=4, n_out=2)[0],
        "copy": lambda: probes.probe_stream(xs[:1])[0],
        "pipelined": lambda: probes.probe_stream_pipelined(xs),
        "mma flips": lambda: probes.probe_flipsum(xs[0], 0, 9, "mma", 13),
        "tile flips": lambda: probes.probe_flipsum(xs[0], 0, 12, "tile", 14),
        "tile mma": lambda: probes.probe_tile_mma(x2, M, "3xtf32"),
        "smem": lambda: probes.probe_smem(xs[2][:4096], 227 * 1024),
        "order": lambda: probes.probe_flip_order(
            v0.clone(), v1, phi.clone(), dmb, G, -0.1, 0.2, 10, 14),
    }
    for name, call in calls.items():
        want = call()
        assert time_ms(call, 3) > 0, name
        out = {}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out["got"] = call()
        graph.replay()
        torch.cuda.synchronize()
        _assert_close(out["got"], want, 0)


def test_time_ms_counts_the_launches_that_ran(cuda):
    """Recording a launch into the timing graph runs nothing; the warm-ups
    and the two replays do, and the counts say so."""
    (x,) = _planes(1 << 16, 1, cuda)
    v0, v1, phi, dmb, G = order_inputs(12, cuda)
    probes.reset_launches()
    cf.reset_launches()
    time_ms(lambda: probes.probe_stream([x]), 3)
    time_ms(lambda: cf.cheby_flip_high(v1, G, 2), 4)
    assert probes.LAUNCHES["probe_stream<sum>"] == 2 + 2 * 3
    assert cf.LAUNCHES["cheby_flip_high<double>"] == 2 + 2 * 4
    assert sum(probes.LAUNCHES.values()) == 8
