"""The measurement kernels' plain versions (``ops/probes.py``) against the
TPU probe bodies under ``docs/profiling/``, on the CPU.

Each Pallas body is read from its script with ``ast`` and only that
function (or the lambda handed to ``mk``/``pl.pallas_call``) is executed:
the scripts time the TPU when they are imported.  ``probe_scatter_r4``
and ``probe_mxu_grid_r4`` keep their work under a main guard and are
imported.  The bodies run through ``pl.pallas_call(..., interpret=True)``
on (64, 128) planes in tiles of 16 or 32 rows (one tile of 1024 rows for
the row flips of bits 7-16).  The dd-stage scripts call kernels the JAX
package no longer has: their port is held against numpy complex128 and
the flip order's plain version instead.

Tolerances: bit for bit where both add in the same order (copies, sums,
flip sums in ascending bit order, permutations, σ-extraction); the
triad, matrix products and the lane-matmul flip sum (sums in another
order) within 2e-6 of the result's max; FMA chains within 1e-5 of it;
complex128 within 1e-14 on unit-norm states.
"""

import ast
import importlib.util
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import quantumpropagators_torch as qt
from quantumpropagators_torch.ops import probes
from quantumpropagators_torch.ops.cheby_flip import cheby_flip_iter_plain
from quantumpropagators_torch.profiling import (dd_stages, exactness, flips,
                                                roofline, scatter)

qt.set_default_device("cpu")
ROOT = Path(__file__).resolve().parents[1]
PROBES = ROOT / "docs" / "profiling"
LANE = 128


def probe_body(script, name, **names):
    """Body ``name`` of ``docs/profiling/<script>``, executed alone: a
    function definition anywhere in the file, or the lambda that is the
    first argument of the call assigned to ``name``."""
    tree = ast.parse((PROBES / script).read_text())
    ns = {"jax": jax, "jnp": jnp, "np": np, "pl": pl, "pltpu": pltpu,
          "LANE": LANE, **names}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            exec(compile(ast.Module([node], []), script, "exec"), ns)
            return ns[name]
        if isinstance(node, ast.Assign) \
                and [getattr(t, "id", None) for t in node.targets] == [name] \
                and isinstance(node.value, ast.Call) and node.value.args \
                and isinstance(node.value.args[0], ast.Lambda):
            return eval(compile(ast.Expression(node.value.args[0]), script,
                                "eval"), ns)
    raise LookupError(f"{script} has no body {name}")


def import_probe(script):
    spec = importlib.util.spec_from_file_location(script[:-3], PROBES / script)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def interpret(body, planes, tile_rows, n_out=1, specs=None, extra=()):
    """``body`` over the (rows, 128) ``planes`` in tiles of ``tile_rows``
    rows (``specs``: the planes' block specs, default the tile's own),
    ``extra`` whole-array operands after them; numpy outputs."""
    rows = planes[0].shape[0]
    vec = pl.BlockSpec((tile_rows, LANE), lambda i: (i, 0))
    in_specs = (specs or [vec] * len(planes)) + [
        pl.BlockSpec(e.shape, lambda i: (0, 0)) for e in extra]
    out = jax.ShapeDtypeStruct((rows, LANE), jnp.float32)
    res = pl.pallas_call(
        body, grid=(rows // tile_rows,), in_specs=in_specs,
        out_specs=[vec] * n_out if n_out > 1 else vec,
        out_shape=[out] * n_out if n_out > 1 else out, interpret=True,
    )(*planes, *extra)
    return [np.asarray(r) for r in res] if n_out > 1 else [np.asarray(res)]


def planes_np(count, rows=64, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((rows, LANE)) * scale).astype(np.float32)
            for _ in range(count)]


def held(port, jax_out, rel):
    """``port`` (a tensor) against the JAX body's output: bit for bit
    (``rel = 0``) or within ``rel·max|jax_out|``."""
    got = port.numpy()
    if rel == 0:
        np.testing.assert_array_equal(got, jax_out)
    else:
        err = np.abs(got.astype(np.float64) - jax_out).max()
        assert err <= rel * np.abs(jax_out).max(), err


_T = torch.from_numpy

# (script, body, op, planes, chain, mul, scale, tolerance)
STREAM_BODIES = [
    ("scratch_roofline.py", "copy_k", "sum", 1, 0, 1.0, 1.0, 0),
    ("scratch_roofline.py", "add_k", "sum", 2, 0, 1.0, 1.0, 0),
    ("scratch_roofline.py", "fma16_kern", "chain", 2, 16, 1.0000001, 1.0,
     1e-5),
    ("scratch_roofline.py", "fma64_kern", "chain", 2, 64, 1.0000001, 1.0,
     1e-5),
    ("scratch_r3_roofline.py", "copy_k", "sum", 1, 0, 1.0, 1.0, 0),
    ("scratch_r3_roofline.py", "add_k", "sum", 2, 0, 1.0, 1.0, 0),
    ("scratch_r3_roofline.py", "tri_k", "triad", 3, 0, 1.0, 1.0, 2e-6),
    ("scratch_r3_roofline.py", "fma64_kern", "chain", 2, 64, 1.0000001, 1.0,
     1e-5),
    ("scratch_r3_probe2.py", "copy_k", "sum", 1, 0, 1.0, 1.0000001, 0),
    ("scratch_r3_probe2.py", "add_k", "sum", 2, 0, 1.0, 1.0, 0),
    ("scratch_r3_probe2.py", "seven_k", "sum", 7, 0, 1.0, 1.0, 0),
    ("scratch_r3_probe3.py", "copy_k", "sum", 1, 0, 1.0, 1.0000001, 0),
]


@pytest.mark.parametrize("script, name, op, n_in, chain, mul, scale, rel",
                         STREAM_BODIES, ids=[f"{s}:{b}" for s, b, *_
                                             in STREAM_BODIES])
def test_stream_body_matches_plain(script, name, op, n_in, chain, mul, scale,
                                   rel):
    xs = planes_np(n_in)
    (want,) = interpret(probe_body(script, name), xs, 16)
    (got,) = probes.probe_stream_plain([_T(x) for x in xs], op, chain=chain,
                                       mul=mul, scale=scale)
    held(got, want, rel)


# (script, body, tile rows, (lo, hi) flip bits, port variant)
FLIP_BODIES = [
    ("scratch_roofline.py", "roll12_kern", 32, (0, 12), "tile"),
    ("scratch_r3_roofline.py", "roll12_kern", 32, (0, 12), "tile"),
    ("scratch_flips.py", "flipsum_where", 16, (0, 9), "gather"),
    ("scratch_flips.py", "flipsum_ptpu", 16, (0, 9), "shfl"),
    ("scratch_flips.py", "flipsum_reshape_rows", 16, (0, 9), "tile"),
    ("scratch_r3_probe2.py", "flips_a_kern", 1024, (7, 17), "tile"),
    ("scratch_r3_probe2.py", "flips_b_kern", 1024, (7, 17), "tile"),
]


@pytest.mark.parametrize("script, name, tile_rows, bits, variant",
                         FLIP_BODIES, ids=[f"{s}:{b}" for s, b, *_
                                           in FLIP_BODIES])
def test_flip_body_matches_plain(script, name, tile_rows, bits, variant):
    (x,) = planes_np(1, rows=max(64, tile_rows))
    (want,) = interpret(probe_body(script, name, TR=tile_rows), [x],
                        tile_rows)
    held(probes.probe_flipsum_plain(_T(x), *bits, variant, 8), want, 0)


def test_lane_matmul_flip_body_matches_plain():
    (x,) = planes_np(1)
    A = exactness.adjacency()
    (want,) = interpret(probe_body("scratch_flips.py", "flipsum_lanemat",
                                   TR=16), [x], 16, extra=(A,))
    held(probes.probe_flipsum_plain(_T(x), 0, 9, "mma", 11), want, 2e-6)


def test_matmul_body_matches_plain():
    (x,) = planes_np(1)
    (M,) = planes_np(1, rows=LANE, seed=1)
    (want,) = interpret(probe_body("scratch_roofline.py", "matmul_kern"),
                        [x], 16, extra=(M,))
    got = probes.probe_tile_mma_plain(_T(x).double(), _T(M).double(), "f64")
    held(got.float(), want, 2e-6)


@pytest.mark.parametrize("mode", ["perm", "A01"])
def test_permutation_probe_body_matches_plain(mode):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((32, LANE))
         * np.exp(rng.uniform(-30, 30, (32, LANE)))).astype(np.float32)
    M = exactness.permutation(0) if mode == "perm" else exactness.adjacency()
    (want,) = interpret(probe_body("scratch_flips.py", "probe_kern"), [x], 16,
                        extra=(M,))
    got = probes.probe_tile_mma_plain(_T(x).double(), _T(M).double(), "f64")
    held(got.float(), want, 0 if mode == "perm" else 2e-6)


@pytest.mark.parametrize("mode", scatter.MODES)
@pytest.mark.parametrize("flops", [0, 8])
def test_scatter_kernel_matches_plain(mode, flops):
    ps = import_probe("probe_scatter_r4.py")
    rows, tile_rows = 64, 16
    n_tiles = rows // tile_rows
    # the index maps of probe_scatter_r4.build
    n_bits = max(1, int(np.log2(n_tiles)))
    vec = pl.BlockSpec((tile_rows, LANE), lambda i: (i, 0))
    mapped = {
        "xor": lambda d: pl.BlockSpec((tile_rows, LANE),
                                      lambda i, _d=d: (i ^ _d, 0)),
        "stride": lambda d: pl.BlockSpec(
            (tile_rows, LANE), lambda i, _d=d: ((i + _d) % n_tiles, 0)),
    }
    specs = [vec] * ps.N_IN if mode == "seq" else (
        [vec] * (ps.N_IN - ps.N_XOR)
        + [mapped[mode](1 << (j % n_bits)) for j in range(ps.N_XOR)])
    xs = planes_np(ps.N_IN, rows, scale=1e-3)
    want = interpret(partial(ps.kernel, ps.N_IN, flops), xs, tile_rows,
                     n_out=2, specs=specs)
    tile_bits = (tile_rows * LANE).bit_length() - 1
    got = probes.probe_stream_plain(
        [_T(x) for x in xs], "sum", maps=scatter.maps(mode, n_tiles),
        tile_bits=tile_bits, chain=scatter.chain_of(flops), mul=0.9999,
        n_out=2)
    held(got[0], want[0], 1e-5 if flops else 0)
    held(got[1], want[1], 0)


def test_manual_dma_kernel_matches_plain():
    ps = import_probe("probe_scatter_r4.py")
    xs = planes_np(ps.N_IN, 64, scale=1e-3)
    run = ps.build_manual(64, 16, 8, interpret=True)
    want = float(run([jnp.asarray(x) for x in xs], 1))  # sum of its output
    got = probes.probe_stream_pipelined_plain(
        [_T(x) for x in xs], chain=scatter.chain_of(8), mul=0.9999, chunk=16)
    assert abs(float(got.double().sum()) - want) <= 1e-5 * float(
        got.double().abs().sum())


@pytest.mark.parametrize("script", ["scratch_r3_probe2.py",
                                    "scratch_r3_probe3.py"])
def test_fma_probe_body_reads_a_named_outcome(script):
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((8, LANE)).astype(np.float32) \
        * np.float32(1.000001)
    ys = rng.standard_normal((8, LANE)).astype(np.float32) \
        * np.float32(0.999999)
    vecs = pl.BlockSpec((8, LANE), lambda: (0, 0))
    p, r = pl.pallas_call(
        probe_body(script, "fma_probe_kernel"), in_specs=[vecs, vecs],
        out_specs=[vecs, vecs],
        out_shape=[jax.ShapeDtypeStruct((8, LANE), jnp.float32)] * 2,
        interpret=True)(xs, ys)
    a, b = _T(xs), _T(ys)
    p, r = np.array(p), np.array(r)
    outcome = probes.fma_outcome(a, b, _T(p), _T(r))
    assert outcome in ("FUSED", "separate")
    pp, rp = probes.probe_fma_residual_plain(a, b, "separate")
    held(pp, p, 0)
    if outcome == "separate":
        held(rp, r, 0)


def _one_block(body, x, n_out):
    spec = pl.BlockSpec(x.shape, lambda: (0, 0))
    out = pl.pallas_call(
        body, in_specs=[spec], out_specs=[spec] * n_out,
        out_shape=[jax.ShapeDtypeStruct(x.shape, jnp.float32)] * n_out,
        interpret=True)(x)
    return [np.asarray(o) for o in out]


def test_extract_body_matches_plain():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, LANE))
         * np.exp(rng.uniform(-8, 3, (8, LANE)))).astype(np.float32)
    q, r = _one_block(probe_body("scratch_r3_probe4.py", "extract_kernel"),
                      x, 2)
    qp, rp = probes.probe_extract_plain(_T(x))
    held(qp, q, 0)
    held(rp, r, 0)
    assert probes.extract_outcome(_T(x), qp) == "kept"


@pytest.mark.parametrize("precision", [None, jax.lax.Precision.HIGHEST])
def test_aligned_dot_body_matches_plain(precision):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, LANE))
         * np.exp(rng.uniform(-8, 3, (8, LANE)))).astype(np.float32)
    eps = np.float32(np.float32(64.0 * np.abs(x).max()) * 2.0 ** -24)
    q = (np.round(x / eps) * eps).astype(np.float32)
    A = exactness.adjacency()
    dot = probe_body("scratch_r3_probe4.py", "dot_kernel")
    spec = pl.BlockSpec((8, LANE), lambda: (0, 0))
    want = np.asarray(pl.pallas_call(
        lambda xr, ar, o: dot(precision, xr, ar, o),
        in_specs=[spec, pl.BlockSpec((LANE, LANE), lambda: (0, 0))],
        out_specs=spec, out_shape=jax.ShapeDtypeStruct((8, LANE),
                                                       jnp.float32),
        interpret=True)(q, A))
    got = probes.probe_tile_mma_plain(_T(q).double(), _T(A).double(), "f64")
    # eps is no power of two, so sums of its multiples round in float32
    held(got.float(), want, 2e-6)


def test_grouped_roll_body_matches_plain():
    (x,) = planes_np(1, rows=32)
    (want,) = _one_block(probe_body("scratch_r3_probe4.py", "roll_kernel"),
                         x, 1)
    held(probes.probe_xor_permute_plain(_T(x), 8, "smem"), want, 0)


def test_vmem_scratch_body_matches_plain():
    (x,) = planes_np(1, rows=16)
    spec = pl.BlockSpec((16, LANE), lambda i: (0, 0))
    want = np.asarray(pl.pallas_call(
        probe_body("scratch_r3_roofline.py", "kern", TR=16), grid=(1,),
        in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((16, LANE), jnp.float32),
        scratch_shapes=[pltpu.VMEM((64, LANE), jnp.float32)],
        interpret=True)(x))
    held(probes.probe_smem_plain(_T(x), 64 * LANE * 4), want, 0)


def test_mantissa_grid_inputs_match_the_probe(monkeypatch, capsys):
    """``probe_mxu_grid_r4.main`` run with ``jit`` off and ``jnp.dot``
    recorded: the port makes the same grid values and adjacency, and its
    float64 product of them is the exact product the script compares
    against."""
    mod = import_probe("probe_mxu_grid_r4.py")
    seen = []

    def dot(q, A, **kw):
        seen.append((np.asarray(q), np.asarray(A)))
        return jnp.dot(q, A, **kw)

    monkeypatch.setattr(mod, "jnp", SimpleNamespace(
        asarray=jnp.asarray, dot=dot, float32=jnp.float32))
    monkeypatch.setattr(mod, "jax", SimpleNamespace(
        jit=lambda f, **kw: f, lax=jax.lax))
    mod.main()
    assert "EXACT" in capsys.readouterr().err
    v = np.random.default_rng(0).uniform(-1.0, 1.0, (1024, LANE)) \
        .astype(np.float32)
    A = exactness.adjacency()
    assert len(seen) == 2 * len(exactness.GRID_BITS)
    for k, (q, A_seen) in zip(np.repeat(exactness.GRID_BITS, 2), seen):
        q_port = exactness.grid_values(v, k)
        np.testing.assert_array_equal(q_port, q)
        np.testing.assert_array_equal(A, A_seen)
        got = probes.probe_tile_mma_plain(_T(q_port).double(), _T(A).double(),
                                          "f64").numpy()
        np.testing.assert_array_equal(got, q.astype(np.float64)
                                      @ A.astype(np.float64))


def _order_numpy(v0, v1, phi, dmb, G, s2, ak, tile_bits, bits, body, nb, w):
    """``probe_flip_order`` in numpy complex128 by index arithmetic."""
    v0, v1, phi, dmb, G, w = (t.numpy() for t in (v0, v1, phi, dmb, G, w))
    idx = np.arange(v1.size)
    lo = min(bits, tile_bits)
    hi = lo if nb == "none" else bits
    u = v1 + dmb if body == "copy" else dmb * v1
    if body == "full":
        for j in range(lo):
            u = u + G[j] * v1[idx ^ (1 << j)]
    for j in range(lo, hi):
        y = v1[idx ^ (1 << j)] if nb == "xor" else v1
        u = u + (y if body == "copy" else G[j] * y)
    u = u + w
    if body == "copy":
        return v0 + u, phi + (v0 + u)
    out = v0 + 1j * s2 * u
    return out, phi + ak * out


@pytest.mark.parametrize("body", ["copy", "noflips"])
@pytest.mark.parametrize("nb", list(probes.ORDER_NBS))
def test_flip_order_stages_match_numpy(body, nb):
    L, tile_bits, bits = 10, 6, 9
    v0, v1, phi, dmb, G = dd_stages.order_inputs(L, "cpu", seed=1)
    w = v1.flip(0).contiguous()
    want, want_phi = _order_numpy(v0, v1, phi, dmb, G, -0.14, 0.3, tile_bits,
                                  bits, body, nb, w)
    out = probes.probe_flip_order_plain(v0.clone(), v1, phi, dmb, G, -0.14,
                                        0.3, tile_bits, bits, body, nb, w)
    assert np.abs(out.numpy() - want).max() < 1e-14
    assert np.abs(phi.numpy() - want_phi).max() < 1e-14


@pytest.mark.parametrize("tile_bits", [4, 10])
def test_flip_order_full_is_the_order(tile_bits):
    L = 10
    v0, v1, phi, dmb, G = dd_stages.order_inputs(L, "cpu", seed=2)
    want_phi = phi.clone()
    want = cheby_flip_iter_plain(v0.clone(), v1, want_phi, dmb, G, -0.14,
                                 0.3)
    got = probes.probe_flip_order_plain(v0.clone(), v1, phi, dmb, G, -0.14,
                                        0.3, tile_bits, L, "full", "xor")
    assert float((got - want).abs().max()) < 1e-14
    assert float((phi - want_phi).abs().max()) < 1e-14


def test_tf32_round_is_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12],
                     dtype=torch.float32)
    want = [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10), 1.0]
    assert probes.tf32_round(x).tolist() == want


def test_tf32_ties_sit_halfway_between_tf32_values():
    """The tie inputs of the tile-product checks: rounding to nearest with
    ties away moves every one up in magnitude, truncation down."""
    ties = exactness.tf32_ties((16, LANE), seed=4)
    bits = ties.view(np.int32)
    assert np.all((bits & 0x1FFF) == 0x1000)
    up = probes.tf32_round(_T(ties)).numpy().view(np.int32)
    assert np.all(up == (bits & ~0x1FFF) + 0x2000)
    P = _T(exactness.permutation(3))
    got = probes.probe_tile_mma_plain(_T(ties), P, "tf32")
    assert torch.equal(got, probes.tf32_round(_T(ties)) @ P)


def test_tile_mma_modes_name_their_instruction():
    """Each mode names the tensor-core instruction its kernel runs
    (``chip_smoke.py`` phase 16b prints it); on CPU tensors each mode is
    its plain version and launches nothing."""
    assert set(probes.MMA_INSTRUCTIONS) == set(probes.MMA_MODES)
    # TF32 and 3xTF32 run Hopper's warpgroup MMA from the same ring
    for mode in ("tf32", "3xtf32"):
        assert probes.MMA_INSTRUCTIONS[mode].startswith("wgmma.mma_async")
    probes.reset_launches()
    x = _T(planes_np(1, rows=24)[0]).double()
    M = _T(planes_np(1, rows=LANE, seed=3)[0]).double()
    assert torch.equal(probes.probe_tile_mma(x, M, "f64"), x @ M)
    assert not any(probes.LAUNCHES.values())


@pytest.mark.parametrize("mode", ["tf32", "3xtf32", "f64"])
def test_tile_mma_on_cpu_takes_an_offset_plane(mode):
    """Only the card's bulk copies need a 16-byte aligned plane: on the
    CPU a contiguous view one element into its storage is the plain
    product."""
    dtype = torch.float64 if mode == "f64" else torch.float32
    flat = _T(planes_np(1, rows=33)[0]).reshape(-1)[:16 * LANE + 1].to(dtype)
    x = flat[1:].view(16, LANE)
    M = _T(exactness.permutation(2)).to(dtype)
    assert x.data_ptr() % 16
    assert torch.equal(probes.probe_tile_mma(x, M, mode),
                       probes.probe_tile_mma_plain(x.clone(), M, mode))


@pytest.mark.parametrize("variant, tile_bits", [("gather", 12), ("tile", 12),
                                                ("shfl", 12), ("mma", 13)])
def test_flipsum_on_cpu_takes_an_offset_plane(variant, tile_bits):
    """Only the card's float4 loads need a 16-byte aligned plane: on the
    CPU a contiguous view one element into its storage is the plain sum."""
    flat = _T(planes_np(1, rows=129)[0]).reshape(-1)[:(1 << 14) + 1]
    x = flat[1:]
    assert x.data_ptr() % 16
    probes.reset_launches()
    assert torch.equal(probes.probe_flipsum(x, 0, 9, variant, tile_bits),
                       probes.probe_flipsum_plain(x.clone(), 0, 9, variant,
                                                  tile_bits))
    assert not any(probes.LAUNCHES.values())


def test_wrappers_on_cpu_run_the_plain_versions():
    probes.reset_launches()
    xs = [_T(x).reshape(-1) for x in planes_np(3, rows=32)]
    x2, M = xs[0].view(32, LANE), _T(planes_np(1, rows=LANE, seed=3)[0])
    checks = [
        (probes.probe_stream(xs, "triad")[0],
         probes.probe_stream_plain(xs, "triad")[0]),
        (probes.probe_stream_pipelined(xs, chunk=256),
         probes.probe_stream_pipelined_plain(xs, chunk=256)),
        (probes.probe_flipsum(xs[0], 0, 9, "shfl"),
         probes.probe_flipsum_plain(xs[0], 0, 9, "shfl")),
        (probes.probe_tile_mma(x2, M, "3xtf32"),
         probes.probe_tile_mma_plain(x2, M, "3xtf32")),
        (probes.probe_smem(xs[0], 227 * 1024),
         probes.probe_smem_plain(xs[0], 227 * 1024)),
        (probes.probe_xor_permute(xs[0], 3, "shfl"),
         probes.probe_xor_permute_plain(xs[0], 3, "shfl")),
        (probes.probe_extract(xs[0])[0], probes.probe_extract_plain(xs[0])[0]),
        (probes.probe_fma_residual(xs[0], xs[1])[1],
         probes.probe_fma_residual_plain(xs[0], xs[1])[1]),
    ]
    for got, want in checks:
        assert torch.equal(got, want)
    assert not any(probes.LAUNCHES.values())


def test_arguments_are_checked():
    xs = [_T(x).reshape(-1) for x in planes_np(2, rows=32)]
    with pytest.raises(ValueError, match="xor tile distance"):
        probes.probe_stream_plain(xs, "sum", maps=[("self", 0), ("xor", 4)],
                                  tile_bits=10)
    with pytest.raises(ValueError, match="mma variant"):
        probes.probe_flipsum_plain(xs[0], 7, 12, "mma", 11)
    with pytest.raises(ValueError, match="takes 3 planes"):
        probes.probe_stream_plain(xs, "triad")
    with pytest.raises(ValueError, match="shared memory"):
        probes.probe_stream_pipelined_plain(xs * 8, chunk=4096)


@pytest.mark.parametrize("module, argv", [
    (roofline, []), (scatter, ["--manual"]), (flips, []),
    (dd_stages, ["--L", "12"]), (exactness, [])])
def test_entry_points_refuse_without_a_card(monkeypatch, module, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        module.main(argv)
