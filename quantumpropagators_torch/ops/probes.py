"""Measurement kernels: the hand-written CUDA kernels of
``csrc/probes.cu`` (the H100 counterparts of the TPU probes under
``docs/profiling/``) and their plain PyTorch versions.

Each kernel computes, as a function of the flat element index of its
planes, what one Pallas probe body computes (``csrc/probes.cu`` names the
sites).  None of them is on a propagation path: ``profiling/`` times them
to characterise the card.  A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel or raises.
:data:`LAUNCHES` counts kernel launches per instantiation (the plain
versions do not count).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .cheby_flip import _check as _check_flip
from .cheby_flip import _device_kind as _device_of
from .cheby_flip import flip_sum_range_plain

__all__ = [
    "LAUNCHES",
    "MAX_PLANES",
    "REPLACES",
    "SmemRefused",
    "reset_launches",
    "probe_stream",
    "probe_stream_plain",
    "probe_stream_pipelined",
    "probe_stream_pipelined_plain",
    "probe_flipsum",
    "probe_flipsum_plain",
    "tf32_round",
    "probe_tile_mma",
    "probe_tile_mma_plain",
    "probe_smem",
    "probe_smem_plain",
    "probe_flip_order",
    "probe_flip_order_plain",
    "probe_fma_residual",
    "probe_fma_residual_plain",
    "exact_product_residual",
    "fma_outcome",
    "probe_extract",
    "probe_extract_plain",
    "extract_outcome",
    "probe_xor_permute",
    "probe_xor_permute_plain",
]

MAX_PLANES = 16
_MAX_FLIP_BITS = 16
_SMEM_BYTES = 227 * 1024  # shared memory one H100 block may use
_PERM_TILE = 4096         # probe_xor_permute's shared-memory tile
_INVALID = 1              # cudaErrorInvalidValue: a refused size

MAP_KINDS = {"self": 0, "stride": 1, "xor": 2}
STREAM_OPS = {"sum": 0, "triad": 1, "chain": 2}
FLIP_VARIANTS = {"gather": 0, "tile": 1, "shfl": 2, "mma": 3}
MMA_MODES = {"tf32": 0, "3xtf32": 1, "f64": None}
# the tensor-core instruction each mode's kernel runs
MMA_INSTRUCTIONS = {
    "tf32": "wgmma.mma_async.m64n128k8.f32.tf32.tf32",
    "3xtf32": "wgmma.mma_async.m64n128k8.f32.tf32.tf32",
    "f64": "mma.sync.m16n8k16.f64",
}
ORDER_BODIES = {"full": 0, "copy": 1, "noflips": 2}
FMA_VARIANTS = {"inline": 0, "separate": 1, "loaded": 2}
ORDER_NBS = {"xor": 0, "self": 1, "none": 2}
PERMUTE_VARIANTS = {"shfl": 0, "smem": 1}

LAUNCHES = {
    **{f"probe_stream<{op}>": 0 for op in STREAM_OPS},
    "probe_stream_pipelined": 0,
    **{f"probe_flipsum<{v}>": 0 for v in FLIP_VARIANTS},
    **{f"probe_tile_mma<{m}>": 0 for m in MMA_MODES},
    "probe_smem": 0,
    **{f"probe_flip_order<double,{b},{nb}>": 0
       for b in ORDER_BODIES for nb in ORDER_NBS},
    "probe_fma_residual<float>": 0,
    "probe_fma_residual<double>": 0,
    "probe_extract": 0,
    **{f"probe_xor_permute<{v}>": 0 for v in PERMUTE_VARIANTS},
}



def _sites(*sites):
    return ", ".join(f"docs/profiling/{s}" for s in sites)


# The pl.pallas_call sites (file:line) each instantiation replaces, as
# chip_smoke.py's kernels line and tests/test_torch_parity.py read them
REPLACES = {
    "probe_stream<sum>": _sites(
        "scratch_roofline.py:19", "scratch_r3_roofline.py:20",
        "scratch_r3_probe2.py:50", "scratch_r3_probe3.py:44",
        "probe_scatter_r4.py:113"),
    "probe_stream<triad>": _sites("scratch_r3_roofline.py:20"),
    "probe_stream<chain>": _sites("scratch_roofline.py:19",
                                  "scratch_r3_roofline.py:20"),
    "probe_stream_pipelined": _sites("probe_scatter_r4.py:225"),
    "probe_flipsum<gather>": _sites("scratch_flips.py:20"),
    "probe_flipsum<tile>": _sites(
        "scratch_flips.py:20", "scratch_roofline.py:19",
        "scratch_r3_roofline.py:20", "scratch_r3_probe2.py:50"),
    "probe_flipsum<shfl>": _sites("scratch_flips.py:20"),
    "probe_flipsum<mma>": _sites("scratch_flips.py:20"),
    "probe_tile_mma<tf32>": _sites("scratch_roofline.py:59",
                                   "scratch_flips.py:132",
                                   "scratch_r3_probe4.py:50"),
    "probe_tile_mma<3xtf32>": _sites("scratch_flips.py:132",
                                     "scratch_r3_probe4.py:50"),
    "probe_tile_mma<f64>": _sites("scratch_flips.py:132",
                                  "scratch_r3_probe4.py:50"),
    "probe_smem": _sites("scratch_r3_roofline.py:108"),
    **{f"probe_flip_order<double,{b},{nb}>": _sites(
        "scratch_prof_dd.py:95", "scratch_prof2.py:94")
       for b in ORDER_BODIES for nb in ORDER_NBS},
    "probe_fma_residual<float>": _sites("scratch_r3_probe2.py:25",
                                        "scratch_r3_probe3.py:26"),
    "probe_fma_residual<double>": _sites("scratch_r3_probe2.py:25",
                                         "scratch_r3_probe3.py:26"),
    "probe_extract": _sites("scratch_r3_probe4.py:23"),
    **{f"probe_xor_permute<{v}>": _sites("scratch_r3_probe4.py:70")
       for v in PERMUTE_VARIANTS},
}


class SmemRefused(RuntimeError):
    """The card refused a block this much dynamic shared memory."""


class _Planes(ctypes.Structure):
    # csrc/probes.cu: struct Planes
    _fields_ = [("inp", ctypes.c_void_p * MAX_PLANES),
                ("kind", ctypes.c_int * MAX_PLANES),
                ("dist", ctypes.c_int * MAX_PLANES)]


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _f32(value, like):
    return torch.tensor(value, dtype=torch.float32, device=like.device)


# ------------------------------------------------------------------ stream

def _check_planes(inputs, dtype=torch.float32) -> int:
    if not 1 <= len(inputs) <= MAX_PLANES:
        raise ValueError(f"need 1 to {MAX_PLANES} planes, got {len(inputs)}")
    x0 = inputs[0]
    for x in inputs:
        if x.dtype != dtype or not x.is_contiguous():
            raise TypeError(f"planes must be contiguous {dtype}, got "
                            f"{x.dtype}")
        if x.numel() != x0.numel() or x.device != x0.device:
            raise ValueError("planes must share length and device")
    n = x0.numel()
    if n < 4 or n % 4:
        raise ValueError(f"plane length must be a multiple of 4, got {n}")
    return n


def _check_stream(inputs, op, maps, tile_bits, chain, n_out):
    """Validate one ``probe_stream`` call; returns ``(n, maps,
    tile_bits)`` with ``maps`` one ``(kind, dist)`` per input."""
    n = _check_planes(inputs)
    if op not in STREAM_OPS:
        raise ValueError(f"op must be one of {list(STREAM_OPS)}, got {op!r}")
    need = {"triad": 3, "chain": 2}.get(op)
    if need is not None and len(inputs) != need:
        raise ValueError(f"{op} takes {need} planes, got {len(inputs)}")
    if n_out not in (1, 2) or (n_out == 2 and op != "sum"):
        raise ValueError("a second output (s/2) exists only for op='sum'")
    if chain < 0:
        raise ValueError(f"chain must be non-negative, got {chain}")
    maps = [("self", 0)] * len(inputs) if maps is None else list(maps)
    if len(maps) != len(inputs):
        raise ValueError("need one (kind, dist) map per plane")
    if tile_bits is None:
        if any(kind != "self" for kind, _ in maps):
            raise ValueError("tile_bits is needed for stride and xor maps")
        tile_bits = 2
    if not 2 <= tile_bits or n % (1 << tile_bits):
        raise ValueError(f"tiles of 2^{tile_bits} elements must divide the "
                         f"plane of {n}")
    n_tiles = n >> tile_bits
    for kind, dist in maps:
        if kind not in MAP_KINDS:
            raise ValueError(f"map kind must be one of {list(MAP_KINDS)}")
        if dist < 0:
            raise ValueError(f"tile distance {dist} is negative")
        if kind == "xor" and (dist >= n_tiles or n_tiles & (n_tiles - 1)):
            raise ValueError(f"xor tile distance {dist} must stay below a "
                             f"power-of-two tile count ({n_tiles})")
    return n, maps, tile_bits


def _mapped(x, kind, dist, tile_bits):
    """Plane ``x`` read with tile index map ``kind`` (self: tile t; stride:
    tile (t + dist) mod T; xor: tile t ^ dist)."""
    if kind == "self":
        return x
    n_tiles = x.numel() >> tile_bits
    t = torch.arange(n_tiles, device=x.device)
    src = (t + dist) % n_tiles if kind == "stride" else t ^ dist
    return x.reshape(n_tiles, -1).index_select(0, src).reshape(x.shape)


def probe_stream_plain(inputs, op="sum", *, maps=None, tile_bits=None,
                       chain=0, mul=1.0, scale=1.0, n_out=1):
    """Plain PyTorch version of :func:`probe_stream`."""
    _, maps, tile_bits = _check_stream(inputs, op, maps, tile_bits, chain,
                                       n_out)
    ys = [_mapped(x, kind, dist, tile_bits)
          for x, (kind, dist) in zip(inputs, maps)]
    m = _f32(mul, ys[0])
    if op == "sum":
        s = ys[0]
        for y in ys[1:]:
            s = s + y
        t = s
        for _ in range(chain):
            t = t * m + s
        outs = (t * _f32(scale, s),)
        return outs + (s * 0.5,) if n_out == 2 else outs
    if op == "triad":
        return (ys[0] + ys[1] * ys[2],)
    a = ys[0]
    for _ in range(chain):
        a = a * m + ys[1]
    return (a,)


def _planes(inputs, maps) -> _Planes:
    p = _Planes()
    for k, (x, (kind, dist)) in enumerate(zip(inputs, maps)):
        p.inp[k] = x.data_ptr()
        p.kind[k] = MAP_KINDS[kind]
        p.dist[k] = dist
    return p


def probe_stream(inputs, op="sum", *, maps=None, tile_bits=None, chain=0,
                 mul=1.0, scale=1.0, n_out=1):
    """Streaming body over f32 planes of equal length, each read through
    its tile index map (``maps``: one ``(kind, dist)`` per plane, kinds
    ``self``/``stride``/``xor`` over tiles of ``2^tile_bits`` elements):

    - ``sum``: ``s = in_0 + in_1 + ...`` left to right; ``t = s``, then
      ``chain`` times ``t = t·mul + s``; returns ``(t·scale,)`` or, with
      ``n_out=2``, ``(t·scale, s/2)``;
    - ``triad``: ``(in_0 + in_1·in_2,)``;
    - ``chain``: ``a = in_0``, ``chain`` times ``a = a·mul + in_1``;
      ``(a,)``.

    On the card one block covers 256 float4s of every plane, one float4
    of each a thread, with the map kinds fixed at compile time
    (``csrc/probes.cu``).
    """
    if _device_of(inputs[0]) == "cpu":
        return probe_stream_plain(inputs, op, maps=maps, tile_bits=tile_bits,
                                  chain=chain, mul=mul, scale=scale,
                                  n_out=n_out)
    n, maps, tile_bits = _check_stream(inputs, op, maps, tile_bits, chain,
                                       n_out)
    outs = tuple(torch.empty_like(inputs[0]) for _ in range(n_out))
    planes = _planes(inputs, maps)
    _cuda.launch("probe_stream", (
        ctypes.addressof(planes), outs[0].data_ptr(),
        outs[1].data_ptr() if n_out == 2 else None, STREAM_OPS[op],
        len(inputs), n, tile_bits, chain, mul, scale), inputs[0].device)
    LAUNCHES[f"probe_stream<{op}>"] += 1
    return outs


def _check_pipelined(inputs, chunk, chain):
    n = _check_planes(inputs)
    if chunk < 4 or chunk % 4 or n % chunk:
        raise ValueError(f"chunk {chunk} must be a multiple of 4 dividing "
                         f"the plane of {n}")
    if 2 * len(inputs) * chunk * 4 > _SMEM_BYTES:
        raise ValueError(f"two stages of {len(inputs)} x {chunk} floats "
                         f"exceed {_SMEM_BYTES} bytes of shared memory")
    if chain < 0:
        raise ValueError(f"chain must be non-negative, got {chain}")
    return n


def probe_stream_pipelined_plain(inputs, *, chain=0, mul=1.0, chunk=1024):
    """Plain PyTorch version of :func:`probe_stream_pipelined`."""
    _check_pipelined(inputs, chunk, chain)
    return probe_stream_plain(inputs, "sum", chain=chain, mul=mul)[0]


def probe_stream_pipelined(inputs, *, chain=0, mul=1.0, chunk=1024):
    """``probe_stream(inputs, "sum", chain=, mul=)[0]`` through a
    two-stage ``cp.async`` ring of ``chunk`` elements a plane in shared
    memory, one persistent block per slot the card holds."""
    if _device_of(inputs[0]) == "cpu":
        return probe_stream_pipelined_plain(inputs, chain=chain, mul=mul,
                                            chunk=chunk)
    n = _check_pipelined(inputs, chunk, chain)
    out = torch.empty_like(inputs[0])
    planes = _planes(inputs, [("self", 0)] * len(inputs))
    _cuda.launch("probe_stream_pipelined", (
        ctypes.addressof(planes), out.data_ptr(), len(inputs), n, chunk,
        chain, mul), out.device)
    LAUNCHES["probe_stream_pipelined"] += 1
    return out


# ------------------------------------------------------------------- flips

def _check_flipsum(x, lo, hi, variant, tile_bits) -> int:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"x must be a contiguous float32 plane, got {x.dtype}")
    n = x.numel()
    if n < 1 or n & (n - 1):
        raise ValueError(f"plane length must be a power of two, got {n}")
    if not 0 <= lo <= hi or hi - lo > _MAX_FLIP_BITS or (1 << hi) > n:
        raise ValueError(f"bits [{lo}, {hi}) must lie below log2({n}) and "
                         f"number at most {_MAX_FLIP_BITS}")
    if variant not in FLIP_VARIANTS:
        raise ValueError(f"variant must be one of {list(FLIP_VARIANTS)}")
    if variant != "gather":
        smem = (2 if variant == "mma" else 1) * (4 << tile_bits)
        if tile_bits < 8 or (1 << tile_bits) > n or smem > _SMEM_BYTES:
            raise ValueError(f"tile of 2^{tile_bits} elements: needs 2^8 "
                             f"to the plane, in {_SMEM_BYTES} bytes")
    if variant == "mma" and (tile_bits < 11 or lo != 0 or hi < 7):
        raise ValueError("the mma variant sums bits 0-6 on the tensor cores: "
                         "needs lo = 0, hi >= 7 and tiles of 16 rows")
    return n


def probe_flipsum_plain(x, lo, hi, variant="tile", tile_bits=12):
    """Plain PyTorch version of :func:`probe_flipsum` (every variant)."""
    _check_flipsum(x, lo, hi, variant, tile_bits)
    out = x.clone()
    for j in range(lo, hi):
        out += x.reshape(-1, 2, 1 << j).flip(1).reshape(x.shape)
    return out


def probe_flipsum(x, lo, hi, variant="tile", tile_bits=12):
    """``x[i] + Σ_{lo ≤ j < hi} x[i ^ 2^j]`` over a float32 plane of
    ``2^L`` elements, the terms in ascending ``j``, by ``variant``:
    ``gather`` (partners from global memory), ``tile`` (tiles of
    ``2^tile_bits`` elements in shared memory, partners above from global
    memory), ``shfl`` (bits 0-1 inside a thread's float4, bits 2-6 by warp
    shuffles, then as ``tile``) or ``mma`` (bits 0-6 as a 0/1 product on
    the tensor cores in two TF32 passes, then as ``tile``; sums in another
    order).  On the card every variant reads and writes float4s (``tile``,
    ``shfl`` and ``mma`` load by TMA bulk copies), so the plane must start
    16-byte aligned and hold at least 4 elements."""
    if _device_of(x) == "cpu":
        return probe_flipsum_plain(x, lo, hi, variant, tile_bits)
    n = _check_flipsum(x, lo, hi, variant, tile_bits)
    if x.data_ptr() % 16 or n < 4:
        raise ValueError(f"{variant} reads the plane as float4s, which need "
                         f"a plane of 4 or more elements that starts 16-byte "
                         f"aligned")
    out = torch.empty_like(x)
    _cuda.launch("probe_flipsum", (x.data_ptr(), out.data_ptr(),
                                   FLIP_VARIANTS[variant], n, lo, hi,
                                   tile_bits), x.device)
    LAUNCHES[f"probe_flipsum<{variant}>"] += 1
    return out


# ---------------------------------------------------------------- tile MMA

def tf32_round(x):
    """``x`` rounded to TF32 (10 fraction bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``; float32 out."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).reshape(x.shape)


def _check_mma(x, M, mode):
    if mode not in MMA_MODES:
        raise ValueError(f"mode must be one of {list(MMA_MODES)}")
    dtype = torch.float64 if mode == "f64" else torch.float32
    rows = 8 if mode == "f64" else 16
    for t in (x, M):
        if t.dtype != dtype or not t.is_contiguous():
            raise TypeError(f"{mode} takes contiguous {dtype} operands")
    if x.dim() != 2 or x.shape[1] != 128 or x.shape[0] % rows \
            or tuple(M.shape) != (128, 128) or x.device != M.device:
        raise ValueError(f"need x of shape (R, 128), R a multiple of {rows}, "
                         f"and M of (128, 128) on one device")


def probe_tile_mma_plain(x, M, mode="tf32"):
    """Plain PyTorch version of :func:`probe_tile_mma`: the operands
    rounded (and split) as the kernel does, the products summed in
    float64, the result rounded once."""
    _check_mma(x, M, mode)
    if mode == "f64":
        return x @ M
    xh, mh = tf32_round(x), tf32_round(M)
    out = xh.double() @ mh.double()
    if mode == "3xtf32":
        xl, ml = tf32_round(x - xh), tf32_round(M - mh)
        out = xl.double() @ mh.double() + xh.double() @ ml.double() + out
    return out.float()


def probe_tile_mma(x, M, mode="tf32"):
    """``x @ M`` for an ``(R, 128)`` plane and a ``(128, 128)`` matrix on
    the tensor cores: ``tf32`` (float32 operands rounded to TF32, one
    ``wgmma`` pass), ``3xtf32`` (each operand split hi + lo: lo·Mhi +
    hi·Mlo + hi·Mhi, three ``wgmma`` passes) or ``f64`` (float64,
    ``mma.sync.m16n8k16``); :data:`MMA_INSTRUCTIONS` names each.

    The kernels replace the Pallas bodies of ``scratch_roofline.py:59``,
    ``scratch_flips.py:132`` and ``scratch_r3_probe4.py:50``.  At (2^19,
    128) f32 and (2^18, 128) f64 they are bound by bytes (x read and out
    written once: 0.1603 ms at 3.35 TB/s), with the FP64 operations
    (2^33 at 67 TFLOP/s, 0.128 ms) and 3xTF32's three passes (3·2^34 at
    495 TFLOP/s, 0.104 ms) close behind.  So each persistent block (one
    an SM) reads M once into shared memory (3xTF32: its hi and lo parts,
    128 KB), in the layout its MMA reads, and streams x through a ring of
    three stages of TMA bulk copies, so that the loads run under the MMAs
    and the stores; ``csrc/probes.cu`` gives the layouts."""
    if _device_of(x) == "cpu":
        return probe_tile_mma_plain(x, M, mode)
    _check_mma(x, M, mode)
    if x.data_ptr() % 16:
        raise ValueError(f"{mode} streams x through TMA bulk copies, which "
                         f"need a plane that starts 16-byte aligned")
    out = torch.empty_like(x)
    if mode == "f64":
        _cuda.launch("probe_tile_mma_f64", (x.data_ptr(), M.data_ptr(),
                                            out.data_ptr(), x.shape[0]),
                     x.device)
    else:
        _cuda.launch("probe_tile_mma_f32", (x.data_ptr(), M.data_ptr(),
                                            out.data_ptr(), MMA_MODES[mode],
                                            x.shape[0]), x.device)
    LAUNCHES[f"probe_tile_mma<{mode}>"] += 1
    return out


# ----------------------------------------------------------- shared memory

def _check_smem(x, n_bytes):
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() < 1:
        raise TypeError("x must be a non-empty contiguous float32 tensor")
    if n_bytes < 4 * x.numel():
        raise ValueError(f"{n_bytes} bytes cannot hold {x.numel()} floats")


def probe_smem_plain(x, n_bytes):
    """Plain PyTorch version of :func:`probe_smem`."""
    _check_smem(x, n_bytes)
    return x * 2.0


def probe_smem(x, n_bytes):
    """``2·x`` through one block given ``n_bytes`` of dynamic shared
    memory (``x`` staged at its top).  Raises :class:`SmemRefused`, and
    launches nothing, when the card refuses that size."""
    if _device_of(x) == "cpu":
        return probe_smem_plain(x, n_bytes)
    _check_smem(x, n_bytes)
    out = torch.empty_like(x)
    rc = _cuda.launch("probe_smem", (x.data_ptr(), out.data_ptr(), x.numel(),
                                     n_bytes), x.device, accept=(_INVALID,))
    if rc:
        raise SmemRefused(f"{n_bytes} bytes of dynamic shared memory refused "
                          f"(CUDA error {rc})")
    LAUNCHES["probe_smem"] += 1
    return out


# -------------------------------------------------------------- flip order

def _check_order(v0, v1, phi, dmb, G, tile_bits, bits, body, nb, w):
    if v0.dtype != torch.complex128 or v0.dim() != 1:
        raise TypeError("the flip-order probe takes flat complex128 states")
    L = _check_flip([v0, v1, phi] + ([w] if w is not None else []),
                    dmb, G)
    if body not in ORDER_BODIES or nb not in ORDER_NBS:
        raise ValueError(f"body must be one of {list(ORDER_BODIES)} and nb "
                         f"one of {list(ORDER_NBS)}")
    if not 0 <= bits <= L or not 0 <= tile_bits <= L \
            or (16 << tile_bits) > _SMEM_BYTES:
        raise ValueError(f"bits {bits} and tile_bits {tile_bits} must lie in "
                         f"[0, {L}] with the tile in shared memory")
    return L


def probe_flip_order_plain(v0, v1, phi, dmb, G, s2, ak, tile_bits, bits,
                           body="full", nb="xor", w=None):
    """Plain PyTorch version of :func:`probe_flip_order`."""
    _check_order(v0, v1, phi, dmb, G, tile_bits, bits, body, nb, w)
    lo = min(bits, tile_bits)
    hi = lo if nb == "none" else bits
    d = dmb.view(v1.shape)
    u = v1 + d if body == "copy" else d * v1
    if body == "full":
        u = u + flip_sum_range_plain(v1, G, 0, lo)
    for j in range(lo, hi):
        y = v1.view(-1, 2, 1 << j).flip(1).reshape(v1.shape) \
            if nb == "xor" else v1
        u = u + (y if body == "copy" else G[j] * y)
    if w is not None:
        u = u + w.view(v1.shape)
    r = v0 + u if body == "copy" else v0 + (1j * s2) * u
    phi.add_(r, alpha=1.0 if body == "copy" else ak)
    v0.copy_(r)
    return v0


def probe_flip_order(v0, v1, phi, dmb, G, s2, ak, tile_bits, bits,
                     body="full", nb="xor", w=None):
    """The flip order's tiled pass (``cheby_flip_iter_low`` over bits
    ``< bits`` of a flat complex128 ``2^L`` state, tiles of
    ``2^tile_bits``) with its parts taken apart:

    - ``body="full"``: the order, ``out = v0 + i·s2·(dmb·v1 + Σ_j G_j
      v1[nb_j(i)] + w)``, ``Φ += ak·out``;
    - ``"noflips"``: the same without the terms of bits below
      ``tile_bits``;
    - ``"copy"``: ``out = v0 + v1 + dmb + Σ_{tile_bits ≤ j < bits}
      v1[nb_j(i)] + w``, ``Φ += out``: the same streams, summed;

    with ``nb_j(i) = i ^ 2^j`` (``"xor"``), ``i`` (``"self"``), or no
    term for bits at and above ``tile_bits`` (``"none"``).  ``out`` is
    written into ``v0``'s buffer."""
    if _device_of(v0) == "cpu":
        return probe_flip_order_plain(v0, v1, phi, dmb, G, s2, ak, tile_bits,
                                      bits, body, nb, w)
    L = _check_order(v0, v1, phi, dmb, G, tile_bits, bits, body, nb, w)
    _cuda.launch("probe_flip_order_f64", (
        v0.data_ptr(), v0.data_ptr(), v1.data_ptr(), phi.data_ptr(),
        dmb.data_ptr(), G.data_ptr(), None if w is None else w.data_ptr(),
        ORDER_BODIES[body], ORDER_NBS[nb], L, v0.numel(), tile_bits, bits,
        s2, ak), v0.device)
    LAUNCHES[f"probe_flip_order<double,{body},{nb}>"] += 1
    return v0


# --------------------------------------------------------------- exactness

_CTYPE = {torch.float32: ("float", "f32"), torch.float64: ("double", "f64")}


def _check_pair(a, b):
    if a.dtype not in _CTYPE or b.dtype != a.dtype or a.shape != b.shape \
            or a.device != b.device or not (a.is_contiguous()
                                            and b.is_contiguous()):
        raise TypeError("a and b must be contiguous float32 or float64 "
                        "tensors of one shape on one device")


def _check_fma(a, b, variant):
    _check_pair(a, b)
    if variant not in FMA_VARIANTS:
        raise ValueError(f"variant must be one of {list(FMA_VARIANTS)}")


def probe_fma_residual_plain(a, b, variant="inline"):
    """Plain PyTorch version of :func:`probe_fma_residual`: PyTorch rounds
    every operation, so ``r`` is 0 whatever the variant."""
    _check_fma(a, b, variant)
    p = a * b
    return p, a * b - p


def probe_fma_residual(a, b, variant="inline"):
    """``p = a·b``, ``r = a·b − p`` as the library's flags compile it:

    - ``"inline"``, the TPU probe's body: ``r`` is the exact residual if
      the compiler contracts ``a·b − p`` into one FMA, and 0 if it rounds
      apart or evaluates ``a·b`` once and subtracts it from itself;
    - ``"loaded"``: ``a``, ``b`` and ``p`` are read back through volatile
      loads, so the second ``a·b`` is a product of its own and ``r``
      reads the contraction alone;
    - ``"separate"``: every operation rounded on its own
      (``__fmul_rn``/``__fsub_rn``), ``r = 0``."""
    if _device_of(a) == "cpu":
        return probe_fma_residual_plain(a, b, variant)
    _check_fma(a, b, variant)
    p, r = torch.empty_like(a), torch.empty_like(a)
    ctype, suffix = _CTYPE[a.dtype]
    _cuda.launch(f"probe_fma_residual_{suffix}", (
        a.data_ptr(), b.data_ptr(), p.data_ptr(), r.data_ptr(),
        FMA_VARIANTS[variant], a.numel()), a.device)
    LAUNCHES[f"probe_fma_residual<{ctype}>"] += 1
    return p, r


def exact_product_residual(a, b):
    """``a·b − fl(a·b)`` exactly: through float64 for float32 operands,
    by Dekker's product (Veltkamp splits) for float64."""
    if a.dtype == torch.float32:
        p = (a * b).double()
        return (a.double() * b.double() - p).float()
    split = 134217729.0  # 2^27 + 1
    p = a * b
    t = split * a
    ah = t - (t - a)
    al = a - ah
    t = split * b
    bh = t - (t - b)
    bl = b - bh
    return ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma_outcome(a, b, p, r) -> str:
    """The FMA probe's reading (``scratch_r3_probe2.py``): ``"FUSED"``
    when ``r`` is the exact residual of ``p = fl(a·b)`` and not all zero,
    ``"separate"`` when ``r`` is all zero, else ``"OTHER"``."""
    if not torch.equal(p, a * b):
        return "OTHER"
    if torch.equal(r, exact_product_residual(a, b)) and bool(r.ne(0).any()):
        return "FUSED"
    return "separate" if not bool(r.ne(0).any()) else "OTHER"


def _check_extract(x):
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() < 1:
        raise TypeError("x must be a non-empty contiguous float32 tensor")


def probe_extract_plain(x):
    """Plain PyTorch version of :func:`probe_extract`."""
    _check_extract(x)
    sigma = x.abs().max() * 64.0
    q = (sigma + x) - sigma
    return q, x - q


def probe_extract(x):
    """σ-extraction in one block: ``σ = 64·max|x|``, ``q = (σ + x) − σ``,
    ``r = x − q``; returns ``(q, r)``."""
    if _device_of(x) == "cpu":
        return probe_extract_plain(x)
    _check_extract(x)
    q, r = torch.empty_like(x), torch.empty_like(x)
    _cuda.launch("probe_extract", (x.data_ptr(), q.data_ptr(), r.data_ptr(),
                                   x.numel()), x.device)
    LAUNCHES["probe_extract"] += 1
    return q, r


def extract_outcome(x, q) -> str:
    """The σ-extraction probe's reading (``scratch_r3_probe4.py``):
    ``"kept"`` when ``q`` is the strict float32 ``(σ + x) − σ``,
    ``"FOLDED"`` when ``q == x``, else ``"OTHER"``."""
    want, _ = probe_extract_plain(x.cpu())
    if torch.equal(q.cpu(), want):
        return "kept"
    return "FOLDED" if torch.equal(q, x) else "OTHER"


def _check_permute(x, bit, variant):
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("x must be a contiguous float32 tensor")
    if variant not in PERMUTE_VARIANTS:
        raise ValueError(f"variant must be one of {list(PERMUTE_VARIANTS)}")
    limit, block = (5, 32) if variant == "shfl" else (
        _PERM_TILE.bit_length() - 1, _PERM_TILE)
    if not 0 <= bit < limit or x.numel() < block or x.numel() % block:
        raise ValueError(f"{variant}: bit must be below {limit} and the "
                         f"length a multiple of {block}")


def probe_xor_permute_plain(x, bit, variant="smem"):
    """Plain PyTorch version of :func:`probe_xor_permute`."""
    _check_permute(x, bit, variant)
    return x.reshape(-1, 2, 1 << bit).flip(1).reshape(x.shape)


def probe_xor_permute(x, bit, variant="smem"):
    """``out[i] = x[i ^ 2^bit]`` by warp shuffles (``"shfl"``, bit < 5)
    or through a shared-memory tile of 4096 elements (``"smem"``)."""
    if _device_of(x) == "cpu":
        return probe_xor_permute_plain(x, bit, variant)
    _check_permute(x, bit, variant)
    out = torch.empty_like(x)
    _cuda.launch("probe_xor_permute", (x.data_ptr(), out.data_ptr(),
                                       PERMUTE_VARIANTS[variant], x.numel(),
                                       bit), x.device)
    LAUNCHES[f"probe_xor_permute<{variant}>"] += 1
    return out
