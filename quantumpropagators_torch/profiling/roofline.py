"""Element rates of streaming bodies on the card: the port of
``docs/profiling/scratch_roofline.py``, ``scratch_r3_roofline.py``,
``scratch_r3_probe2.py`` (its copy / add / 7-input sum and row flips)
and ``scratch_r3_probe3.py``.

    python -m quantumpropagators_torch.profiling.roofline [--reps N]

Each body runs on float32 planes of two sizes: ``l2``, the TPU probes'
(2^15, 128) planes of 16 MB (two or three of them fit in the H100's 50 MB
L2, so these rates read the cache as much as device memory), and
``hbm``, planes of 2^26 elements (256 MB, the size of a 2^24 complex128
state), whose rates are the ones to read against device-memory bounds.
Bodies: copy, copy·1.0000001, add, triad ``x + y·z``, the 7-input sum,
16- and 64-long chains ``a = a·1.0000001 + b``; the flip sums of index
bits 0-11 (``roll12``) and 7-16 (``flips10``); the (R, 128) × (128, 128)
tile product in TF32; and the largest dynamic shared memory one block
is given.  Library calls that compute the same function are timed
beside their kernels: ``Tensor.copy_``, ``torch.add``,
``torch.addcmul``, ``torch.matmul`` with TF32 on and off.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import probes
from . import HBM_BYTES_S, card_line, cuda_device, planes, time_ms

SHAPES = {"l2": 1 << 22, "hbm": 1 << 26}
# name: (op, planes read, chain, mul, scale)
STREAM_CASES = {
    "copy": ("sum", 1, 0, 1.0, 1.0),
    "copy*1.0000001": ("sum", 1, 0, 1.0, 1.0000001),
    "add": ("sum", 2, 0, 1.0, 1.0),
    "triad": ("triad", 3, 0, 1.0, 1.0),
    "sum7": ("sum", 7, 0, 1.0, 1.0),
    "fma16": ("chain", 2, 16, 1.0000001, 1.0),
    "fma64": ("chain", 2, 64, 1.0000001, 1.0),
}
# name: (lo, hi) flip bits, summed from a shared-memory tile of 2^12
FLIP_CASES = {"roll12": (0, 12), "flips10": (7, 17)}
FLIP_TILE_BITS = 12
SMEM_KB = (16, 32, 48, 64, 96, 128, 160, 192, 224, 227, 228)


def stream_case(name, xs, reps):
    """Kernel ms of one ``STREAM_CASES`` body on planes ``xs`` (and the
    library call's, where one computes it)."""
    op, n_in, chain, mul, scale = STREAM_CASES[name]
    ins = xs[:n_in]
    ms = time_ms(lambda: probes.probe_stream(ins, op, chain=chain, mul=mul,
                                             scale=scale), reps)
    out = torch.empty_like(xs[0])
    library = {
        "copy": lambda: out.copy_(xs[0]),
        "add": lambda: torch.add(xs[0], xs[1], out=out),
        "triad": lambda: torch.addcmul(xs[0], xs[1], xs[2], out=out),
    }.get(name)
    lib_ms = None if library is None else time_ms(library, reps)
    return ms, lib_ms


def matmul_case(x, M, reps):
    """Kernel ms of the TF32 tile product and of ``torch.matmul`` with
    TF32 on and off."""
    ms = time_ms(lambda: probes.probe_tile_mma(x, M, "tf32"), reps)
    out = torch.empty_like(x)
    lib = {}
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            lib[tf32] = time_ms(lambda: torch.matmul(x, M, out=out), reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return ms, lib[True], lib[False]


def smem_limit(device):
    """Launches one block with each of ``SMEM_KB`` kilobytes of dynamic
    shared memory; returns ``{kb: True (launched, output right) | False
    (refused)}``."""
    x = planes(4096, 1, device, seed=0)[0]
    result = {}
    for kb in SMEM_KB:
        try:
            out = probes.probe_smem(x, kb * 1024)
        except probes.SmemRefused:
            result[kb] = False
            continue
        if not torch.equal(out, x * 2.0):
            raise AssertionError(f"probe_smem at {kb} KB returned a wrong "
                                 f"result")
        result[kb] = True
    return result


def run(device, reps=30, seed=0, log=print):
    """Every body at every shape; returns ``{"stream": {shape: {case:
    {...}}}, "flips": ..., "matmul": ..., "smem": {kb: launched}}``."""
    card = card_line()
    res = {"card": card, "stream": {}, "flips": {}, "matmul": {}}
    for shape, n in SHAPES.items():
        xs = planes(n, 7, device, seed)
        plane_gb = 4 * n / 1e9
        res["stream"][shape] = rows = {}
        for name, (_, n_in, *_rest) in STREAM_CASES.items():
            ms, lib_ms = stream_case(name, xs, reps)
            gbs = (n_in + 1) * plane_gb / ms * 1e3
            rows[name] = {"ms": ms, "GB/s": gbs, "Gelem/s": n / ms / 1e6,
                          "library_ms": lib_ms}
            lib = "" if lib_ms is None else f"; library {lib_ms:.4f} ms"
            log(f"roofline {shape} 2^{n.bit_length() - 1} {name:15s}: "
                f"{ms:.4f} ms {gbs:7.1f} GB/s ({n_in + 1} planes, "
                f"{100 * gbs * 1e9 / HBM_BYTES_S:.1f} % of 3.35 TB/s) "
                f"{n / ms / 1e6:7.1f} Gelem/s{lib} [{card}]")
        res["flips"][shape] = flips = {}
        for name, (lo, hi) in FLIP_CASES.items():
            ms = time_ms(lambda: probes.probe_flipsum(
                xs[0], lo, hi, "tile", FLIP_TILE_BITS), reps)
            flips[name] = {"ms": ms, "Gelem/s": n / ms / 1e6,
                           "GB/s": 2 * plane_gb / ms * 1e3}
            log(f"roofline {shape} 2^{n.bit_length() - 1} {name:15s}: "
                f"{ms:.4f} ms {n / ms / 1e6:7.1f} Gelem/s "
                f"({n * (hi - lo) / ms / 1e6:.0f} G flip terms/s, "
                f"{2 * plane_gb / ms * 1e3:.1f} GB/s) [{card}]")
        x = xs[0].view(-1, 128)
        M = xs[1][:128 * 128].view(128, 128).contiguous()
        ms, tf32_ms, f32_ms = matmul_case(x, M, reps)
        res["matmul"][shape] = {"ms": ms, "library_tf32_ms": tf32_ms,
                                "library_f32_ms": f32_ms}
        log(f"roofline {shape} ({x.shape[0]}, 128) x (128, 128) tf32 "
            f"product: {ms:.4f} ms ({2 * plane_gb / ms * 1e3:.1f} GB/s, "
            f"{2 * n * 128 / ms / 1e9:.1f} TFLOP/s); torch.matmul tf32 "
            f"{tf32_ms:.4f} ms, f32 {f32_ms:.4f} ms [{card}]")
        del xs, x, M
    res["smem"] = smem = smem_limit(device)
    launched = [kb for kb, ok in smem.items() if ok]
    refused = [kb for kb, ok in smem.items() if not ok]
    log(f"roofline shared memory of one block: largest launched "
        f"{max(launched) if launched else None} KB, refused {refused} KB "
        f"[{card}]")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    return run(cuda_device(), args.reps)


if __name__ == "__main__":
    main()
