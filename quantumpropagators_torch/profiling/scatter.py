"""Does reading partner planes at XOR-scattered tiles cost anything on the
card?  The port of ``docs/profiling/probe_scatter_r4.py``.

    python -m quantumpropagators_torch.profiling.scatter [--L 22]
        [--tile-rows 1024] [--reps 30] [--flops 0 [400 ...]] [--manual]

Sixteen float32 planes of ``2^L`` elements in, a running sum (plus
``--flops`` operations an element as an FMA chain, the flip order's
arithmetic load) and two planes out, tiles of ``tile_rows × 128``
elements.  Three read patterns with the same bytes:

- ``seq``: every plane read at its own tile;
- ``stride``: 7 of the 16 read at tile ``(t + 2^j) mod T``;
- ``xor``: 7 of the 16 read at tile ``t ^ 2^j``, the flip kernels'
  partner pattern (``j`` cycles over the tile-index bits, so every index
  stays below the tile count).

``--manual`` runs the same sum (one plane out) through a two-stage
``cp.async`` ring in shared memory (1024 elements a plane a stage,
persistent blocks), the port of the script's explicitly
double-buffered DMA variant.
"""

from __future__ import annotations

import argparse

from ..ops import probes
from . import HBM_BYTES_S, card_line, cuda_device, planes, time_ms

LANE = 128
N_IN = 16
N_MAPPED = 7
MODES = ("seq", "stride", "xor")


def maps(mode: str, n_tiles: int):
    """One ``(kind, dist)`` a plane: the last ``N_MAPPED`` planes read at
    ``(t + 2^j) mod T`` (stride) or ``t ^ 2^j`` (xor), ``j`` cycling over
    the ``log2(T)`` tile-index bits."""
    if mode == "seq":
        return [("self", 0)] * N_IN
    n_bits = max(1, n_tiles.bit_length() - 1)
    kind = "stride" if mode == "stride" else "xor"
    return [("self", 0)] * (N_IN - N_MAPPED) + [
        (kind, 1 << (j % n_bits)) for j in range(N_MAPPED)]


def chain_of(flops: int) -> int:
    """FMA links a ``--flops`` count runs: two operations each."""
    return flops // 2


def run(device, L=22, tile_rows=1024, reps=30, flops=(0,), manual=False,
        seed=0, log=print):
    """Rates of the three read patterns (or, with ``manual``, of the
    pipelined sum) for each ``flops``; returns ``{flops: {mode: {"ms",
    "GB/s"}}}``."""
    card = card_line()
    n = 1 << L
    tile_bits = (tile_rows * LANE).bit_length() - 1
    if tile_rows * LANE != 1 << tile_bits or n % (1 << tile_bits):
        raise ValueError(f"tiles of {tile_rows} rows must be a power of two "
                         f"dividing 2^{L} / {LANE} rows")
    n_tiles = n >> tile_bits
    xs = planes(n, N_IN, device, seed, scale=1e-3)
    res = {"card": card}
    for f in flops:
        res[f] = rows = {}
        if manual:
            n_planes = N_IN + 1
            ms = time_ms(lambda: probes.probe_stream_pipelined(
                xs, chain=chain_of(f), mul=0.9999), reps)
            cases = {"manual": ms}
        else:
            n_planes = N_IN + 2
            cases = {}
            for mode in MODES:
                m = maps(mode, n_tiles)
                cases[mode] = time_ms(lambda: probes.probe_stream(
                    xs, "sum", maps=m, tile_bits=tile_bits,
                    chain=chain_of(f), mul=0.9999, n_out=2), reps)
        for mode, ms in cases.items():
            gbs = n_planes * 4 * n / ms / 1e6
            rows[mode] = {"ms": ms, "GB/s": gbs}
            log(f"scatter L={L} tiles of {tile_rows} rows, flops={f} "
                f"{mode:7s}: {gbs:7.1f} GB/s ({ms:.4f} ms/invocation, "
                f"{n_planes} planes of {4 * n / 2 ** 20:.0f} MiB, "
                f"{100 * gbs * 1e9 / HBM_BYTES_S:.1f} % of 3.35 TB/s) "
                f"[{card}]")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--L", type=int, default=22)
    ap.add_argument("--tile-rows", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--flops", type=int, nargs="+", default=[0],
                    help="extra operations per element inside the kernel "
                         "(the flip order runs ~400 a element and order)")
    ap.add_argument("--manual", action="store_true",
                    help="the cp.async-ring variant instead of the three "
                         "read patterns")
    args = ap.parse_args(argv)
    return run(cuda_device(), args.L, args.tile_rows, args.reps, args.flops,
               args.manual)


if __name__ == "__main__":
    main()
