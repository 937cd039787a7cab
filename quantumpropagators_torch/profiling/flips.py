"""Which flip formulation is cheapest on the card?  The port of
``docs/profiling/scratch_flips.py``.

    python -m quantumpropagators_torch.profiling.flips [--reps N]

The 9-bit flip sum ``x[i] + Σ_{j<9} x[i ^ 2^j]`` of one float32 plane
(index bits 0-6 are the TPU's lanes, 7-8 its rows) by each Hopper
formulation of ``probe_flipsum``: ``gather`` (partners from global
memory through L1/L2), ``tile`` (a shared-memory tile, as the flip
order's tiled pass), ``shfl`` (warp shuffles for bits 0-4, the tile
above) and ``mma`` (bits 0-6 as a 0/1 (128, 128) product on the tensor
cores, two TF32 passes, the tile above).  Plane sizes: ``l2``, the
script's (2^13, 128) = 2^20 elements (4 MB, L2-resident), and ``hbm``,
2^26 elements.  Then the script's exactness probe: one (512, 128) tile
times a permutation and times the 7-bit adjacency on the tensor cores
(:func:`.exactness.permutation_products`).
"""

from __future__ import annotations

import argparse

from ..ops import probes
from . import HBM_BYTES_S, card_line, cuda_device, planes, time_ms
from .exactness import permutation_products

SHAPES = {"l2": 1 << 20, "hbm": 1 << 26}
BITS = (0, 9)
# formulation: tile bits (the mma variant needs tiles of 16 rows; its
# kernel stages 64 rows, 2^13 elements, whatever the tile)
VARIANTS = {"gather": 12, "tile": 12, "shfl": 12, "mma": 13}


def run(device, reps=30, seed=0, log=print):
    """Each formulation at each shape, then the permutation products;
    returns ``{"flipsum": {shape: {variant: {"ms", "GB/s"}}},
    "exactness": ...}``."""
    card = card_line()
    res = {"card": card, "flipsum": {}}
    lo, hi = BITS
    for shape, n in SHAPES.items():
        (x,) = planes(n, 1, device, seed)
        res["flipsum"][shape] = rows = {}
        for variant, tile_bits in VARIANTS.items():
            ms = time_ms(lambda: probes.probe_flipsum(x, lo, hi, variant,
                                                      tile_bits), reps)
            gbs = 8 * n / ms / 1e6
            rows[variant] = {"ms": ms, "GB/s": gbs}
            log(f"flips {shape} 2^{n.bit_length() - 1} 9-bit flip sum "
                f"{variant:6s}: {ms:.4f} ms/iter {gbs:7.1f} GB/s (2 planes, "
                f"{100 * gbs * 1e9 / HBM_BYTES_S:.1f} % of 3.35 TB/s) "
                f"{n / ms / 1e6:7.1f} Gelem/s [{card}]")
    res["exactness"] = permutation_products(device, seed, log=log)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    return run(cuda_device(), args.reps)


if __name__ == "__main__":
    main()
