"""Where the reference-accuracy flip order's time goes: the port of
``docs/profiling/scratch_prof_dd.py`` and ``scratch_prof2.py``.

    python -m quantumpropagators_torch.profiling.dd_stages [--L 20]
        [--reps 30]

The TPU scripts timed the Pallas dd kernel's cross-tile pass and its
order pass alone, and the order's traffic floor, flips and arithmetic
apart.  Their kernels are gone from the JAX package; this module asks
the same questions of the port's order at ``2^L`` (complex128), split
as the main path splits it (``ops/cheby_flip.py:flip_split``):

- the high pass ``cheby_flip_high<double>`` alone (the top ``h`` bits,
  the TPU's cross-tile pass);
- the production tiled pass ``cheby_flip_iter_low`` (bits below
  ``L − h``, the high pass's output as its ``w``);
- ``probe_flip_order`` (a copy of that pass) with body ``full`` (the
  order), ``noflips`` (without its in-tile flip sum) and ``copy`` (the
  same streams summed, no arithmetic), each with the partners above the
  tile read at ``i ^ 2^j`` (``xor``), at ``i`` (``self``) or not at all
  (``none``).

Every tiled case moves the same bytes: it reads ``v0``, ``v1``, ``Φ``,
``dmb`` and ``w`` and writes the order and ``Φ`` (104 B an element).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import cheby_flip as cf
from ..ops import probes
from . import HBM_BYTES_S, card_line, cuda_device, time_ms

BODIES = tuple(probes.ORDER_BODIES)
NBS = tuple(probes.ORDER_NBS)
S2, AK = -0.14, 0.13


def order_inputs(L, device, seed=0):
    """Unit-norm complex128 ``v0``, ``v1``, ``Φ``; float64 ``dmb`` and
    per-bit ``G`` from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)

    def vec():
        v = rng.standard_normal(1 << L) + 1j * rng.standard_normal(1 << L)
        return torch.from_numpy(v / np.linalg.norm(v)).to(device)

    v0, v1, phi = vec(), vec(), vec()
    dmb = torch.from_numpy(rng.standard_normal(1 << L) - 2.5).to(device)
    G = torch.from_numpy(rng.uniform(0.5, 1.5, L)).to(device)
    return v0, v1, phi, dmb, G


def run(device, L=20, reps=30, seed=0, log=print):
    """Times of the high pass, the production tiled pass and every
    ``probe_flip_order`` case; returns ``{"high": {...}, "iter_low":
    {...}, "cases": {"body/nb": {"ms", "GB/s"}}}``."""
    card = card_line()
    v0, v1, phi, dmb, G = order_inputs(L, device, seed)
    tile_bits, h = cf.flip_split(L, torch.complex128)
    bits = L - h
    n = 1 << L
    res = {"card": card, "L": L, "tile_bits": tile_bits, "h": h,
           "cases": {}}
    w = cf.cheby_flip_high(v1, G, h) if h else None
    tiled_bytes = (6 * 16 + 8) * n

    def record(key, what, ms, n_bytes):
        gbs = n_bytes / ms / 1e6
        res[key] = {"ms": ms, "GB/s": gbs}
        log(f"dd_stages L={L} {what}: {ms:.4f} ms/call ({n_bytes / n:.0f} "
            f"B/elem -> {gbs:.1f} GB/s, {100 * gbs * 1e9 / HBM_BYTES_S:.1f} "
            f"% of 3.35 TB/s) [{card}]")

    if h:
        record("high", f"high pass cheby_flip_high<double> (top {h} bits)",
               time_ms(lambda: cf.cheby_flip_high(v1, G, h), reps), 32 * n)
    record("iter_low", f"production tiled pass cheby_flip_iter_low "
                       f"(bits < {bits}, tiles of 2^{tile_bits})",
           time_ms(lambda: cf.cheby_flip_iter_low(v0, v1, phi, dmb, G, S2,
                                                  AK, bits, w), reps),
           tiled_bytes)
    for body in BODIES:
        for nb in NBS:
            ms = time_ms(lambda: probes.probe_flip_order(
                v0, v1, phi, dmb, G, S2, AK, tile_bits, bits, body, nb, w),
                reps)
            gbs = tiled_bytes / ms / 1e6
            res["cases"][f"{body}/{nb}"] = {"ms": ms, "GB/s": gbs}
            log(f"dd_stages L={L} {body + '/' + nb:13s}: {ms:.4f} ms/call "
                f"({gbs:.1f} GB/s at 104 B/elem, "
                f"{100 * gbs * 1e9 / HBM_BYTES_S:.1f} % of 3.35 TB/s) "
                f"[{card}]")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--L", type=int, default=20)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    return run(cuda_device(), args.L, args.reps)


if __name__ == "__main__":
    main()
