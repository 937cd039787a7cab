"""Back-to-back ``propagate(fused=True)`` calls on the card: wall time and
reserved memory per call, with the scan's graphs in one shared memory
pool, in a pool of their own each, or with no graph at all.

    python3 tools/scan_pool_probe.py [--calls N] [--rounds R]

Each variant runs in a process of its own, ``R`` times over in the order
shared, private, eager: the L = 24 driven chain of ``chip_smoke.py``'s
phases 3-4 (its seeded Arnoldi envelope, 16 orders, 20 steps), ``N``
calls with ``kernel="dd"`` and then ``N`` with ``kernel="pallas"``, each
call timed to a ``torch.cuda.synchronize()``.  ``private`` captures each
graph into a pool of its own (``capture_begin(pool=None)``); ``eager``
runs every scan as the loop of its step.  Prints one JSON line per
process (steps/s and ``torch.cuda.memory_reserved()`` in GiB after each
call) and the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("shared", "private", "eager")


def run_variant(variant: str, calls: int) -> dict:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    import quantumpropagators_torch as qt
    from quantumpropagators_torch import fused
    from quantumpropagators_torch.ops import newton_leja
    from quantumpropagators_torch.propagators.cheby import ChebyPropagator
    from quantumpropagators_torch.utils import scan as sc

    if variant == "private":
        sc._graph_pool = lambda device: None
    elif variant == "eager":
        def loop(step, carry, xs=None, length=None):
            return sc._loop(step, carry, xs, sc._length(xs, length))

        fused.scan = newton_leja.scan = loop
    device = torch.device("cuda", 0)
    tlist = np.linspace(0.0, cs.N_STEPS * cs.DT, cs.N_STEPS + 1)
    _, H = cs.tfim_generator(cs.L_MAIN, device)
    psi0 = cs.random_state(cs.L_MAIN, torch.complex128, device, cs.SEED + 10)
    wrk = ChebyPropagator(psi0, H, tlist,
                          rng=np.random.default_rng(cs.SEED + 30)).wrk
    out = {"variant": variant, "orders": len(wrk.coeffs)}
    for kernel, psi in (("dd", psi0), ("pallas", psi0.to(torch.complex64))):
        rates, reserved = [], []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qt.propagate(psi, H, tlist, method="cheby", fused=True,
                         kernel=kernel, workspace=wrk)
            torch.cuda.synchronize()
            rates.append(cs.N_STEPS / (time.perf_counter() - t0))
            reserved.append(torch.cuda.memory_reserved(device) / 2 ** 30)
        out[f"{kernel}_steps_s"] = rates
        out[f"{kernel}_reserved_gib"] = reserved
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--variant", choices=VARIANTS, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.variant:
        print(json.dumps(run_variant(args.variant, args.calls)))
        return 0
    for _ in range(args.rounds):
        for variant in VARIANTS:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--variant",
                 variant, "--calls", str(args.calls)],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
                raise SystemExit(f"{variant}: exit {out.returncode}")
            print(out.stdout.strip().splitlines()[-1], flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
