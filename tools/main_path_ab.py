"""The main path's steps/s of two or more checkouts, measured in turn on
one card.

    python3 tools/main_path_ab.py TREE TREE [TREE ...] [--rounds N]

Each ``TREE`` is a checkout of this repository (with its own
``quantumpropagators_torch`` and ``chip_smoke.py``), the parent first.
Each run is a process of its own in one checkout: ``chip_smoke.main_path``
(phases 3-4: the L = 24 driven chain through ``propagate(fused=True)``,
20 steps, ``kernel="dd"`` and ``kernel="pallas"``, each the median of 3
timed runs, as phase 6 prints them), then the dd call with phase 3's two
observables and ``storage=True``, timed the same way, the peak reserved
and allocated GiB of one more dd call (after ``empty_cache``), the
2^20 dd chain of ``bench_torch.py`` (its ``bench_headline``, no oracle:
steps/s over 40 replayed steps), for each tier the host ms of each
graph capture in one call, the median of 7 calls and one
``torch.profiler`` trace of a call (wall and device window a step, busy
share), then phase 6's
high pass alone at L = 24 (h = 6, no partners) in both types and, where
the checkout's high pass takes partners, the 4-slot sharded order's
(4 × 2^22, h = 4, two slot-bit partners) and, where it takes five, the
32-slot one's (32 × 2^19, h = 1): each the median of 3 readings of
``profiling.time_ms`` (20 calls recorded into a CUDA graph and replayed,
so that the host's cost of 32 slot launches stays out).  The runs go through
the trees and back (parent, change, change, parent for two), ``N``
times over.  Prints one JSON line per run and the card's name and power
limit last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
import quantumpropagators_torch as qt

device = torch.device("cuda", 0)
_, rates, _, (psi0, H, wrk), _, _ = cs.main_path(device, cs.card_line())
tlist = np.linspace(0.0, cs.N_STEPS * cs.DT, cs.N_STEPS + 1)
obs = (cs.sz0(cs.L_MAIN, device), lambda psi: torch.linalg.vector_norm(psi))
_, t_obs = cs.median_wall(lambda: qt.propagate(
    psi0, H, tlist, method="cheby", fused=True, kernel="dd", workspace=wrk,
    observables=obs, storage=True))
steps_s = {"dd": rates["dd"][0], "pallas": rates["pallas"][0],
           "dd_observables": cs.N_STEPS / t_obs}
torch.cuda.synchronize()
torch.cuda.empty_cache()
torch.cuda.reset_peak_memory_stats()
qt.propagate(psi0, H, tlist, method="cheby", fused=True, kernel="dd",
             workspace=wrk)
torch.cuda.synchronize()
gib = {"dd_peak_reserved": torch.cuda.max_memory_reserved() / 2 ** 30,
       "dd_peak_allocated": torch.cuda.max_memory_allocated() / 2 ** 30}

# per call of each tier: the host ms of each graph capture, the wall
# median of 7 calls, and one trace (wall, device window, busy share)
import contextlib, io, re, time
from quantumpropagators_torch.utils import scan as sc

spent = []
capture = sc._Graph._capture


def timed_capture(self, *args):
    t0 = time.perf_counter()
    capture(self, *args)
    spent.append(1e3 * (time.perf_counter() - t0))


calls = {}
for tier, psi in (("dd", psi0), ("pallas", psi0.to(torch.complex64))):
    def run(psi=psi, tier=tier):
        return qt.propagate(psi, H, tlist, method="cheby", fused=True,
                            kernel=tier, workspace=wrk)

    sc._Graph._capture = timed_capture
    spent.clear()
    run()
    torch.cuda.synchronize()
    sc._Graph._capture = capture
    _, wall = cs.median_wall(run, reps=7)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        cs.trace_steps(run, tier, cs.N_STEPS, "", top=0)
    trace = re.search(r"wall ([0-9.]+) ms/step, device window ([0-9.]+) "
                      r"ms/step, busy ([0-9.]+) %", text.getvalue())
    calls[tier] = {"capture_ms": list(spent),
                   "steps_s_median_of_7": cs.N_STEPS / wall,
                   **dict(zip(("trace_wall_ms", "trace_window_ms",
                               "trace_busy_pct"),
                              map(float, trace.groups())))}
del psi0, H, wrk
torch.cuda.empty_cache()

import bench_torch

steps_s["bench_torch_dd_2^20"] = bench_torch.bench_headline(
    device, L=20, kernel="dd", oracle=False)["extra"]["steps_per_s"]
torch.cuda.empty_cache()

from quantumpropagators_torch.ops import cheby_flip as cf


from quantumpropagators_torch.profiling import time_ms


def median_ms(fn):
    return float(np.median([time_ms(fn, 20) for _ in range(3)]))


high_ms = {}
for ctype in ("float", "double"):
    _, v1, _, _, G, _ = cs.kernel_inputs(cs.L_MAIN, ctype, device, cs.SEED)
    h = cf.flip_split(cs.L_MAIN, v1.dtype)[1]
    high_ms[f"{ctype} h={h}"] = median_ms(lambda: cf.cheby_flip_high(v1, G,
                                                                     h))
    if hasattr(cf, "MAX_PARTNERS"):
        x = v1.view(4, -1)
        h4 = cf.flip_split(cs.L_MAIN - 2, v1.dtype)[1]
        high_ms[f"{ctype} 4 slots h={h4} P=2"] = median_ms(
            lambda: cf.cheby_flip_high(x, G, h4, partners=[(x, 1), (x, 2)]))
    if getattr(cf, "MAX_PARTNERS", 0) >= 5:
        x32 = v1.view(32, -1)
        h32 = cf.flip_split(cs.L_MAIN - 5, v1.dtype)[1]
        high_ms[f"{ctype} 32 slots h={h32} P=5"] = median_ms(
            lambda: cf.cheby_flip_high(x32, G, h32, partners=[
                (x32, 1 << r) for r in range(5)]))
    del v1, G
print(json.dumps({"steps_s": steps_s, "gib": gib, "calls": calls,
                  "high_ms": high_ms}))
"""


def run_tree(tree: str) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"{tree}: exit {out.returncode}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    if len(args.trees) < 2:
        ap.error("give at least two trees")
    for _ in range(args.rounds):
        for tree in args.trees + args.trees[::-1]:
            print(json.dumps({"tree": tree,
                              **run_tree(os.path.abspath(tree))}),
                  flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
