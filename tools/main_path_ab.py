"""The main path's steps/s of two checkouts, measured in turn on one card.

    python3 tools/main_path_ab.py PARENT CHANGE [--rounds N]

``PARENT`` and ``CHANGE`` are checkouts of this repository (each with its
own ``quantumpropagators_torch`` and ``chip_smoke.py``).  Each run is a
process of its own in one checkout: ``chip_smoke.main_path`` (phases 3-4:
the L = 24 driven chain through ``propagate(fused=True)``, 20 steps,
``kernel="dd"`` and ``kernel="pallas"``, each the median of 3 timed runs,
as phase 6 prints them), then the dd call with phase 3's two observables
and ``storage=True``, timed the same way.  The runs go parent, change,
change, parent, ``N`` times over.  Prints one JSON line per run and the
card's name and power limit last.
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
print(json.dumps({"dd": rates["dd"][0], "pallas": rates["pallas"][0],
                  "dd_observables": cs.N_STEPS / t_obs}))
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
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            tree = os.path.abspath(getattr(args, name))
            print(json.dumps({"tree": name, "steps_s": run_tree(tree)}),
                  flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
