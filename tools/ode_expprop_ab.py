"""The stepwise ODE and expprop propagations of two or more checkouts,
measured in turn on one card.

    python3 tools/ode_expprop_ab.py TREE TREE [TREE ...] [--rounds N]

Each ``TREE`` is a checkout of this repository (with its own
``quantumpropagators_torch`` and ``chip_smoke.py``), the parent first.
Each run is a process of its own in one checkout that propagates
through the public interface, for

- ``sparse static``: ``propagate(method="ode")`` and
  ``propagate(method="expprop")`` of ``chip_smoke.py`` phase 9 (the
  N = 1024 sparse Hermitian of ``bench.py:330-342``, 20 intervals of
  0.5; the ODE's default flags pick the continuous variant);
- ``sparse pwc`` / ``sparse continuous``: the same operator with itself
  as a driven term, a ``numpy`` and a ``torch.cos`` drive, ``pwc=True``
  and ``pwc=False`` (phase 19a);
- ``transmon pwc``: the N = 10 transmon ladder of ``bench.py:142-290``,
  10 ODE intervals and 100 expprop intervals;
- ``chain pwc``: the driven L = 20 chain of phase 19b, 2 ODE intervals.

For each: the seconds of a first ``propagate`` call (a new propagator:
the interval that runs eagerly and the capture included), the seconds
of its first interval alone and the median seconds of its later
intervals (each ``prop_step`` between two device synchronizations), and
the steps/s of a steady propagation (median of 3 after ``reinit_prop``).
The runs go through the trees and back (parent, change, change, parent
for two), ``N`` times over.  Prints one JSON line per run and the
card's name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import json, sys, time
import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import eigsh
sys.path.insert(0, ".")
import chip_smoke as cs
import quantumpropagators_torch as qt
from quantumpropagators_torch.propagate import propagate_propagator

device = torch.device("cuda", 0)
out = {}


def measure(name, psi, gen, tlist, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qt.propagate(psi, gen, tlist, check=False, **kw)
    torch.cuda.synchronize()
    first_call = time.perf_counter() - t0
    prop = qt.init_prop(psi, gen, tlist, **kw)
    steps = []
    while True:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if prop.prop_step() is None:
            break
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    walls = []
    for _ in range(3):
        qt.reinit_prop(prop, psi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        propagate_propagator(prop)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out[name] = {"first_call_s": first_call, "first_interval_s": steps[0],
                 "later_interval_s": float(np.median(steps[1:])),
                 "steady_steps_s": len(steps) / float(np.median(walls))}


rng = np.random.default_rng(42)  # chip_smoke.sparse_hermitian's
A = sp.random(1024, 1024, density=0.01, random_state=rng,
              data_rvs=rng.standard_normal)
H = (0.5 * (A + A.T)).tocsr()
lam = [abs(eigsh(H, k=1, which=w, return_eigenvectors=False)[0])
       for w in ("LA", "SA")]
H = (H * (10.0 / max(lam))).astype(np.float64)
psi_h = rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
psi_h /= np.linalg.norm(psi_h)
op = qt.csr_from_scipy(H, device=device)
psi = torch.as_tensor(psi_h, device=device)
tl = np.linspace(0.0, 10.0, 21)
measure("sparse static ode", psi, op, tl, method="ode")
measure("sparse static expprop", psi, op, tl, method="expprop")
measure("sparse pwc ode", psi, qt.hamiltonian(
    op, (op, lambda t: 0.5 * float(np.cos(2.0 * t)))), tl, method="ode",
    pwc=True)
measure("sparse continuous ode", psi, qt.hamiltonian(
    op, (op, lambda t: 0.5 * torch.cos(2.0 * t))), tl, method="ode",
    pwc=False)
N = 10
a = sp.diags(np.sqrt(np.arange(1, N, dtype=float)), 1).toarray()
n_op = a.T @ a
H0 = 6.0 * n_op - 0.1 * (n_op @ (n_op - np.eye(N)))
gen = qt.hamiltonian(qt.dia_from_scipy(sp.csr_matrix(H0), device=device),
                     (qt.dia_from_scipy(sp.csr_matrix(a + a.T),
                                        device=device),
                      lambda t: 0.3 * float(np.cos(5.8 * t))))
psi = torch.as_tensor(np.eye(N)[0].astype(complex), device=device)
full = np.linspace(0.0, 10.0, 101)
measure("transmon pwc ode", psi, gen, full[:11], method="ode", pwc=True)
measure("transmon expprop", psi, gen, full, method="expprop")
_, chain = cs.tfim_generator(20, device)
psi = cs.random_state(20, torch.complex128, device, cs.SEED + 190)
measure("chain pwc ode", psi, chain, np.linspace(0.0, 2 * cs.DT, 3),
        method="ode", pwc=True)
print(json.dumps(out))
"""


def run_tree(tree: str) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                         capture_output=True, text=True, timeout=900)
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
