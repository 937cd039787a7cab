"""The stepwise path's steps/s of two or more checkouts, measured in turn
on one card.

    python3 tools/stepwise_ab.py TREE TREE [TREE ...] [--rounds N]

Each ``TREE`` is a checkout of this repository (with its own
``quantumpropagators_torch`` and ``chip_smoke.py``), the parent first.
Each run is a process of its own in one checkout that propagates
through the public stepwise interface (``init_prop``, then
``propagate_propagator``: the host steps interval by interval), one
warm-up propagation and then the median of 3 timed ones (each after
``reinit_prop``), for

- ``transmon``: the N = 10 driven transmon ladder of ``bench.py:142-290``
  (DIA terms), 100 Chebyshev intervals with ``check_normalization``,
  and 20 ``newton`` and 20 ``expv`` intervals;
- ``sparse``: the N = 1024 sparse Hermitian of ``bench.py:330-342``
  (spectral radius 10) with a diagonal drive, 100 Chebyshev intervals
  with ``check_normalization``, and 20 ``newton`` and 20 ``expv``
  intervals;
- ``banded20``: ``chip_smoke.banded20_operator`` at 2^20, 20 Chebyshev
  intervals at ``precision="dd"`` with its band planes as
  ``dd_operator_terms`` (dt from the envelope, as phase 7), and 5
  ``newton`` dd and 5 ``expv`` dd intervals; beside them the seconds of
  the Chebyshev propagator's initialization (its m = 60 spectral
  envelope);
- the standalone dd applies, ms a call inside one
  ``ops.arnoldi.arnoldi_sites`` scope (3 calls first, then 20 timed):
  ``cheby_apply_dd`` on the diagonal of the L = 20 chain of
  ``chip_smoke.tfim_generator`` and ``cheby_apply_dd_bsr`` on the
  optomech chain of ``bench_torch.py:602-622`` at R = 16.

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
from quantumpropagators_torch.ops.bsr_dd import banded_dd_from_bsr
from quantumpropagators_torch.propagate import propagate_propagator

device = torch.device("cuda", 0)


def rate(prop, psi, n):
    walls = []
    for _ in range(4):
        qt.reinit_prop(prop, psi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        propagate_propagator(prop)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return n / float(np.median(walls[1:]))


steps_s, init_s = {}, {}
N = 10
a = sp.diags(np.sqrt(np.arange(1, N, dtype=float)), 1).tocsr()
ad = a.T.tocsr()
n_op = (ad @ a).tocsr()
H0 = (6.0 * n_op - 0.1 * (n_op @ (n_op - sp.identity(N)))).tocsr()
gen = qt.hamiltonian(qt.dia_from_scipy(H0, device=device),
                     (qt.dia_from_scipy((a + ad).tocsr(), device=device),
                      lambda t: 0.3 * float(np.cos(5.8 * t))))
psi = torch.as_tensor(np.eye(N)[0].astype(complex), device=device)
tlist = np.linspace(0.0, 10.0, 101)
steps_s["transmon cheby"] = rate(qt.init_prop(
    psi, gen, tlist, method="cheby", check_normalization=True), psi, 100)
for method in ("newton", "expv"):
    steps_s[f"transmon {method}"] = rate(qt.init_prop(
        psi, gen, tlist[:21], method=method), psi, 20)

N = 1024
rng = np.random.default_rng(42)
A = sp.random(N, N, density=0.01, random_state=rng,
              data_rvs=rng.standard_normal)
H = (0.5 * (A + A.T)).tocsr()
lam = [abs(eigsh(H, k=1, which=w, return_eigenvectors=False)[0])
       for w in ("LA", "SA")]
H = (H * (10.0 / max(lam))).astype(np.float64)
psi = rng.standard_normal(N) + 1j * rng.standard_normal(N)
psi = torch.as_tensor(psi / np.linalg.norm(psi), device=device)
drive = sp.diags(np.random.default_rng(7).uniform(-1.0, 1.0, N)).tocsr()
gen = qt.hamiltonian(qt.csr_from_scipy(H, device=device),
                     (qt.csr_from_scipy(drive, device=device),
                      lambda t: 0.5 * float(np.cos(2.0 * t))))
steps_s["sparse cheby"] = rate(qt.init_prop(
    psi, gen, tlist, method="cheby", check_normalization=True), psi, 100)
for method in ("newton", "expv"):
    steps_s[f"sparse {method}"] = rate(qt.init_prop(
        psi, gen, tlist[:21], method=method), psi, 20)

op = cs.banded20_operator(device)
psi = cs.random_state(20, torch.complex128, device, cs.SEED + 50)
banded = banded_dd_from_bsr(op)
env = qt.init_prop(psi, op, [0.0, 1.0], method="cheby", coeffs_pad_to=1,
                   rng=np.random.default_rng(cs.SEED + 60)).wrk
dt = 6.0 / env.delta
tlist = np.linspace(0.0, 20 * dt, 21)
torch.cuda.synchronize()
t0 = time.perf_counter()
prop = qt.init_prop(psi, op, tlist, method="cheby", precision="dd",
                    dd_operator_terms=(banded,), coeffs_pad_to=1,
                    rng=np.random.default_rng(cs.SEED + 60))
torch.cuda.synchronize()
init_s["banded20 cheby dd"] = time.perf_counter() - t0
steps_s["banded20 cheby dd"] = rate(prop, psi, 20)
del prop
for method in ("newton", "expv"):
    steps_s[f"banded20 {method} dd"] = rate(qt.init_prop(
        psi, op, tlist[:6], method=method, precision="dd",
        dd_operator_terms=(banded,)), psi, 5)
del op, banded, psi

from quantumpropagators_torch.ops.arnoldi import ArnoldiSites, arnoldi_sites
from quantumpropagators_torch.ops.cheby import cheby_coeffs
from quantumpropagators_torch.ops.df64 import cheby_apply_dd
from quantumpropagators_torch.ops.df64_sparse import (bsr_dd_from_scipy,
                                                      cheby_apply_dd_bsr)


def apply_ms(call):
    with arnoldi_sites(ArnoldiSites()):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / 20


apply_ms_s = {}
H_diag, _ = cs.tfim_generator(20, device)
diag = H_diag.diag.real.to(torch.float64).contiguous()
bound = float(diag.abs().max()) + 20 * cs.G_FIELD
psi = cs.random_state(20, torch.complex128, device, cs.SEED + 260)
c = cheby_coeffs(2 * bound, cs.DT)
apply_ms_s["cheby_apply_dd L=20"] = apply_ms(lambda: cheby_apply_dd(
    psi, diag, [cs.G_FIELD] * 20, c, 2 * bound, -bound, cs.DT, L=20))
rng = np.random.default_rng(1)
R, b = 16, 64
blocks, rows, cols = [], [], []
for r in range(R):
    for k in (r - 1, r, r + 1):
        if 0 <= k < R:
            rows.append(r)
            cols.append(k)
            blocks.append(rng.standard_normal((b, b)))
indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=R))])
H2 = sp.bsr_matrix((np.stack(blocks), np.asarray(cols), indptr),
                   shape=(R * b, R * b)).tocsr()
H2 = (0.5 * (H2 + H2.T)).tocsr()
op2 = bsr_dd_from_scipy(H2, block_size=b, device=device)
bound2 = float(np.abs(H2).sum(axis=1).max())
psi2 = cs.random_state(10, torch.complex128, device, cs.SEED + 261)
c2 = cheby_coeffs(2 * bound2, 0.02)
apply_ms_s["cheby_apply_dd_bsr R=16"] = apply_ms(lambda: cheby_apply_dd_bsr(
    op2, psi2, c2, 2 * bound2, -bound2, 0.02))
print(json.dumps({"steps_s": steps_s, "init_s": init_s,
                  "apply_ms": apply_ms_s}))
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
