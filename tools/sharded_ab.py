"""The 4-slot sharded flip steps of two checkouts, measured in turn on one
card.

    python3 tools/sharded_ab.py PARENT CHANGE [--rounds N]

``PARENT`` and ``CHANGE`` are checkouts of this repository (each with its
own ``quantumpropagators_torch`` and ``chip_smoke.py``).  Each run is a
process of its own in one checkout.  It builds ``chip_smoke.py`` phase
10's problem: the L = 24 driven chain (phase 3's generator, state and
seeded Arnoldi envelope) on 4 slots of the card, and steps it with
``make_sharded_fused_cheby_step_dd`` (complex128, the f32 tail, phase
10's per-bit flip table) and ``make_sharded_fused_cheby_step``
(complex64, the 0-d flip table), both graphed.  For each tier: the
median of 3 timed runs of 20 steps after one untimed run, and
``chip_smoke.trace_steps`` over 3 steps (device ms a step of the flip
kernels, copies, PyTorch elementwise kernels and all else).  The runs
go parent, change, change, parent, ``N`` times over.  Prints one JSON
line per run and the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import contextlib, io, json, re, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from quantumpropagators_torch.models.generators import (coeff_table,
                                                        coeff_table_np)
from quantumpropagators_torch.ops.fused_cheby_dd import f32_tail_orders
from quantumpropagators_torch.parallel import sharded_fused as sf
from quantumpropagators_torch.parallel.mesh import chain_mesh, shard_vector
from quantumpropagators_torch.propagators.cheby import ChebyPropagator

device = torch.device("cuda", 0)
L, n = cs.L_MAIN, cs.N_STEPS
tlist = np.linspace(0.0, n * cs.DT, n + 1)
_, H = cs.tfim_generator(L, device)
psi0 = cs.random_state(L, torch.complex128, device, cs.SEED + 10)
wrk = ChebyPropagator(psi0, H, tlist,
                      rng=np.random.default_rng(cs.SEED + 30)).wrk
mesh = chain_mesh(4, device=device)
diag = H.ops[0].diag.real.to(torch.float64)
c64 = np.asarray(wrk.coeffs, dtype=np.float64)
kw = dict(delta=wrk.delta, e_min=wrk.e_min, dt=wrk.dt)
drive = np.asarray(coeff_table_np(H, tlist))[:, 0]
Gbits = torch.as_tensor(np.outer(drive, np.full(L, cs.G_FIELD)),
                        device=device)
table = coeff_table(H, tlist)
table = (table.real if table.is_complex() else table).to(
    device, torch.float32)[:, 0]

step_dd = sf.make_sharded_fused_cheby_step_dd(
    mesh, L, 1.0, f32_tail=f32_tail_orders(c64), **kw)
dmb = shard_vector(mesh, diag - (wrk.delta / 2.0 + wrk.e_min))
step_32 = sf.make_sharded_fused_cheby_step(mesh, L, cs.G_FIELD, **kw)
d32 = shard_vector(mesh, diag)
p32 = psi0.to(torch.complex64)


def run_dd(k_steps=n):
    st = shard_vector(mesh, psi0)
    for k in range(k_steps):
        st = step_dd(dmb, st, c64, flip_scale=Gbits[k])
    return st


def run_32(k_steps=n):
    re = shard_vector(mesh, p32.real.contiguous())
    im = shard_vector(mesh, p32.imag.contiguous())
    for k in range(k_steps):
        re, im = step_32(d32, re, im, c64, flip_scale=table[k])
    return re


out = {}
for tier, run in (("dd", run_dd), ("f32", run_32)):
    run()
    torch.cuda.synchronize()
    _, wall = cs.median_wall(run)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        cs.trace_steps(lambda: run(3), tier, 3, "", top=0)
    split = re.search(r"device window ([0-9.]+) .*flip kernels ([0-9.]+) "
                      r".*copies ([0-9.]+), PyTorch elementwise ([0-9.]+), "
                      r"all else ([0-9.]+)", text.getvalue())
    out[tier] = dict(zip(("steps_s", "window_ms", "flip_ms", "copies_ms",
                          "elementwise_ms", "all_else_ms"),
                         [n / wall] + [float(x) for x in split.groups()]))
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
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            tree = os.path.abspath(getattr(args, name))
            print(json.dumps({"tree": name, **run_tree(tree)}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
