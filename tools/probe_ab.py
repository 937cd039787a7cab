"""The stream, tile-product and flip-sum probe kernels of two checkouts,
timed in turn on one card.

    python3 tools/probe_ab.py PARENT CHANGE [--rounds N] [--reps N]

``PARENT`` and ``CHANGE`` are checkouts of this repository.  Each run is a
process of its own in one checkout, which times that checkout's
``ops.probes`` wrappers with its ``profiling.time_ms`` (a replayed CUDA
graph of ``reps`` launches), each read twice and the lower reading kept,
at ``chip_smoke.py`` phase 16's sizes: copy, triad and the 64-link FMA
chain on planes of 2^26 elements, the 16-plane sums (``seq``, ``stride``,
``xor``, tiles of 1024 rows, flops 0) on planes of 2^22, and the TF32,
3xTF32 and FP64 tile products on (2^19, 128) f32 and (2^18, 128) f64
planes, the four flip sums of bits 0-8 (``gather``, ``tile``, ``shfl``,
``mma`` at ``profiling/flips.py``'s tile sizes) on the plane of 2^26;
``Tensor.copy_``, ``torch.addcmul`` and ``torch.matmul`` f32 on the same
inputs beside them.  ``--warm S`` keeps the card busy with
copies for S seconds before the readings; the SM and memory clocks are
read before and after that and after the readings.  The runs go parent, change, change,
parent, ``N`` times over.  Prints one JSON line (milliseconds) per run
and the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import json, sys
import torch
sys.path.insert(0, ".")
from quantumpropagators_torch.ops import probes as P
from quantumpropagators_torch.profiling import planes, scatter, time_ms
from quantumpropagators_torch.profiling.flips import VARIANTS as FLIPS

import subprocess, time
reps, warm = int(sys.argv[1]), float(sys.argv[2])
dev = torch.device("cuda", 0)


def sm_clock():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()

x, y, z = planes(1 << 26, 3, dev, seed=0)
s16 = planes(1 << 22, scatter.N_IN, dev, seed=1, scale=1e-3)
out = torch.empty_like(x)
x2, M = x.view(-1, 128), y[:128 * 128].view(128, 128)
x64, M64 = x2[: x2.shape[0] // 2].double(), M.double()


def matmul_f32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        torch.matmul(x2, M, out=out.view(-1, 128))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


calls = {
    "copy": lambda: P.probe_stream([x]),
    "triad": lambda: P.probe_stream([x, y, z], "triad"),
    "fma64": lambda: P.probe_stream([x, y], "chain", chain=64,
                                    mul=1.0000001),
    **{f"16 planes {m}": (lambda m=m: P.probe_stream(
        s16, "sum", maps=scatter.maps(m, (1 << 22) >> 17), tile_bits=17,
        n_out=2)) for m in scatter.MODES},
    **{f"tile {m}": (lambda m=m: P.probe_tile_mma(
        x64 if m == "f64" else x2, M64 if m == "f64" else M, m))
       for m in ("tf32", "3xtf32", "f64")},
    **{f"flips {v}": (lambda v=v, t=t: P.probe_flipsum(x, 0, 9, v, t))
       for v, t in FLIPS.items()},
    "copy_": lambda: out.copy_(x),
    "addcmul": lambda: torch.addcmul(x, y, z, out=out),
    "matmul f32": matmul_f32,
}
clocks = [sm_clock()]
t_end = time.perf_counter() + warm
while time.perf_counter() < t_end:  # the card busy before the readings
    for _ in range(50):
        out.copy_(x)
    torch.cuda.synchronize()
clocks.append(sm_clock())
ms = {k: min(time_ms(f, reps) for _ in range(2)) for k, f in calls.items()}
clocks.append(sm_clock())
print(json.dumps({**ms, "clocks (sm, mem) before warm-up, after, after "
                  "the readings": clocks}))
"""


def run_tree(tree: str, reps: int, warm: float) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN, str(reps), str(warm)],
                         cwd=tree,
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
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--warm", type=float, default=0.0,
                    help="seconds of back-to-back copies before the readings")
    args = ap.parse_args()
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            tree = os.path.abspath(getattr(args, name))
            print(json.dumps({"tree": name,
                              "ms": run_tree(tree, args.reps, args.warm)}),
                  flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
