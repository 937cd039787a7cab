"""Eager steps/s of ``bench_torch.py``'s 2^20 dd chain (phase 15's eager
side) with the kernel wrappers' autograd check and without it, in turn
in one process on one card.

    python3 tools/refuse_grad_ab.py [--rounds N] [--steps N]

The check (``ops/_cuda.refuse_grad``) runs at every eager launch of a
flip or banded kernel while grad mode is on, as it is by default;
"off" replaces it by a function that returns at once, which is what
the wrappers did before they had the check.  Each reading is steps/s of
``--steps`` eager steps (wall clock, synchronized before and after);
the readings go on, off, off, on, ``N`` times over.  Also prints the
kernel launches a step and the host µs of one check given nine tensors
(a flip iteration's arguments), the median of 5 timings of 10^5 checks.
Prints one JSON line, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import bench_torch
    from quantumpropagators_torch.ops import _cuda, cheby_flip

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    step, psi, _ = bench_torch.dd_stepper(
        bench_torch.tfim_problem(device, 20), device)
    check = _cuda.refuse_grad

    def off(kernel, *inputs):
        return None

    def rate(n):
        x = psi
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            x = step(x)
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    assert torch.is_grad_enabled()
    rate(10)  # kernels built, caches warm
    before = sum(cheby_flip.LAUNCHES.values())
    rate(1)
    launches = sum(cheby_flip.LAUNCHES.values()) - before
    readings = {"on": [], "off": []}
    for _ in range(args.rounds):
        for how in ("on", "off", "off", "on"):
            _cuda.refuse_grad = check if how == "on" else off
            readings[how].append(rate(args.steps))
    _cuda.refuse_grad = check

    tensors = [torch.zeros(4, device=device) for _ in range(9)]
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(100_000):
            check(lambda: "kernel<double>", *tensors)
        times.append((time.perf_counter() - t0) / 100_000 * 1e6)
    print(json.dumps({
        "steps_s_on": readings["on"], "steps_s_off": readings["off"],
        "median_on": statistics.median(readings["on"]),
        "median_off": statistics.median(readings["off"]),
        "launches_a_step": launches,
        "check_host_us": statistics.median(times)}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
