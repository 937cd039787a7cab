"""H100 characterization probes: the port of the TPU probes under
``docs/profiling/`` onto the hand-written kernels of ``csrc/probes.cu``
(wrappers and plain versions in :mod:`..ops.probes`).

One module per probe group, each run as
``python -m quantumpropagators_torch.profiling.<module>``:

- :mod:`.roofline`: copy, add, triad, n-input sum and FMA-chain rates,
  in-tile flip sums, the tile product and the shared-memory limit
  (``scratch_roofline.py``, ``scratch_r3_roofline.py``,
  ``scratch_r3_probe2.py``, ``scratch_r3_probe3.py``);
- :mod:`.scatter`: 16-plane streaming with 7 planes read at their own
  tile, at ``t + 2^j`` or at ``t ^ 2^j``, with and without an FMA chain,
  and through a cp.async ring (``probe_scatter_r4.py``);
- :mod:`.flips`: the 9-bit flip sum by four formulations and the
  permutation products' exactness (``scratch_flips.py``);
- :mod:`.dd_stages`: the flip order's stages, high pass and tiled pass
  with its traffic, flips and arithmetic apart (``scratch_prof_dd.py``,
  ``scratch_prof2.py``);
- :mod:`.exactness`: FMA contraction, σ-extraction, TF32 / 3xTF32 /
  FP64 tensor-core exactness against mantissa width, the XOR permutation
  (``scratch_r3_probe2.py``, ``_probe3.py``, ``_probe4.py``,
  ``probe_mxu_grid_r4.py``).

Each ``main(argv)`` takes the JAX script's flags where it has them, runs
on ``cuda:0``, prints one line a measurement with the card's name and
power limit, and returns its results as a dict.  The probes measure the
card: without a CUDA device they raise (the tests call the plain
versions on CPU tensors instead).
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..ops import cheby_flip as _flip
from ..ops import probes as _probes

__all__ = ["HBM_BYTES_S", "card_line", "cuda_device", "planes", "time_ms"]

# H100 SXM device memory rate (NVIDIA data sheet), against which a rate's
# share is printed
HBM_BYTES_S = 3.35e12
# launch counts of the kernels the probes time
_COUNTERS = (_probes.LAUNCHES, _flip.LAUNCHES)


def cuda_device() -> torch.device:
    """``cuda:0``; raises without a CUDA device (no CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the profiling probes measure a CUDA device and "
                           "none is available")
    return torch.device("cuda", 0)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn``: two eager warm-up calls, then
    ``reps`` calls recorded into one CUDA graph, replayed once untimed
    and once between two CUDA events.  A replay launches the recorded
    kernels back to back, so the host's cost of a call (the wrapper's
    checks, the ctypes call) stays out of the time of a kernel that runs
    for microseconds.  ``LAUNCHES`` ends up counting the launches that
    ran: the warm-ups and both replays, not the recording (as
    ``utils/scan.py`` keeps its counts)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    before = [dict(c) for c in _COUNTERS]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    graph.replay()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    # recording counted the graph's launches once and ran none of them;
    # the two replays ran them twice
    for counts, was in zip(_COUNTERS, before):
        for key in counts:
            counts[key] += counts[key] - was[key]
    return start.elapsed_time(stop) / reps


def planes(n: int, count: int, device, seed: int = 0, scale: float = 1.0):
    """``count`` float32 planes of ``n`` standard normal values (times
    ``scale``) from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        v = rng.standard_normal(n, dtype=np.float32)
        if scale != 1.0:
            v *= np.float32(scale)
        out.append(torch.from_numpy(v).to(device))
    return out
