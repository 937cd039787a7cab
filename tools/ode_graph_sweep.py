"""The graphed ODE loop's chunk size and the dense solve under capture, on
one NVIDIA GPU.

    python3 tools/ode_graph_sweep.py [solve] [chunks]

``solve``: how ``torch.linalg`` solves a dense system on the card, which
``ops/expprop.expm`` needs inside a captured graph: the preferred linear
algebra library, whether ``solve_ex(check_errors=False)``,
``lu_factor_ex`` + ``lu_solve`` and ``solve`` synchronize eagerly (under
``torch.cuda.set_sync_debug_mode("error")``) and capture, the replay
against the eager result, and the time of each way (complex128 and
complex64, N = 10 and 1024); whether the card's PyTorch offers
conditional graph nodes; then ``expm`` of a 1024 × 1024 complex128 step
eagerly and replayed.

``chunks``: the stepwise ODE propagations of ``chip_smoke.py`` phase 19
(the N = 1024 sparse Hermitian ``pwc=True`` and continuous, the N = 10
transmon ``pwc=True``, the L = 20 chain ``pwc=True``) through their
graphed sites with ``utils/scan.WHILE_CHUNK`` set to 4, 8 and 16 (a new
propagator each, so each captures its own chunk), in the order 4, 8,
16, 16, 8, 4 for the small systems: steps/s of a timed run after the
capturing one, and the flag reads and attempts an interval.

Prints one line a measurement and a last JSON line with every number.
Without an argument it runs both parts.  Imports no jax."""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def _events_ms(fn, reps=20):
    """Milliseconds a call of ``fn``, between CUDA events over ``reps``
    calls after two warm-ups."""
    for _ in range(2):
        fn()
    start, stop = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _syncs(fn):
    """Whether ``fn`` synchronizes the host with the card (the sync debug
    mode's error), as a string."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return "no"
    except RuntimeError as exc:
        return f"yes ({str(exc).splitlines()[0][:80]})"
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _graphed(fn):
    """``fn`` captured as a CUDA graph: ``(replay, static output)``, or
    the error of the capture as a string."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn()
    except Exception as exc:  # the capture's own refusal, reported
        torch.cuda.synchronize()
        return f"refused: {type(exc).__name__}: " \
               f"{str(exc).splitlines()[0][:100]}"
    return graph.replay, out


def solve_part(card):
    from quantumpropagators_torch.ops.expprop import expm

    device = torch.device("cuda", 0)
    lib = str(torch.backends.cuda.preferred_linalg_library())
    chip_smoke.log(f"solve: preferred linalg library {lib} [{card}]")
    out = {"preferred_linalg_library": lib, "cases": []}
    rng = np.random.default_rng(5)
    for dtype in (torch.complex128, torch.complex64):
        for n in (10, 1024):
            M = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
            Q = torch.as_tensor(np.eye(n) + M / (4 * np.sqrt(n)),
                                device=device).to(dtype)
            P = torch.as_tensor(rng.standard_normal((n, n)), device=device
                                ).to(dtype)
            ways = {
                "solve_ex": lambda: torch.linalg.solve_ex(
                    Q, P, check_errors=False)[0],
                "lu_factor_ex+lu_solve": lambda: torch.linalg.lu_solve(
                    *torch.linalg.lu_factor_ex(Q, check_errors=False)[:2],
                    P),
                "solve": lambda: torch.linalg.solve(Q, P),
            }
            for name, fn in ways.items():
                want = fn()
                row = {"dtype": str(dtype), "n": n, "call": name,
                       "eager_syncs": _syncs(fn),
                       "eager_ms": _events_ms(fn)}
                got = _graphed(fn)
                if isinstance(got, str):
                    row["capture"] = got
                else:
                    replay, static = got
                    replay()
                    torch.cuda.synchronize()
                    row["capture"] = "ok"
                    row["replay_equal"] = bool(torch.equal(static, want))
                    row["replay_ms"] = _events_ms(replay)
                out["cases"].append(row)
                chip_smoke.log(f"solve: {row} [{card}]")
    n = 1024
    M = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = torch.as_tensor(-1j * (M + M.conj().T) / np.sqrt(n), device=device)
    out["if_node"] = if_node_part(card)
    want = expm(A)
    replay, static = _graphed(lambda: expm(A))
    replay()
    torch.cuda.synchronize()
    row = {"n": n, "norm1": float(torch.linalg.matrix_norm(A, ord=1)),
           "eager_ms": _events_ms(lambda: expm(A)),
           "replay_ms": _events_ms(replay),
           "replay_equal": bool(torch.equal(static, want)),
           "matmul_ms": _events_ms(lambda: A @ A)}
    out["expm"] = row
    chip_smoke.log(f"solve: expm {row} [{card}]")
    return out


def if_node_part(card):
    """Whether the card's PyTorch offers conditional graph nodes
    (``CUDAGraph.begin_capture_to_if_node``), which would let a masked
    iteration past a loop's end, or a squaring ``expm`` does not need,
    skip its work."""
    row = {"torch": torch.__version__, "offers_if_node": hasattr(
        torch.cuda.CUDAGraph(), "begin_capture_to_if_node")}
    chip_smoke.log(f"solve: conditional nodes {row} [{card}]")
    return row


def chunks_part(card):
    import scipy.sparse as sp

    import quantumpropagators_torch as qt
    from quantumpropagators_torch.utils import scan

    device = torch.device("cuda", 0)
    H, psi_h = chip_smoke.sparse_hermitian()
    op = qt.csr_from_scipy(H, device=device)
    psi = torch.as_tensor(psi_h, device=device)
    N = 10
    a = sp.diags(np.sqrt(np.arange(1, N, dtype=float)), 1).toarray()
    n_op = a.T @ a
    H0 = 6.0 * n_op - 0.1 * (n_op @ (n_op - np.eye(N)))
    transmon = qt.hamiltonian(
        qt.dia_from_scipy(sp.csr_matrix(H0), device=device),
        (qt.dia_from_scipy(sp.csr_matrix(a + a.T), device=device),
         lambda t: 0.3 * float(np.cos(5.8 * t))))
    psi_t = torch.as_tensor(np.eye(N)[0].astype(complex), device=device)
    _, chain = chip_smoke.tfim_generator(chip_smoke.ODE_L, device)
    psi_c = chip_smoke.random_state(chip_smoke.ODE_L, torch.complex128,
                                    device, chip_smoke.SEED + 190)
    dt = chip_smoke.DT
    paths = {
        "sparse N=1024 pwc": (psi, qt.hamiltonian(
            op, (op, lambda t: 0.5 * float(np.cos(2.0 * t)))),
            np.linspace(0.0, 10.0, 21), dict(pwc=True)),
        "sparse N=1024 continuous": (psi, qt.hamiltonian(
            op, (op, lambda t: 0.5 * torch.cos(2.0 * t))),
            np.linspace(0.0, 10.0, 21), dict(pwc=False)),
        "transmon N=10 pwc": (psi_t, transmon, np.linspace(0.0, 1.0, 11),
                              dict(pwc=True)),
        f"chain L={chip_smoke.ODE_L} pwc": (
            psi_c, chain, np.linspace(0.0, 2 * dt, 3), dict(pwc=True)),
    }
    rows, chosen = [], scan.WHILE_CHUNK
    for K in (4, 8, 16, 16, 8, 4):
        for name, (p0, gen, tlist, kw) in paths.items():
            if name.startswith("chain") and K in [r["K"] for r in rows
                                                  if r["path"] == name]:
                continue  # device-bound: once a K
            scan.WHILE_CHUNK = K
            prop = qt.init_prop(p0, gen, tlist, method="ode", **kw)
            chip_smoke._stepwise(prop, p0)  # the first interval and capture
            _, t, reads, att = chip_smoke._stepwise(prop, p0, True)
            row = {"K": K, "path": name, "steps_s": len(reads) / t,
                   "reads_per_interval": float(np.mean(reads)),
                   "attempts_per_interval": float(np.mean(att)),
                   "captures": prop._step.captures}
            rows.append(row)
            chip_smoke.log(f"chunks: {row} [{card}]")
            del prop
    scan.WHILE_CHUNK = chosen
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("ode_graph_sweep: no CUDA device", file=sys.stderr)
        return 1
    parts = argv or ["solve", "chunks"]
    card = chip_smoke.card_line()
    out = {"card": card}
    t0 = time.perf_counter()
    if "solve" in parts:
        out["solve"] = solve_part(card)
    if "chunks" in parts:
        out["chunks"] = chunks_part(card)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
