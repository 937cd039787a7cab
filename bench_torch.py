"""Benchmark script of the PyTorch/CUDA port: ``bench.py``'s measurements
on :mod:`quantumpropagators_torch`.

Each mode measures what the same mode of ``bench.py`` measures and prints
ONE JSON line to stdout with ``bench.py``'s ``metric`` name, ``unit``,
``value`` and ``vs_baseline`` definitions and ``extra`` keys, plus the
key ``card`` (the ``nvidia-smi --query-gpu=name,power.limit`` line; null
on the CPU).  ``platform`` is the torch device type.  Diagnostics go to
stderr.

    python3 bench_torch.py                       # 2^20, then 2^24 (dd)
    python3 bench_torch.py --L 20 --kernel fused
    python3 bench_torch.py --lattice2d 4x6 --kernel dd --steps 5
    python3 bench_torch.py --config northstar    # also rabi, transmon,
                                                 # newton, optomech,
                                                 # banded20, multiamp
    python3 bench_torch.py --suite
    python3 bench_torch.py --config rabi --device cpu

``--device`` (default ``cuda``) is the only flag ``bench.py`` lacks; with
no GPU the script raises unless it is ``cpu``.  The TPU tuning flags
``--fast``/``--no-fast``/``--dd-variant``/``--tile-rows``/``--group-bits``
are accepted so that ``bench.py`` command lines run unchanged: the port
has one kernel per tier, which they select among nothing (``extra``
records ``"variant": "n/a (one kernel)"``).

Timing follows ``bench.py``: a headline run is timed as ``t(3n) − t(n)``
after one warm-up of each length, every timed call ending in
``torch.cuda.synchronize()`` and one scalar read.  Every step loop that
``bench.py`` runs as a jitted ``lax.scan`` (the headline kernels,
northstar's chunks, banded20, and multiamp through
``cheby_propagate_fused``) runs through the port's scan
(``quantumpropagators_torch.utils.scan``): on the card one CUDA graph of
a step, replayed per step.  Each loop keeps its graph
(:func:`step_scan`): the warm-up run captures it, and the timed runs of
every length replay it.  The per-step error
of the reference tier is taken against a float64 numpy oracle on the
host (``v[idx ^ (1 << j)]`` flips), independent of the code under test.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from quantumpropagators_torch import profiling
from quantumpropagators_torch.profiling import HBM_BYTES_S

VARIANT = "n/a (one kernel)"


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def card_line(device):
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    None on the CPU."""
    return profiling.card_line() if device.type == "cuda" else None


def finish(device, x) -> float:
    """Wait for the device, then read the one-element tensor ``x``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return float(x.item())


def step_scan(step):
    """``run(carry, n)``: the final carry of the port's scan of
    ``step(carry, None) -> (carry, None)`` over ``n`` steps, through one
    :class:`~quantumpropagators_torch.utils.scan.GraphedScan`: the first
    run captures, and every later run replays, whatever its length (the
    step reads no per-step input and writes no per-step output).  A step
    that takes ``out`` writes its new carry there, so that the replays
    copy no carry."""
    from quantumpropagators_torch.utils.scan import GraphedScan

    scan = GraphedScan(step)
    return lambda carry, n: scan(carry, None, n)[0]


def result(metric, value, unit, vs_baseline, extra, device):
    return {"metric": metric, "value": value, "unit": unit,
            "vs_baseline": vs_baseline, "extra": extra,
            "card": card_line(device)}


def build_tfim_scipy(L, J=1.0, g=1.2, h=0.3):
    """Reference-style CSR assembly of the same Hamiltonian."""
    import scipy.sparse as sp

    I = sp.identity(2, format="csr", dtype=np.complex128)
    X = sp.csr_matrix(np.array([[0, 1], [1, 0]], dtype=np.complex128))
    Z = sp.csr_matrix(np.array([[1, 0], [0, -1]], dtype=np.complex128))

    def site(op, i):
        out = sp.identity(1, format="csr", dtype=np.complex128)
        for j in range(L):
            out = sp.kron(out, op if j == i else I, format="csr")
        return out

    H = sp.csr_matrix((2 ** L, 2 ** L), dtype=np.complex128)
    for i in range(L - 1):
        H = H + J * (site(Z, i) @ site(Z, i + 1))
    for i in range(L):
        H = H + h * site(Z, i) + g * site(X, i)
    return H.tocsr()


def cpu_csr_baseline(L_ref: int) -> float:
    """scipy CSR matvec throughput in Gnnz/s (per core, like the
    reference's default single-threaded SpMV)."""
    H = build_tfim_scipy(L_ref)
    rng = np.random.default_rng(0)
    psi = rng.standard_normal(2 ** L_ref) + 1j * rng.standard_normal(2 ** L_ref)
    H @ psi  # warm
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        psi = H @ psi
    dt = time.perf_counter() - t0
    gnnz = reps * H.nnz / dt / 1e9
    log(f"CPU scipy CSR baseline: L={L_ref}, nnz={H.nnz}, {gnnz:.3f} Gnnz/s")
    return gnnz


def flip_oracle_step(psi, diag, g, L, coeffs, delta, e_min, dt):
    """One forward Chebyshev step of ``H = diag + g·Σ_j X_j`` in float64
    numpy on the host: the flip of index bit ``j`` (``v[idx ^ (1 << j)]``)
    is ``v`` viewed as ``(−1, 2, 2^j)`` with the middle axis reversed,
    summed in place over the bits."""
    def h_apply(v):
        flips = np.zeros_like(v)
        for j in range(L):
            acc = flips.reshape(-1, 2, 1 << j)
            acc += v.reshape(-1, 2, 1 << j)[:, ::-1]
        flips *= g
        flips += diag * v
        return flips

    beta = delta / 2 + e_min
    c = -2j / delta
    v0 = psi
    v1 = c * (h_apply(v0) - beta * v0)
    phi = coeffs[0] * v0 + coeffs[1] * v1
    for a in coeffs[2:]:
        v2 = 2.0 * c * (h_apply(v1) - beta * v1) + v0
        phi = phi + a * v2
        v0, v1 = v1, v2
    return np.exp(-1j * beta * dt) * phi


def bench_rabi(device):
    """BASELINE config 1: 2-level Rabi, 100-step Chebyshev — steps/s.

    A latency metric (N=2 has no FLOPs to speak of): the 100-step
    propagation is a plain Python step loop on complex64 tensors (the
    reference's host step loop, ``src/propagate.jl:283``), timed end to
    end."""
    from quantumpropagators_torch.ops.cheby import cheby_coeffs

    n_steps = 100
    dt = 0.1
    omega, rabi = 1.0, 0.5
    delta = 2 * np.sqrt(omega**2 + rabi**2)
    e_min = -delta / 2
    a = [float(x) for x in cheby_coeffs(delta, dt).astype(np.float32)]
    tgrid = np.arange(n_steps) * dt + dt / 2
    eps = [float(e) for e in np.cos(0.2 * tgrid).astype(np.float32)]
    beta = float(np.float32(delta / 2 + e_min))
    phase = complex(np.exp(-1j * beta * dt))
    kw = dict(dtype=torch.complex64, device=device)
    H0 = torch.tensor([[0.5 * omega, 0.0], [0.0, -0.5 * omega]], **kw)
    X = rabi * torch.tensor([[0.0, 1.0], [1.0, 0.0]], **kw)

    def run():
        psi = torch.tensor([1.0, 0.0], **kw)
        for e in eps:
            H = H0 + e * X
            v0 = psi
            v1 = (-2j / delta) * (H @ v0 - beta * v0)
            phi = a[0] * v0 + a[1] * v1
            for ak in a[2:]:
                v2 = (-4j / delta) * (H @ v1 - beta * v1) + v0
                phi = phi + ak * v2
                v0, v1 = v1, v2
            psi = phase * phi
        return finish(device, torch.linalg.vector_norm(psi))

    run()  # warm
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        nrm = run()
    elapsed = time.perf_counter() - t0
    steps_per_s = reps * n_steps / elapsed
    log(f"rabi: {steps_per_s:.0f} steps/s, ‖Ψ‖={nrm:.6f} on {device.type}")
    return result(
        "rabi_2level_cheby_steps", round(steps_per_s, 1), "steps/s", None,
        {"n_steps": n_steps, "platform": device.type,
         "state_norm_after": round(nrm, 7)}, device)


def transmon_ladder(N=10):
    """The driven transmon ladder of BASELINE config 2: host ``(H0, Hd,
    eps)``."""
    import scipy.sparse as sp

    a = sp.diags(np.sqrt(np.arange(1, N, dtype=float)), 1).tocsr()
    ad = a.conj().T.tocsr()
    n_op = (ad @ a).tocsr()
    alpha = -0.2
    H0 = (6.0 * n_op + 0.5 * alpha * (n_op @ (n_op - sp.identity(N)))).tocsr()
    Hd = (a + ad).tocsr()
    return H0, Hd, lambda t: 0.3 * float(np.cos(5.8 * t))


def bench_transmon(device):
    """BASELINE config 2: driven transmon ladder N=10, Newton vs Cheby
    matvec counts per 100 steps (reference
    ``docs/src/benchmarks/profiling.md:112``: ≈2000 vs ≈1200 at N=200)
    plus wall-clock steps/s for each method, and the complex128 Newton,
    expv and fixed-Leja Newton against a float64 host oracle."""
    from scipy.linalg import expm

    import quantumpropagators_torch as qt
    from quantumpropagators_torch.models.controls import \
        discretize_on_midpoints
    from quantumpropagators_torch.ops.newton_leja import \
        newton_leja_propagate_dd
    from quantumpropagators_torch.utils.timings import (
        disable_timings, enable_timings,
    )

    N = 10
    H0, Hd, eps = transmon_ladder(N)
    gen = qt.hamiltonian(qt.dia_from_scipy(H0, device=device),
                         (qt.dia_from_scipy(Hd, device=device), eps))
    psi0 = np.zeros(N, complex)
    psi0[0] = 1.0
    tlist = np.linspace(0.0, 10.0, 101)  # 100 steps
    # host spectral envelope over the control range (N=10 is host-trivial)
    H0d, Hdd = H0.toarray(), Hd.toarray()
    ev = np.concatenate([np.linalg.eigvalsh(H0d - 0.3 * Hdd),
                         np.linalg.eigvalsh(H0d + 0.3 * Hdd)])
    buf = 0.02 * (ev.max() - ev.min())
    sr_kw = dict(specrange_method="manual", E_min=float(ev.min() - buf),
                 E_max=float(ev.max() + buf))
    # the JAX script's device state: complex64 from f32 planes
    psi_dev = torch.as_tensor(psi0.astype(np.complex64), device=device)

    results = {}
    psis = {}
    enable_timings()
    try:
        for method, kw in (("cheby", dict(sr_kw)),
                           ("newton", {"m_max": 8, "precision": "native"})):
            prop = qt.init_prop(psi_dev, gen, tlist, method=method, **kw)
            while qt.prop_step(prop) is not None:  # warm
                pass
            prop = qt.init_prop(psi_dev, gen, tlist, method=method, **kw)
            t0 = time.perf_counter()
            psi = None
            nxt = qt.prop_step(prop)
            while nxt is not None:
                psi, nxt = nxt, qt.prop_step(prop)
            finish(device, psi[0].real)
            elapsed = time.perf_counter() - t0
            psis[method] = psi.cpu().numpy().astype(np.complex128)
            matvecs = int(prop.timing_data.counters.get("matvec", 0))
            results[method] = {
                "matvecs_per_100_steps": matvecs,
                "steps_per_s": round(100 / elapsed, 1),
            }
            log(f"transmon {method}: {matvecs} matvecs, "
                f"{100 / elapsed:.1f} steps/s")
    finally:
        disable_timings()
    agree = float(np.linalg.norm(psis["cheby"] - psis["newton"]))
    log(f"transmon newton-vs-cheby agreement: {agree:.2e}")

    # complex128 Newton and expv against the float64 host oracle
    vals = discretize_on_midpoints(eps, tlist)
    psi_oracle = psi0.copy()
    for n in range(len(tlist) - 1):
        Hn = H0d + vals[n] * Hdd
        psi_oracle = expm(-1j * (tlist[n + 1] - tlist[n]) * Hn) @ psi_oracle

    dd_errs = {}
    dd_rates = {}
    dd_terms = [H0.astype(np.float64), Hd.astype(np.float64)]
    psi_c = torch.as_tensor(psi0, device=device)
    for method, kw in (("newton", {"m_max": 8}),
                       ("expv", {"m_max": 10})):  # m=N: exact subspace
        prop = qt.init_prop(psi_c, gen, tlist, method=method,
                            precision="dd", dd_operator_terms=dd_terms, **kw)
        while qt.prop_step(prop) is not None:
            pass
        got = prop.state_dd.cpu().numpy()
        dd_errs[method] = float(np.abs(got - psi_oracle).max())
        prop = qt.init_prop(psi_c, gen, tlist, method=method,
                            precision="dd", dd_operator_terms=dd_terms, **kw)
        t0 = time.perf_counter()
        while qt.prop_step(prop) is not None:
            pass
        finish(device, prop.state_dd[0].real)
        dd_rates[method] = round(100 / (time.perf_counter() - t0), 1)
        log(f"transmon {method} dd: err vs f64 oracle "
            f"{dd_errs[method]:.2e}, {dd_rates[method]} steps/s")

    # fixed-Leja Newton over the whole 100-step drive
    def leja():
        return newton_leja_propagate_dd(
            psi_c, gen, tlist, tol=1e-13, dd_operator_terms=dd_terms,
            e_min=sr_kw["E_min"], e_max=sr_kw["E_max"],
        )

    out, _, plan = leja()
    finish(device, out[0].real)  # warm
    t0 = time.perf_counter()
    out, _, plan = leja()
    finish(device, out[0].real)
    leja_rate = round(100 / (time.perf_counter() - t0), 1)
    leja_err = float(np.abs(out.cpu().numpy() - psi_oracle).max())
    log(f"transmon fixed-leja newton: n={len(plan.points)}, "
        f"err {leja_err:.2e}, {leja_rate} steps/s")

    return result(
        "transmon_ladder_matvecs_newton_vs_cheby",
        results["newton"]["matvecs_per_100_steps"], "matvecs/100steps",
        round(results["newton"]["matvecs_per_100_steps"]
              / max(results["cheby"]["matvecs_per_100_steps"], 1), 2),
        {**{f"{m}_{k}": v for m, r in results.items() for k, v in r.items()},
         "newton_vs_cheby_state_diff": agree,
         "newton_dd_err_vs_f64_oracle": dd_errs["newton"],
         "expv_dd_err_vs_f64_oracle": dd_errs["expv"],
         "newton_dd_steps_per_s": dd_rates["newton"],
         "expv_dd_steps_per_s": dd_rates["expv"],
         "leja_dd_err_vs_f64_oracle": leja_err,
         "leja_dd_steps_per_s": leja_rate,
         "leja_n_nodes": len(plan.points)}, device)


def bench_newton(device, N: int = 1024):
    """Restarted-Arnoldi Newton timing: an N=1024 random sparse Hermitian
    with spectral radius 10 — the reference's Newton test configuration
    (``test/test_newton.jl:20``) — stepped in complex64, then in
    complex128 (adaptive Newton, and fixed-Leja Newton over 100 steps),
    each against host ``expm``."""
    import scipy.sparse as sp
    from scipy.linalg import expm
    from scipy.sparse.linalg import eigsh

    from quantumpropagators_torch.ops.dd_linalg import cdd_op_from_matrix
    from quantumpropagators_torch.ops.df64 import cdd_from_c128
    from quantumpropagators_torch.ops.newton import (
        NewtonInfo, newton_apply, newton_apply_dd,
    )
    from quantumpropagators_torch.ops.newton_leja import \
        newton_leja_propagate_dd
    from quantumpropagators_torch.ops.operators import bsr_from_scipy

    rng = np.random.default_rng(42)
    A = sp.random(N, N, density=0.01, random_state=rng,
                  data_rvs=rng.standard_normal)
    H = (0.5 * (A + A.T)).tocsr()
    lam_max = abs(eigsh(H, k=1, which="LA", return_eigenvectors=False)[0])
    lam_min = abs(eigsh(H, k=1, which="SA", return_eigenvectors=False)[0])
    H = H * (10.0 / max(lam_max, lam_min))
    H64 = H.astype(np.float64)
    op = bsr_from_scipy(H.astype(np.float32), block_size=32,
                        dtype=torch.float32, device=device)
    psi0 = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    psi0 /= np.linalg.norm(psi0)
    psi = torch.as_tensor(psi0.astype(np.complex64), device=device)
    dt = 0.5
    n_steps = 20
    relerr = 1e-6  # complex64 state

    def run(psi, info):
        for _ in range(n_steps):
            psi = newton_apply(op, psi, dt, m_max=10, relerr=relerr,
                               info=info)
        return psi

    run(psi, NewtonInfo())  # warm
    info = NewtonInfo()
    t0 = time.perf_counter()
    out = run(psi, info)
    nrm = finish(device, torch.linalg.vector_norm(out))
    elapsed = time.perf_counter() - t0
    steps_per_s = n_steps / elapsed
    matvecs_per_step = info.matvecs / n_steps
    Hd = H64.toarray()
    exact = np.linalg.matrix_power(expm(-1j * Hd * dt), n_steps) @ psi0
    err = float(np.abs(out.cpu().numpy().astype(np.complex128) - exact).max())
    log(f"newton on {device.type}: {steps_per_s:.2f} steps/s, "
        f"{matvecs_per_step:.0f} matvecs/step, err={err:.2e} "
        f"(complex64 state), ‖Ψ‖={nrm:.6f}")

    # adaptive restarted Newton in complex128 on the same operator
    op_dd = cdd_op_from_matrix(H64, sparse=True, block_size=32,
                               device=device)
    n_dd_steps = 5

    def run_dd(psi_dd, info):
        for _ in range(n_dd_steps):
            psi_dd = newton_apply_dd(op_dd, psi_dd, dt, m_max=10,
                                     relerr=1e-12, info=info)
        return psi_dd

    psi_dd0 = cdd_from_c128(psi0, device=device)
    run_dd(psi_dd0, NewtonInfo())  # warm
    t0 = time.perf_counter()
    out_dd = run_dd(psi_dd0, NewtonInfo())
    finish(device, out_dd[0].real)
    dd_steps_per_s = n_dd_steps / (time.perf_counter() - t0)
    exact_dd = np.linalg.matrix_power(expm(-1j * Hd * dt), n_dd_steps) @ psi0
    err_dd = float(np.abs(out_dd.cpu().numpy() - exact_dd).max())
    log(f"newton dd on {device.type}: {dd_steps_per_s:.2f} steps/s, "
        f"err={err_dd:.2e} (complex128 state, reference contract 1e-10)")

    # fixed-Leja Newton: one device loop over all steps, no host syncs
    lmax = float(eigsh(H64, k=1, which="LA", return_eigenvectors=False)[0])
    lmin = float(eigsh(H64, k=1, which="SA", return_eigenvectors=False)[0])
    buf = 0.01 * (lmax - lmin)
    n_leja_steps = 100
    tl = np.arange(0, (n_leja_steps + 1) * dt - 1e-9, dt)

    def leja_run():
        # dd_operator_terms=[dense] selects the dense complex128 matvec
        return newton_leja_propagate_dd(
            psi_dd0, H64, tl, dd_operator_terms=[Hd],
            e_min=lmin - buf, e_max=lmax + buf, tol=1e-13,
        )

    out_l, _, plan_l = leja_run()
    finish(device, out_l[0].real)
    t0 = time.perf_counter()
    out_l, _, plan_l = leja_run()
    finish(device, out_l[0].real)
    leja_steps_per_s = n_leja_steps / (time.perf_counter() - t0)
    exact_l = np.linalg.matrix_power(expm(-1j * Hd * dt), n_leja_steps) @ psi0
    err_l = float(np.abs(out_l.cpu().numpy() - exact_l).max())
    log(f"newton fixed-leja dd: {leja_steps_per_s:.1f} steps/s "
        f"({len(plan_l.points)} nodes/step), err={err_l:.2e}, "
        f"vs host-driven complex64 {steps_per_s:.2f} steps/s "
        f"({leja_steps_per_s / steps_per_s:.1f}x)")

    return result(
        "newton_restarted_arnoldi_steps", round(steps_per_s, 2), "steps/s",
        None,
        {"matvecs_per_step": round(matvecs_per_step, 1),
         "n_steps": n_steps, "dim": N,
         "err_vs_expm_f32_state": err,
         "dd_steps_per_s": round(dd_steps_per_s, 2),
         "dd_err_vs_expm": err_dd,
         "leja_dd_steps_per_s": round(leja_steps_per_s, 1),
         "leja_dd_err_vs_expm": err_l,
         "leja_nodes_per_step": len(plan_l.points),
         "leja_speedup_vs_host_driven":
             round(leja_steps_per_s / steps_per_s, 1),
         "platform": device.type}, device)


def bench_optomech(device, R: int = 1024, batch: int = 4096):
    """BASELINE config 3: optomech cavity (55-dim kron CSR).

    Blocked-ELL (BSR) vs gather-CSR apply throughput over ``batch``
    states as real planes; complex128 Chebyshev over 50 steps, ``expv`` and Newton
    against host ``expm``; then a chain of ``R`` coupled 64-level units
    (dim ``64·R``): BSR vs CSR, the complex128 BSR Chebyshev, and the
    same propagation re-blocked to 128-blocks on the banded SpMV kernel,
    cross-checked against the BSR chain (``banded_vs_xla_dd_diff``)."""
    import scipy.sparse as sp
    from scipy.linalg import expm

    from quantumpropagators_torch.ops.bsr_dd import (
        banded_dd_from_scipy, cheby_apply_dd_banded,
    )
    from quantumpropagators_torch.ops.cheby import cheby_coeffs
    from quantumpropagators_torch.ops.df64_sparse import (
        bsr_dd_from_scipy, cheby_apply_dd_bsr,
    )
    from quantumpropagators_torch.ops.expv import expv_apply_dd
    from quantumpropagators_torch.ops.newton import NewtonInfo, \
        newton_apply_dd
    from quantumpropagators_torch.ops.operators import (
        apply, bsr_from_scipy, csr_from_scipy,
    )

    def destroy(n):
        return sp.diags(np.sqrt(np.arange(1, n + 1)), 1)

    N_cav, N_mech = 4, 10
    a = sp.kron(destroy(N_cav), sp.identity(N_mech + 1), format="csr")
    b = sp.kron(sp.identity(N_cav + 1), destroy(N_mech), format="csr")
    at, bt = a.T.tocsr(), b.T.tocsr()
    H = (10.0 * (at @ a) + 10.0 * (bt @ b) + 2.0 * (a + at)
         - 1.0 * ((bt + b) @ (at @ a))).tocsr()
    H.eliminate_zeros()
    H = H.real.astype(np.float32)
    N = H.shape[0]

    def measure(H, batch, n_apply, block_size, reps=5):
        rng = np.random.default_rng(0)
        states = torch.as_tensor(
            rng.standard_normal((2 * batch, H.shape[0])),
            dtype=torch.float32, device=device,
        )  # re and im planes as a plain batch
        ops = {
            "bsr": bsr_from_scipy(H, block_size=block_size,
                                  dtype=torch.float32, device=device),
            "csr": csr_from_scipy(H, dtype=torch.float32, device=device),
        }
        rates = {}
        for name, op in ops.items():
            def run(v):
                for _ in range(n_apply):
                    v = apply(op, v)
                return finish(device, torch.sqrt(torch.sum(v ** 2)))

            run(states)
            t0 = time.perf_counter()
            for _ in range(reps):
                run(states)
            elapsed = time.perf_counter() - t0
            rates[name] = reps * n_apply * 2 * batch * H.nnz / elapsed / 1e9
            log(f"  {name} (dim {H.shape[0]}, batch {batch}): "
                f"{rates[name]:.2f} Gnnz/s")
        return rates

    log("optomech 55-dim (BASELINE config 3):")
    rates = measure(H, batch=batch, n_apply=100, block_size=8)

    # reference-accuracy path: complex128 BSR Chebyshev on the device,
    # error vs a float64 host oracle
    H64 = (0.5 * (H + H.T)).astype(np.float64).tocsr()
    op_dd = bsr_dd_from_scipy(H64, block_size=8, device=device)
    Npad = op_dd.shape[0]
    evals = np.linalg.eigvalsh(H64.toarray())
    e_min_o, delta_o = float(evals[0]), float(evals[-1] - evals[0])
    dt_o = 0.05
    rng = np.random.default_rng(5)
    psi = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    psi /= np.linalg.norm(psi)
    pp = np.zeros(Npad, complex)
    pp[:N] = psi
    coeffs_o = cheby_coeffs(delta_o, dt_o)
    n_steps_o = 50

    def run_dd():
        z = torch.as_tensor(pp, device=device)
        for _ in range(n_steps_o):
            z = cheby_apply_dd_bsr(op_dd, z, coeffs_o, delta_o, e_min_o, dt_o)
        return z.cpu().numpy()

    run_dd()  # warm
    t0 = time.perf_counter()
    got = run_dd()
    t_dd = time.perf_counter() - t0
    exact = expm(-1j * H64.toarray() * dt_o * n_steps_o) @ psi
    dd_err = float(np.abs(got[:N] - exact).max())
    dd_gnnz = n_steps_o * (len(coeffs_o) - 1) * 2 * H64.nnz / t_dd / 1e9
    log(f"  complex128 BSR cheby on-device: {n_steps_o} steps, "
        f"err={dd_err:.2e} (contract 1e-10), {dd_gnnz:.3f} Gnnz/s")
    if not dd_err < 1e-10:
        raise AssertionError(f"BSR cheby vs expm: {dd_err}")

    # BASELINE config 3 names "Arnoldi expm-Krylov": expv in complex128
    n_kry = 10
    z = torch.as_tensor(psi, device=device)
    t0 = time.perf_counter()
    for _ in range(n_kry):
        z = expv_apply_dd(H64, z, dt_o, m=30)
    got_k = z.cpu().numpy()[:N]
    t_kry = time.perf_counter() - t0
    exact_k = expm(-1j * H64.toarray() * dt_o * n_kry) @ psi
    expv_dd_err = float(np.abs(got_k - exact_k).max())
    log(f"  complex128 expv on-device: {n_kry} steps, "
        f"err={expv_dd_err:.2e} (contract 1e-10), {n_kry / t_kry:.1f} steps/s")
    if not expv_dd_err < 1e-10:
        raise AssertionError(f"expv vs expm: {expv_dd_err}")
    # ... and Newton on the same operator (config-3 cross-method)
    zn = torch.as_tensor(psi, device=device)
    info_n = NewtonInfo()
    for _ in range(n_kry):
        zn = newton_apply_dd(H64, zn, dt_o, m_max=12, relerr=1e-12,
                             info=info_n)
    newton_dd_err = float(np.abs(zn.cpu().numpy()[:N] - exact_k).max())
    log(f"  complex128 newton on-device: err={newton_dd_err:.2e}")
    if not newton_dd_err < 1e-10:
        raise AssertionError(f"newton vs expm: {newton_dd_err}")

    # the layout decision at scale: a chain of R coupled 64-level units
    # (dense on-site + dense hopping blocks), dim 2^16 at R = 1024
    bsz = 64
    rng = np.random.default_rng(1)
    blocks = []
    rows = []
    cols = []
    for r in range(R):
        for c in (r - 1, r, r + 1):
            if 0 <= c < R:
                rows.append(r)
                cols.append(c)
                blocks.append(rng.standard_normal((bsz, bsz))
                              .astype(np.float32))
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=R))]
    ).astype(np.int64)
    H2 = sp.bsr_matrix(
        (np.stack(blocks), np.asarray(cols), indptr),
        shape=(R * bsz, R * bsz),
    ).tocsr()
    log(f"block-dense chain {H2.shape[0]}-dim (nnz={H2.nnz}):")
    rates2 = measure(H2, batch=8, n_apply=4, block_size=bsz, reps=2)

    # complex128 BSR Chebyshev at scale
    H2sym = (0.5 * (H2 + H2.T)).astype(np.float64).tocsr()
    op2_dd = bsr_dd_from_scipy(H2sym, block_size=bsz, device=device)
    bound2 = float(np.abs(H2sym).sum(axis=1).max())
    e2, d2 = -bound2, 2 * bound2
    dt2 = 0.02
    c2 = cheby_coeffs(d2, dt2)
    rng = np.random.default_rng(9)
    z2 = torch.complex(
        torch.as_tensor(rng.standard_normal(H2sym.shape[0]), device=device),
        torch.as_tensor(rng.standard_normal(H2sym.shape[0]), device=device),
    )
    n2_steps = 2

    def run_dd2(z):
        for _ in range(n2_steps):
            z = cheby_apply_dd_bsr(op2_dd, z, c2, d2, e2, dt2)
        return z

    def timed_pair(run):
        """``bench.py``'s timing of a short run: one call, then three;
        the difference is two calls."""
        t0 = time.perf_counter()
        finish(device, run(z2).abs().square().sum())
        t_a = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(3):
            out = run(z2)
        finish(device, out.abs().square().sum())
        t_b = time.perf_counter() - t0
        return max(t_b - t_a, 1e-9) / 2

    finish(device, run_dd2(z2).abs().square().sum())  # warm
    dd2_elapsed = timed_pair(run_dd2)
    dd2_gnnz = n2_steps * (len(c2) - 1) * 2 * H2sym.nnz / dd2_elapsed / 1e9
    log(f"  complex128 BSR cheby at dim {H2sym.shape[0]} "
        f"({len(c2)} orders/step): {dd2_gnnz:.2f} Gnnz/s")

    # the same propagation re-blocked to 128-blocks on the banded SpMV
    # kernel, cross-checked against the BSR chain's result
    opb = banded_dd_from_scipy(H2sym, device=device)
    log(f"  banded re-block: offsets={opb.offsets}, R={opb.R}, b={opb.b}")

    def run_banded(z):
        for _ in range(n2_steps):
            z = cheby_apply_dd_banded(opb, z, c2, d2, e2, dt2, tile_rows=8)
        return z

    zb = run_banded(z2)  # warm
    z_ref = run_dd2(z2)
    diff = float((zb.real - z_ref.real).abs().max()
                 + (zb.imag - z_ref.imag).abs().max())
    banded_elapsed = timed_pair(run_banded)
    banded_gnnz = (
        n2_steps * (len(c2) - 1) * 2 * H2sym.nnz / banded_elapsed / 1e9
    )
    log(f"  banded SpMV kernel cheby at dim {H2sym.shape[0]}: "
        f"{banded_gnnz:.2f} Gnnz/s (logical nnz), "
        f"vs-BSR-chain diff={diff:.2e}")
    return result(
        "optomech_bsr_spmv_throughput", round(rates["bsr"], 3), "Gnnz/s",
        round(rates["bsr"] / rates["csr"], 2),
        {"gather_csr_gnnzs": round(rates["csr"], 3),
         "df64_bsr_cheby_err_50steps": dd_err,
         "df64_bsr_cheby_gnnzs": round(dd_gnnz, 4),
         "batch": batch, "nnz": int(H.nnz), "dim": N,
         "scaled_dim": int(H2.shape[0]),
         "scaled_bsr_gnnzs": round(rates2["bsr"], 3),
         "scaled_csr_gnnzs": round(rates2["csr"], 3),
         "scaled_speedup": round(rates2["bsr"] / rates2["csr"], 2),
         "scaled_dd_gnnzs": round(dd2_gnnz, 3),
         "scaled_banded_pallas_dd_gnnzs": round(banded_gnnz, 3),
         "banded_vs_xla_dd_diff": diff,
         "expv_dd_err_on_device": expv_dd_err,
         "newton_dd_err_on_device": newton_dd_err,
         "platform": device.type}, device)


def bench_banded20(device, L_dim: int = 20, tile_rows: int = 8, dt=None):
    """The banded SpMV kernel at 2^20 — the BASELINE config-5 single-chip
    anchor through the BSR layout (dense 128-blocks), with a stated
    roofline.

    Operator: block-tridiagonal chain of 2^L_dim/128 coupled 128-level
    units with dense symmetric on-site and dense hopping blocks — every
    stored float is a logical nonzero.  The band planes are built once,
    outside the timed window.  Roofline: each polynomial order reads the
    float64 planes once (8 B per stored entry; re and im are the two
    matvecs ``bench.py`` counts) at the H100's HBM rate; the vectors add
    about 1 %."""
    from quantumpropagators_torch.ops.bsr_dd import (
        BandedDD, banded_dd_apply, cheby_apply_dd_banded,
    )
    from quantumpropagators_torch.ops.cheby import cheby_coeffs
    from quantumpropagators_torch.parallel.mesh import chain_mesh, \
        shard_vector
    from quantumpropagators_torch.parallel.sharded_banded import (
        make_sharded_banded_cheby_step_dd, partition_banded_dd,
    )

    b = 128
    N = 2 ** L_dim
    R = N // b
    rng = np.random.default_rng(33)
    scale = 1.0 / np.sqrt(3 * b)
    # planes[k, i, r, o] = A[r*b+o, (r+offset_k)*b+i], offsets (-1,0,1)
    planes = np.zeros((3, b, R, b), dtype=np.float64)
    D = rng.standard_normal((R, b, b))
    D = 0.5 * (D + D.transpose(0, 2, 1)) * scale
    U = rng.standard_normal((R - 1, b, b)) * scale
    planes[1] = D.transpose(2, 0, 1)               # (i, r, o) = D[r][o,i]
    planes[2, :, : R - 1, :] = U.transpose(2, 0, 1)  # block (r, r+1)=U[r]
    planes[0, :, 1:, :] = U.transpose(1, 0, 2)       # block (r, r-1)=U[r-1]^T
    del D, U
    nnz = 3 * R * b * b - 2 * b * b
    nnz_stored = 3 * R * b * b
    op = BandedDD(
        planes=torch.as_tensor(planes, device=device), offsets=(-1, 0, 1),
        R=R, b=b, shape=(N, N), logical_nnz=nnz,
    )
    # Gershgorin bound from the |planes| row sums
    bound = float(np.abs(planes).sum(axis=(0, 1)).max())
    e_min, delta = -bound, 2 * bound
    if dt is None:
        dt = 6.0 / delta  # Δ·dt/2 = 3 → ~19 coefficients (headline-like)
    c64 = cheby_coeffs(delta, dt)
    n_coeffs = len(c64)
    log(f"banded20 on {device.type}: dim 2^{L_dim}, R={R}, b={b}, "
        f"{n_coeffs} coefficients/step, tile_rows={tile_rows}")
    x64 = rng.standard_normal(N)
    y64 = rng.standard_normal(N)
    s = np.sqrt((x64 ** 2 + y64 ** 2).sum())
    x64, y64 = x64 / s, y64 / s

    # correctness: one matvec vs the host f64 contraction
    yd = banded_dd_apply(op, torch.as_tensor(x64 + 0j, device=device),
                         tile_rows=tile_rows)
    got = yd.real.cpu().numpy()
    xb = x64.reshape(R, b)
    want = np.einsum("iro,ri->ro", planes[1], xb)
    want[: R - 1] += np.einsum("iro,ri->ro", planes[2, :, : R - 1], xb[1:])
    want[1:] += np.einsum("iro,ri->ro", planes[0, :, 1:], xb[: R - 1])
    want = want.reshape(-1)
    del planes
    mv_err = float(np.abs(got - want).max() / np.abs(want).max())
    log(f"banded20 matvec vs f64: rel err {mv_err:.2e}")
    if not mv_err < 1e-13:
        raise AssertionError(f"banded20 matvec vs f64: {mv_err}")

    z0 = torch.as_tensor(x64 + 1j * y64, device=device)

    scans = step_scan(lambda z, _, out=None: (cheby_apply_dd_banded(
        op, z, c64, delta, e_min, dt, tile_rows=tile_rows, out=out), None))

    def run(z, n_steps):
        return finish(device, scans(z, n_steps)[0].real)

    na, nb_ = (3, 9) if device.type == "cuda" else (1, 3)
    run(z0, 1)  # warm: capture
    t0 = time.perf_counter()
    run(z0, na)
    ta = time.perf_counter() - t0
    t0 = time.perf_counter()
    run(z0, nb_)
    tb = time.perf_counter() - t0
    t_steps = (tb - ta) / (nb_ - na)
    matvecs = 2 * (n_coeffs - 1)  # re+im per order
    gnnz = matvecs * nnz_stored / t_steps / 1e9
    bound_gnnz = 2 * HBM_BYTES_S / 8 / 1e9
    log(f"banded20: {gnnz:.2f} Gnnz/s ({t_steps:.4f} s/step, "
        f"{matvecs} matvecs/step), HBM bound {bound_gnnz:.1f} Gnnz/s -> "
        f"{100 * gnnz / bound_gnnz:.0f}%")

    # sharded-step overhead: the sharded banded Chebyshev step on a
    # 1-slot mesh (halo exchange + clamped kernel + edge correction),
    # timed per call (min of 3)
    pb1 = partition_banded_dd(op, 1, tile_rows=tile_rows)
    mesh1 = chain_mesh(1, device=device)
    sstep = make_sharded_banded_cheby_step_dd(
        mesh1, pb1, delta=delta, e_min=e_min, dt=dt,
    )
    st0 = shard_vector(mesh1, z0)

    def srun(st, n):
        for _ in range(n):
            st = sstep(pb1, st, c64)
        return finish(device, st[0, 0].real)

    srun(st0, 1)  # warm
    n_probe = 6
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        srun(st0, n_probe)
        best = min(best, time.perf_counter() - t0)
    gnnz_sharded = n_probe * matvecs * nnz_stored / best / 1e9
    shard_overhead_pct = 100 * (1 - gnnz_sharded / gnnz)
    log(f"banded20 sharded step (1-slot mesh): {gnnz_sharded:.2f} Gnnz/s "
        f"-> sharding overhead {shard_overhead_pct:.1f}% vs unsharded")
    return result(
        f"banded_dd_bsr_cheby_2^{L_dim}", round(gnnz, 2), "Gnnz/s", None,
        {"dim": N, "block": b, "n_bands": 3,
         "nnz_stored": nnz_stored,
         "matvecs_per_step": matvecs,
         "seconds_per_step": round(t_steps, 4),
         "matvec_rel_err_vs_f64": mv_err,
         "tile_rows": tile_rows,
         "variant": VARIANT,
         "roofline_bound_gnnz": round(bound_gnnz, 1),
         "pct_of_bound": round(100 * gnnz / bound_gnnz, 1),
         "roofline_model":
             "H100 HBM t=nnz_stored*8B/3.35TBps per order (re+im = 2 "
             "matvecs)",
         "sharded_step_1dev_gnnzs": round(gnnz_sharded, 2),
         "sharded_step_overhead_pct": round(shard_overhead_pct, 1),
         "platform": device.type}, device)


def multiamp_problem(device, L: int = 20):
    """``bench.py``'s multiamp workload at 2^L: the reference-shaped
    ``Ĥ₀ + Σₗ aₗ(t)Ĥₗ`` (a driven diagonal and two independently driven
    flip groups with per-site weights).  Returns ``(generator, psi0,
    envelope kwargs)``, ``psi0`` complex64 from seed 29."""
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.models.lattice import (
        SiteOperatorSum, transverse_field_ising,
    )

    J, h = 1.0, 0.3
    H_diag, _ = transverse_field_ising(L, J=J, g=1.0, h=h,
                                       dtype=torch.float32, device=device)
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    rng = np.random.default_rng(29)
    g_site = rng.uniform(0.9, 1.3, size=L)
    mats_odd = np.zeros((L, 2, 2))
    mats_even = np.zeros((L, 2, 2))
    for i in range(L):
        (mats_odd if i % 2 else mats_even)[i] = g_site[i] * sx

    def group(mats, parity):
        return SiteOperatorSum(
            torch.as_tensor(mats, dtype=torch.float32, device=device), L=L,
            active=tuple(i % 2 == parity for i in range(L)),
        )

    eps_d = lambda t: 1.0 + 0.3 * np.sin(0.9 * t)
    eps_o = lambda t: 1.2 + 0.4 * np.cos(1.7 * t)
    eps_e = lambda t: 0.9 + 0.5 * np.sin(2.3 * t)
    gen = qt.hamiltonian((H_diag, eps_d), (group(mats_odd, 1), eps_o),
                         (group(mats_even, 0), eps_e), check=False)
    psi0 = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi0 = torch.as_tensor((psi0 / np.linalg.norm(psi0)).astype(np.complex64),
                           device=device)
    bound = 1.3 * (J * (L - 1) + abs(h) * L) + 1.6 * float(
        np.abs(g_site).sum()
    )
    return gen, psi0, dict(specrange_method="manual", E_min=-bound,
                           E_max=bound)


def bench_multiamp(device, L: int = 20, n_steps: int = 20):
    """Per-bit f32 tail A/B on a DRIVEN multi-amplitude workload
    (:func:`multiamp_problem`) at 2^L, tail=auto vs tail=0."""
    from quantumpropagators_torch.fused import cheby_propagate_fused
    from quantumpropagators_torch.propagators.cheby import ChebyPropagator

    gen, psi0, kw = multiamp_problem(device, L)
    dt = 0.05
    nnz = (L + 1) * 2 ** L
    n_coeffs = int(ChebyPropagator(
        psi0, gen, np.linspace(0, n_steps * dt, n_steps + 1), **kw
    ).wrk.coeffs.shape[0])

    rates = {}
    psis = {}
    for tail_mode, tail_arg in (("auto", "auto"), ("zero", 0)):
        def run(n):
            tl = np.linspace(0.0, n * dt, n + 1)
            out, _ = cheby_propagate_fused(
                psi0, gen, tl, kernel="dd", f32_tail=tail_arg, **kw
            )
            finish(device, out[0].real)
            return out

        # min-of-3 same-length timing, as bench.py
        n_run = 3 * n_steps
        run(n_run)  # warm
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            outb = run(n_run)
            best = min(best, time.perf_counter() - t0)
        t_step = best / n_run
        rates[tail_mode] = 2 * (n_coeffs - 1) * nnz / t_step / 1e9
        psis[tail_mode] = outb.cpu().numpy()
        log(f"multiamp tail={tail_mode}: {rates[tail_mode]:.1f} Gnnz/s")
    diff = float(np.abs(psis["auto"] - psis["zero"]).max())
    log(f"multiamp A/B state diff (tail-auto vs tail-0): {diff:.2e}")
    return result(
        f"multiamp_dd_perbit_tail_2^{L}", round(rates["auto"], 2), "Gnnz/s",
        round(rates["auto"] / rates["zero"], 3),
        {"tail0_gnnzs": round(rates["zero"], 2),
         "speedup_from_perbit_tail": round(rates["auto"] / rates["zero"], 3),
         "state_diff_vs_tail0": diff,
         "n_steps": n_steps,
         "platform": device.type}, device)


def bench_northstar(device, n_steps: int = 1000, L: int = 24,
                    oracle: bool = True):
    """The literal BASELINE sentence — a 2^24-dim sparse lattice
    Hamiltonian propagated for 1000 Chebyshev steps, recorded end to end
    in one line: wall clock, norm drift, a 3-step f64-oracle error anchor
    (skipped with ``oracle=False``: null) and the forward+backward
    round-trip error over all 2×``n_steps`` steps."""
    from quantumpropagators_torch.models.lattice import (
        chain_bonds, ising_diagonal_np,
    )
    from quantumpropagators_torch.ops.cheby import cheby_coeffs
    from quantumpropagators_torch.ops.fused_cheby import make_flip_plan
    from quantumpropagators_torch.ops.fused_cheby_dd import (
        cheby_step_fused_dd, dd_tile_rows, f32_tail_orders,
    )

    J, g, h = 1.0, 1.2, 0.3
    N = 2 ** L
    dt = 0.05
    bound = J * (L - 1) + abs(h) * L + g * L
    e_min, delta = -bound, 2 * bound
    diag64 = ising_diagonal_np(L, chain_bonds(L), J, h)
    beta = delta / 2.0 + e_min
    plan = make_flip_plan(L, g, tile_rows=dd_tile_rows(L))
    c64 = np.asarray(cheby_coeffs(delta, dt))
    tail = f32_tail_orders(c64)
    log(f"northstar on {device.type}: 2^{L}, {n_steps} steps, "
        f"{len(c64)} coeffs/step, f32 tail {tail}")
    dmb = torch.as_tensor(diag64 - beta, device=device)
    rng = np.random.default_rng(1)
    re0 = rng.standard_normal(N)
    im0 = rng.standard_normal(N)
    nrm0 = np.sqrt((re0 ** 2 + im0 ** 2).sum())
    psi = (re0 + 1j * im0) / nrm0
    del re0, im0
    state0 = torch.as_tensor(psi, device=device)

    chunks = {sign: step_scan(lambda s, _, out=None, sign=sign: (
        cheby_step_fused_dd(plan, dmb, s, c64, delta, e_min, sign * dt,
                            forward=(sign > 0), f32_tail=tail, out=out),
        None)) for sign in (1, -1)}

    def run_chunk(state, n, sign):
        return chunks[sign](state, n)

    def norm(state):
        return finish(device, torch.linalg.vector_norm(state))

    norm(run_chunk(run_chunk(state0, 2, 1), 2, -1))  # warm both directions

    per_step_err = None
    if oracle:  # host f64, 3 steps (minutes at 2^24)
        got3 = run_chunk(state0, 3, 1).cpu().numpy()
        ref = psi
        for _ in range(3):
            ref = flip_oracle_step(ref, diag64, g, L, c64, delta, e_min, dt)
        per_step_err = float(np.abs(got3 - ref).max()) / 3.0
        del got3, ref
        log(f"northstar 3-step oracle: per-step err {per_step_err:.2e}")

    # the forward run, in chunks of 250 steps at 2^24 as bench.py
    chunk = n_steps if L <= 22 else min(250, n_steps)
    n_chunks, rem = divmod(n_steps, chunk)

    def run_all(state, sign):
        for _ in range(n_chunks):
            state = run_chunk(state, chunk, sign)
        if rem:
            state = run_chunk(state, rem, sign)
        return state

    norm(run_all(state0, 1))  # warm
    t0 = time.perf_counter()
    state = run_all(state0, 1)
    nrm = norm(state)
    t_fwd = time.perf_counter() - t0
    steps_per_s = n_steps / t_fwd
    matvecs = n_steps * (len(c64) - 1)
    nnz = (L + 1) * N  # diagonal + L site-flip planes
    gnnz = matvecs * nnz / t_fwd / 1e9
    log(f"northstar forward: {t_fwd:.1f} s for {n_steps} steps "
        f"({steps_per_s:.2f} steps/s, {gnnz:.1f} Gnnz/s), "
        f"norm drift {abs(nrm - 1.0):.2e}")

    # backward: n_steps more; the round-trip error
    back = run_all(state, -1)
    rt_err = float((back - state0).abs().max())
    log(f"northstar round trip ({2 * n_steps} steps): max err {rt_err:.2e}")
    return result(
        f"northstar_cheby_2^{L}_{n_steps}steps", round(steps_per_s, 3),
        "steps/s", None,
        {"wall_clock_s": round(t_fwd, 1),
         "n_steps": n_steps,
         "gnnz_per_s": round(gnnz, 1),
         "norm_drift": abs(nrm - 1.0),
         "per_step_err_vs_f64_oracle": per_step_err,
         "round_trip_2000_step_err": rt_err,
         "matvecs_per_step": len(c64) - 1,
         "f32_tail_orders": tail,
         "platform": device.type}, device)


J_TFIM, G_TFIM, H_TFIM = 1.0, 1.2, 0.3  # bench.py's headline TFIM


class TFIM(NamedTuple):
    """The headline problem at 2^L: operators, ``bench.py``'s analytic
    spectral bound, float64 Chebyshev coefficients, and the start state's
    float32 planes."""

    L: int
    label: str
    bonds: list
    H_diag: Any
    H_x: Any
    delta: float
    e_min: float
    dt: float
    coeffs: np.ndarray
    re32: np.ndarray
    im32: np.ndarray


def tfim_problem(device, L=20, lattice2d=None, dt=0.05) -> TFIM:
    """The TFIM chain of 2^L states, or the ``lattice2d = "LxxLy"``
    lattice, with float32 operators on ``device`` and the start state
    made as ``bench.py`` makes it: seed 1, normalised, rounded to
    float32."""
    from quantumpropagators_torch.models.lattice import (
        chain_bonds, lattice2d_bonds, transverse_field_ising,
        transverse_field_ising_2d,
    )
    from quantumpropagators_torch.ops.cheby import cheby_coeffs

    kw = dict(J=J_TFIM, g=G_TFIM, h=H_TFIM, dtype=torch.float32,
              device=device)
    if lattice2d:
        Lx, Ly = (int(v) for v in lattice2d.lower().split("x"))
        L = Lx * Ly
        log(f"device: {device}, 2D {Lx}x{Ly}, N={2 ** L}")
        H_diag, H_x = transverse_field_ising_2d(Lx, Ly, **kw)
        bonds = lattice2d_bonds(Lx, Ly)
        label = f"tfim2d_{Lx}x{Ly}_2^{L}"
    else:
        log(f"device: {device}, L={L}, N={2 ** L}")
        H_diag, H_x = transverse_field_ising(L, **kw)
        bonds = chain_bonds(L)
        label = f"tfim_2^{L}"
    bound = J_TFIM * (L - 1) + abs(H_TFIM) * L + G_TFIM * L
    e_min, delta = -bound, 2 * bound
    rng = np.random.default_rng(1)
    re0 = rng.standard_normal(2 ** L)
    im0 = rng.standard_normal(2 ** L)
    nrm0 = np.sqrt((re0 ** 2 + im0 ** 2).sum())
    return TFIM(L, label, bonds, H_diag, H_x, delta, e_min, dt,
                np.asarray(cheby_coeffs(delta, dt)),
                (re0 / nrm0).astype(np.float32),
                (im0 / nrm0).astype(np.float32))


def dd_stepper(p: TFIM, device, *, f32_tail="auto", tile_rows=512,
               fast="lomxu"):
    """The headline's reference-tier step on the flip kernels: returns
    ``(step, psi_start, tail)`` with ``step(psi, **hooks)`` one
    complex128 Chebyshev step (``hooks``: ``cheby_step_fused_dd``'s
    remote-bit hooks and ``out``), ``psi_start`` the start state
    widened to complex128 and ``tail`` the number of orders run in
    complex64."""
    from quantumpropagators_torch.models.lattice import ising_diagonal_np
    from quantumpropagators_torch.ops.fused_cheby import make_flip_plan
    from quantumpropagators_torch.ops.fused_cheby_dd import (
        cheby_step_fused_dd, dd_tile_rows, f32_tail_orders,
    )

    plan = make_flip_plan(p.L, G_TFIM, tile_rows=(
        tile_rows if tile_rows != 512 else dd_tile_rows(p.L)))
    beta = p.delta / 2.0 + p.e_min
    dmb = torch.as_tensor(
        ising_diagonal_np(p.L, p.bonds, J_TFIM, H_TFIM) - beta, device=device)
    tail = f32_tail_orders(p.coeffs) if f32_tail == "auto" else int(f32_tail)
    psi_start = torch.complex(torch.as_tensor(p.re32, device=device),
                              torch.as_tensor(p.im32, device=device)) \
        .to(torch.complex128)

    def step(psi, **hooks):
        return cheby_step_fused_dd(plan, dmb, psi, p.coeffs, p.delta,
                                   p.e_min, p.dt, fast=fast, f32_tail=tail,
                                   **hooks)

    return step, psi_start, tail


def bench_headline(device, *, L=20, lattice2d=None, kernel="dd", steps=20,
                   dt=0.05, L_ref=16, group_bits=0, tile_rows=512,
                   oracle=True, f32_tail="auto", dd_remote_bits=0,
                   fast="lomxu"):
    """The headline chain (or ``lattice2d = "LxxLy"`` lattice): Chebyshev
    propagation of the TFIM at 2^L in Gnnz/s against scipy CSR on one
    core.  ``kernel``: ``dd`` = complex128 on the flip kernels with the
    complex64 tail (reference accuracy; the default; ``extra`` also
    records the tail's ``f32_tail_orders``), ``fused`` = float32 planes
    on the flip kernels, ``planar`` = float32 planes in plain PyTorch,
    ``complex`` = complex64 in plain PyTorch."""
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.models.lattice import ising_diagonal_np
    from quantumpropagators_torch.ops.cheby import cheby_apply
    from quantumpropagators_torch.ops.fused_cheby import (
        cheby_step_fused, make_flip_plan,
    )
    from quantumpropagators_torch.ops.planar import cheby_apply_planar

    p = tfim_problem(device, L, lattice2d, dt)
    L, N = p.L, 2 ** p.L
    coeffs = p.coeffs.astype(np.float32)
    matvecs_per_step = len(coeffs) - 1
    log(f"Chebyshev: {len(coeffs)} coefficients per step "
        f"(Δ·dt/2={p.delta * dt / 2:.1f})")

    # the plain PyTorch kernels' operator: the diagonal and the site
    # flips in matricized groups of group_bits sites
    op = qt.Operator(
        [p.H_diag, p.H_x.grouped(group_bits or (10 if L <= 21 else 8))],
        np.array([1.0], dtype=np.float32))
    extra = {}
    if kernel == "dd":
        dd_step, psi_start, tail = dd_stepper(
            p, device, f32_tail=f32_tail, tile_rows=tile_rows, fast=fast)
        log(f"complex128 tier with a complex64 tail: {tail} of "
            f"{len(coeffs)} orders in f32")
        extra["f32_tail_orders"] = tail
        hooks = {}
        if dd_remote_bits:
            oracle = False
            nrb = dd_remote_bits

            def self_nb(v):
                return [v] * nrb

            hooks = dict(extra_nb_fn=self_nb, extra_nb_hi_fn=self_nb,
                         extra_gs=(G_TFIM,) * nrb)
            log(f"A/B: {nrb} self-copy remote planes through the sharded "
                f"hook (result non-physical, cost-accurate)")

        scans = step_scan(lambda psi, _, out=None: (
            dd_step(psi, out=out, **hooks), None))

        def run(n):
            return finish(device,
                          torch.linalg.vector_norm(scans(psi_start, n)))
    elif kernel not in ("fused", "planar", "complex"):
        raise ValueError(f"unknown kernel={kernel!r}")
    elif kernel == "complex":
        psi_c64 = torch.complex(torch.as_tensor(p.re32, device=device),
                                torch.as_tensor(p.im32, device=device))

        scans = step_scan(lambda psi, _, out=None: (cheby_apply(
            op, psi, coeffs, p.delta, p.e_min, dt, out=out), None))

        def run(n):
            return finish(device,
                          torch.linalg.vector_norm(scans(psi_c64, n)))
    else:
        if kernel == "fused":
            plan = make_flip_plan(L, G_TFIM, tile_rows=tile_rows)

            def step(r, i):
                return cheby_step_fused(plan, p.H_diag.diag, r, i, coeffs,
                                        p.delta, p.e_min, dt)
        else:
            def step(r, i):
                return cheby_apply_planar(op, r, i, coeffs, p.delta, p.e_min,
                                          dt)

        scans = step_scan(lambda ri, _: (step(*ri), None))

        def run(n):
            r, i = scans((torch.as_tensor(p.re32, device=device),
                          torch.as_tensor(p.im32, device=device)), n)
            return finish(device, torch.sqrt(torch.sum(r ** 2 + i ** 2)))

    n1, n2 = steps, 3 * steps

    def timed(n):
        t0 = time.perf_counter()
        nrm = run(n)
        return time.perf_counter() - t0, nrm

    t0 = time.perf_counter()
    timed(n1)
    timed(n2)
    log(f"warm-up ({n1} and {n2} steps): {time.perf_counter() - t0:.1f}s")
    t_1, _ = timed(n1)
    t_2, nrm = timed(n2)
    elapsed = max(t_2 - t_1, 1e-9)  # (n2 - n1) steps of device time
    steps_timed = n2 - n1
    log(f"{n1} steps: {t_1:.3f}s; {n2} steps: {t_2:.3f}s → "
        f"{steps_timed} steps in {elapsed:.3f}s; ‖Ψ‖={nrm:.6f}")

    nnz_equiv = (L + 1) * N  # diag + one off-diag entry per site per row
    total_matvecs = steps_timed * matvecs_per_step
    gnnz = total_matvecs * nnz_equiv / elapsed / 1e9
    steps_per_s = steps_timed / elapsed
    log(f"throughput: {gnnz:.2f} Gnnz/s "
        f"({total_matvecs} matvecs, {steps_per_s:.2f} steps/s)")

    # error budget: one step vs an exact float64 host oracle (the
    # reference contract is 1e-10 total, test/test_cheby.jl:8); minutes
    # of host numpy at 2^24
    if kernel == "dd" and oracle:
        z = dd_step(psi_start).cpu().numpy()
        v0 = p.re32.astype(np.float64) + 1j * p.im32.astype(np.float64)
        ref = flip_oracle_step(
            v0, ising_diagonal_np(L, p.bonds, J_TFIM, H_TFIM), G_TFIM, L,
            p.coeffs, p.delta, p.e_min, dt)
        extra["per_step_error_vs_f64"] = float(np.abs(z - ref).max())
        log(f"per-step error vs f64 oracle: "
            f"{extra['per_step_error_vs_f64']:.3e}")

    baseline = cpu_csr_baseline(L_ref)
    return result(
        f"cheby_spmv_throughput_{p.label}", round(gnnz, 3), "Gnnz/s",
        round(gnnz / baseline, 2),
        {"steps_per_s": round(steps_per_s, 3),
         "matvecs_per_step": matvecs_per_step,
         "kernel": {"fused": "fused_pallas", "planar": "planar_f32",
                    "complex": "complex64", "dd": "fused_pallas_df64"}[kernel],
         "variant": VARIANT,
         "platform": device.type,
         "state_norm_after": round(nrm, 9),
         **extra}, device)


def run_subprocesses(jobs):
    """Run this script once per argument list, each to its end."""
    here = os.path.abspath(__file__)
    for args in jobs:
        subprocess.run([sys.executable, here, *args], check=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config",
                    choices=("rabi", "transmon", "optomech", "newton",
                             "banded20", "northstar", "multiamp"),
                    default=None,
                    help="run one of the small BASELINE configs instead "
                         "of the headline chain/lattice measurement")
    ap.add_argument("--suite", action="store_true",
                    help="run the BASELINE configs of bench.py's suite "
                         "(one JSON line per config)")
    ap.add_argument("--L", type=int, default=None,
                    help="chain length (2^L states); with no --L / "
                         "--config / --lattice2d, the default run emits "
                         "the 2^20 line and then the 2^24 line")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dt", type=float, default=0.05)
    ap.add_argument("--L-ref", type=int, default=16,
                    help="CPU baseline chain length")
    ap.add_argument("--group-bits", type=int, default=0,
                    help="site-group size in bits of the planar and "
                         "complex kernels' operator (0 = auto)")
    ap.add_argument("--lattice2d", type=str, default=None,
                    help="LxxLy 2D lattice instead of a chain, e.g. 4x6")
    ap.add_argument("--kernel", choices=("fused", "planar", "complex", "dd"),
                    default="dd",
                    help="dd = complex128 on the flip kernels (reference "
                         "accuracy, the default); fused = float32 planes "
                         "on the flip kernels; planar = float32 planes in "
                         "plain PyTorch; complex = complex64 in plain "
                         "PyTorch")
    ap.add_argument("--complex", dest="kernel", action="store_const",
                    const="complex")
    ap.add_argument("--planar", dest="kernel", action="store_const",
                    const="planar")
    ap.add_argument("--tile-rows", type=int, default=512,
                    help="tile rows of the JAX package's TPU plan "
                         "(accepted; the CUDA kernels pick their own)")
    ap.add_argument("--no-oracle", action="store_true",
                    help="skip the f64 host oracle check")
    ap.add_argument("--fast", action="store_true", default="lomxu",
                    help="the JAX package's dd kernel variants (accepted; "
                         "one kernel here)")
    ap.add_argument("--no-fast", dest="fast", action="store_false")
    ap.add_argument("--f32-tail", default="auto",
                    help="dd: number of tail polynomial orders run in "
                         "complex64 ('auto' = largest count keeping the "
                         "per-step budget under 1e-13, '0' = none)")
    ap.add_argument("--dd-remote-bits", type=int, default=0,
                    help="feed N self-copies of the state through the dd "
                         "step's remote-bit hook (extra_nb_fn), read by "
                         "the high pass as N partner planes (N <= 4): the "
                         "kernel-side cost of N sharded slot bits; the "
                         "result is non-physical (implies --no-oracle)")
    ap.add_argument("--dd-variant",
                    choices=("twosum", "rows", "sigma", "lomxu", "tlane",
                             "xcross", "mxq"),
                    default=None,
                    help="the JAX package's dd variants (accepted; one "
                         "kernel here)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args()

    dd_fast = args.dd_variant if args.dd_variant else args.fast
    device_args = ["--device", args.device]
    if args.suite:
        run_subprocesses([
            ["--config", "rabi", *device_args],
            ["--config", "transmon", "--device", "cpu"],
            ["--config", "newton", *device_args],
            ["--config", "optomech", *device_args],
            ["--L", "20", "--kernel", "dd", *device_args],
            ["--lattice2d", "4x6", "--kernel", "dd", "--steps", "5",
             *device_args],
        ])
        return
    if args.L is None and args.config is None and args.lattice2d is None:
        # 2^20, then 2^24 last; the caller's other flags go to both (the
        # last occurrence of a flag wins)
        passthrough = list(sys.argv[1:])
        run_subprocesses([[*passthrough, "--L", "20"],
                          [*passthrough, "--L", "24", "--steps", "5"]])
        return

    from quantumpropagators_torch.ops.operators import (
        resolve_device, set_default_device,
    )

    device = resolve_device(args.device)  # raises without a GPU
    set_default_device(device)
    if args.config == "multiamp":
        out = bench_multiamp(device, L=args.L or 20, n_steps=args.steps)
    elif args.config == "banded20":
        out = bench_banded20(
            device, L_dim=args.L or 20,
            tile_rows=args.tile_rows if args.tile_rows != 512 else 8)
    elif args.config == "northstar":
        out = bench_northstar(
            device, n_steps=args.steps if args.steps != 20 else 1000,
            L=args.L or 24, oracle=not args.no_oracle)
    elif args.config == "rabi":
        out = bench_rabi(device)
    elif args.config == "transmon":
        out = bench_transmon(device)
    elif args.config == "newton":
        out = bench_newton(device)
    elif args.config == "optomech":
        out = bench_optomech(device)
    else:
        out = bench_headline(
            device, L=args.L or 20, lattice2d=args.lattice2d,
            kernel=args.kernel, steps=args.steps, dt=args.dt,
            L_ref=args.L_ref, group_bits=args.group_bits,
            tile_rows=args.tile_rows, oracle=not args.no_oracle,
            f32_tail=args.f32_tail, dd_remote_bits=args.dd_remote_bits,
            fast=dd_fast)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
