"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``quantumpropagators_torch/csrc``
with ``nvcc``, holds each kernel instantiation against its plain PyTorch
version, then runs Chebyshev propagation of the driven transverse-field
Ising chain at L = 24 (2^24 states) through
``propagate(..., fused=True)`` in the reference-accuracy tier
(``kernel="dd"``, complex128) and the f32 tier (``kernel="pallas"``,
complex64), checks the results, and times every kernel beside its plain
version.  One line per phase; the second-to-last line is the kernels'
JSON record, the last line ``{"ok": true, "device": ...}``.  Any failed
check raises, and the script exits nonzero without printing a result.
It refuses to run without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20240611
L_MAIN = 24          # 2^24 states: the BASELINE north-star size
L_CHECK = 20         # kernel-vs-plain and round-trip size
N_STEPS = 20
DT = 0.05
J, G_FIELD, H_FIELD = 1.0, 1.2, 0.3
SOURCE = "quantumpropagators_torch/csrc/cheby_flip.cu"
# file:line of the pl.pallas_call each instantiation replaces
REPLACES = {
    "cheby_flip_first<float>": "quantumpropagators/ops/fused_cheby.py:440",
    "cheby_flip_iter<float>": "quantumpropagators/ops/fused_cheby.py:474",
    "cheby_flip_first<double>": "quantumpropagators/ops/fused_cheby_dd.py:1063",
    "cheby_flip_iter<double>": "quantumpropagators/ops/fused_cheby_dd.py:1022",
}
ALSO_REPLACES = {
    # the dd path's f32 tail runs on the float iteration
    "cheby_flip_iter<float>": "quantumpropagators/ops/fused_cheby_dd.py:1165",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def random_state(L, dtype, device, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi /= np.linalg.norm(psi)
    return torch.as_tensor(psi).to(device=device, dtype=dtype)


_DIAGS: dict = {}


def kernel_inputs(L, ctype, device, seed):
    """Seeded inputs for one launch at size 2^L: states, a generic
    ``dmb = diag − β`` with β ≠ 0, and per-bit flip coefficients."""
    from quantumpropagators_torch.models.lattice import chain_bonds, ising_diagonal_np

    cdtype = torch.complex64 if ctype == "float" else torch.complex128
    rdtype = torch.float32 if ctype == "float" else torch.float64
    rng = np.random.default_rng(seed)
    if L not in _DIAGS:
        _DIAGS[L] = ising_diagonal_np(L, chain_bonds(L), J, H_FIELD)
    diag = _DIAGS[L]
    beta = 0.37 * L
    dmb = torch.as_tensor(diag - beta).to(device=device, dtype=rdtype)
    G = torch.as_tensor(rng.uniform(0.5, 1.5, L)).to(device=device,
                                                      dtype=rdtype)
    v0 = random_state(L, cdtype, device, seed + 1)
    v1 = random_state(L, cdtype, device, seed + 2)
    phi = random_state(L, cdtype, device, seed + 3)
    s = -2.0 / (2.5 * L)
    return v0, v1, phi, dmb, G, s


def run_instantiation(name, inputs, plain: bool):
    """One launch of ``name`` (kernel or plain version) on copies of
    ``inputs``; returns the output tensors."""
    from quantumpropagators_torch.ops import cheby_flip as cf

    v0, v1, phi, dmb, G, s = inputs
    kind = name.split("<")[0]
    if kind == "cheby_flip_first":
        fn = cf.cheby_flip_first_plain if plain else cf.cheby_flip_first
        return fn(v0, dmb, G, s, 0.81, -0.45)
    fn = cf.cheby_flip_iter_plain if plain else cf.cheby_flip_iter
    v0c, phic = v0.clone(), phi.clone()
    fn(v0c, v1, phic, dmb, G, 2.0 * s, 0.13)
    return v0c, phic


def compare_kernels(device):
    """Phase 2: every instantiation against its plain version at L_CHECK
    and at the main path's size L_MAIN; returns ``{name: max_abs_err}``
    over both sizes."""
    errs = {}
    for L in (L_CHECK, L_MAIN):
        for name in REPLACES:
            ctype = name.split("<")[1][:-1]
            inputs = kernel_inputs(L, ctype, device, SEED)
            got = run_instantiation(name, inputs, plain=False)
            want = run_instantiation(name, inputs, plain=True)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            scale = max(float(b.abs().max()) for b in want)
            if ctype == "double":
                ok = err <= 1e-13
                tol = "max|d| <= 1e-13"
            else:
                ok = err <= 1e-5 * scale
                tol = "max|d| <= 1e-5 * max|ref|"
            log(f"phase 2 kernel-vs-plain {name} L={L}: max|d|={err:.3e} "
                f"max|ref|={scale:.3e} ({tol}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version")
            errs[name] = max(err, errs.get(name, 0.0))
            del inputs, got, want
    return errs


def tfim_generator(L, device):
    import quantumpropagators_torch as qt

    H_diag, H_x = qt.transverse_field_ising(
        L, J=J, g=G_FIELD, h=H_FIELD, dtype=torch.complex128, device=device
    )
    T = N_STEPS * DT

    def drive(t):
        return qt.flattop(t, T=T, t_rise=0.3 * T)

    return H_diag, qt.hamiltonian(H_diag, (H_x, drive))


def sz0(L, device):
    from quantumpropagators_torch.models.lattice import _spin
    from quantumpropagators_torch.ops.operators import DiagonalOperator

    return DiagonalOperator(_spin(L, 0, torch.float64, device))


def main_path(device, card):
    """Phases 3-4: the L = 24 driven chain through
    ``propagate(fused=True)`` in both tiers.  Returns the numbers the
    timing phase and the kernels line need."""
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.fused import cheby_propagate_fused
    from quantumpropagators_torch.ops import cheby_flip as cf
    from quantumpropagators_torch.propagators.cheby import ChebyPropagator

    tlist = np.linspace(0.0, N_STEPS * DT, N_STEPS + 1)
    _, H = tfim_generator(L_MAIN, device)
    psi0 = random_state(L_MAIN, torch.complex128, device, SEED + 10)
    t0 = time.perf_counter()
    # default specrange (Arnoldi), its start vector seeded
    wrk = ChebyPropagator(psi0, H, tlist,
                          rng=np.random.default_rng(SEED + 30)).wrk
    torch.cuda.synchronize()
    t_spec = time.perf_counter() - t0
    n_orders = len(wrk.coeffs)
    log(f"phase 3 workspace L={L_MAIN}: E_min={wrk.e_min:.6f} "
        f"delta={wrk.delta:.6f} orders/step={n_orders} "
        f"(specrange {t_spec:.2f} s)")
    obs = (sz0(L_MAIN, device), lambda psi: torch.linalg.vector_norm(psi))
    launches = {}

    # -- reference tier (kernel="dd", complex128) -------------------------
    cf.reset_launches()
    data = qt.propagate(psi0, H, tlist, method="cheby", fused=True,
                        kernel="dd", workspace=wrk, observables=obs,
                        storage=True)
    torch.cuda.synchronize()
    launches["dd"] = dict(cf.LAUNCHES)
    if not (launches["dd"]["cheby_flip_first<double>"] > 0
            and launches["dd"]["cheby_flip_iter<double>"] > 0
            and launches["dd"]["cheby_flip_iter<float>"] > 0):
        raise AssertionError(f"dd path did not launch the kernels: "
                             f"{launches['dd']}")
    # timed run: the same path without observables, after the one above
    t0 = time.perf_counter()
    psi_dd = qt.propagate(psi0, H, tlist, method="cheby", fused=True,
                          kernel="dd", workspace=wrk)
    torch.cuda.synchronize()
    t_dd = time.perf_counter() - t0
    norms = np.abs(data[1])
    szs = data[0]
    if data.shape != (2, N_STEPS + 1) or not np.all(np.isfinite(data)):
        raise AssertionError(f"bad observable storage {data.shape}")
    norm_err = float(np.abs(norms - 1.0).max())
    final_norm_err = abs(float(torch.linalg.vector_norm(psi_dd)) - 1.0)
    if norm_err > 1e-12 or final_norm_err > 1e-12:
        raise AssertionError(f"norm not kept: {norm_err}, {final_norm_err}")
    if np.abs(szs.imag).max() > 1e-12 or np.abs(szs.real).max() > 1.0:
        raise AssertionError("<sz_0> not a real number in [-1, 1]")
    log(f"phase 3 dd L={L_MAIN} {N_STEPS} steps: max|norm-1|={norm_err:.2e} "
        f"(<= 1e-12), <sz_0>(T)={szs[-1].real:+.12f}, "
        f"launches={launches['dd']} ok")

    # the plain generic path (kernel="xla", same workspace), 5 steps
    short = tlist[:6]
    p_dd, _ = cheby_propagate_fused(psi0, H, short, workspace=wrk,
                                    kernel="dd")
    p_xla, _ = cheby_propagate_fused(psi0, H, short, workspace=wrk,
                                     kernel="xla")
    torch.cuda.synchronize()
    err_xla = float((p_dd - p_xla).abs().max())
    if not err_xla <= 1e-10:
        raise AssertionError(f"dd vs xla after 5 steps: {err_xla}")
    log(f"phase 3 dd vs plain generic path (xla) after 5 steps: "
        f"max|d|={err_xla:.3e} (<= 1e-10) ok")

    # -- f32 tier (kernel="pallas", complex64) ----------------------------
    cf.reset_launches()
    t0 = time.perf_counter()
    psi_32 = qt.propagate(psi0.to(torch.complex64), H, tlist, method="cheby",
                          fused=True, kernel="pallas", workspace=wrk)
    torch.cuda.synchronize()
    t_32 = time.perf_counter() - t0
    launches["pallas"] = dict(cf.LAUNCHES)
    if not (launches["pallas"]["cheby_flip_first<float>"] > 0
            and launches["pallas"]["cheby_flip_iter<float>"] > 0):
        raise AssertionError(f"f32 path did not launch the kernels: "
                             f"{launches['pallas']}")
    if psi_32.dtype != torch.complex64:
        raise AssertionError(f"f32 tier promoted the state to {psi_32.dtype}")
    err_32 = float((psi_32.to(torch.complex128) - psi_dd).abs().max())
    if not err_32 <= 1e-4:
        raise AssertionError(f"f32 tier vs dd: {err_32}")
    log(f"phase 4 pallas (f32) L={L_MAIN} {N_STEPS} steps vs dd: "
        f"max|d|={err_32:.3e} (<= 1e-4), launches={launches['pallas']} ok")

    matvecs = n_orders - 1
    nnz = (L_MAIN + 1) * 2 ** L_MAIN  # diagonal + one flip per site per row
    rates = {}
    for tier, t in (("dd", t_dd), ("pallas", t_32)):
        rates[tier] = (N_STEPS / t, N_STEPS * matvecs * nnz / t / 1e9)
    return launches, rates, matvecs


def round_trip(device):
    """Phase 5: dd forward then backward returns psi0 at L_CHECK."""
    import quantumpropagators_torch as qt

    tlist = np.linspace(0.0, N_STEPS * DT, N_STEPS + 1)
    _, H = tfim_generator(L_CHECK, device)
    psi0 = random_state(L_CHECK, torch.complex128, device, SEED + 20)
    fwd = qt.propagate(psi0, H, tlist, method="cheby", fused=True,
                       kernel="dd")
    back = qt.propagate(fwd, H, tlist, method="cheby", fused=True,
                        kernel="dd", backward=True)
    torch.cuda.synchronize()
    err = float((back - psi0).abs().max())
    if not err <= 1e-12:
        raise AssertionError(f"backward round trip: {err}")
    log(f"phase 5 dd backward round trip L={L_CHECK}: max|d|={err:.3e} "
        f"(<= 1e-12) ok")


def time_ms(fn, reps):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_kernels(device, card):
    """Phase 6: each instantiation and its plain version at L_MAIN.  The
    iteration runs in place (v0 := v2, Φ += a·v2) on the same buffers
    every repetition, as it does inside a step."""
    from quantumpropagators_torch.ops import cheby_flip as cf

    times = {}
    for name in REPLACES:
        ctype = name.split("<")[1][:-1]
        v0, v1, phi, dmb, G, s = kernel_inputs(L_MAIN, ctype, device, SEED)
        if name.startswith("cheby_flip_first"):
            def run(fn):
                return lambda: fn(v0, dmb, G, s, 0.81, -0.45)

            kernel, plain = cf.cheby_flip_first, cf.cheby_flip_first_plain
        else:
            def run(fn):
                return lambda: fn(v0, v1, phi, dmb, G, 2.0 * s, 0.13)

            kernel, plain = cf.cheby_flip_iter, cf.cheby_flip_iter_plain
        ms = time_ms(run(kernel), 20)
        plain_ms = time_ms(run(plain), 3)
        times[name] = (ms, plain_ms)
        log(f"phase 6 time {name} L={L_MAIN}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms [{card}]")
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; refusing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from quantumpropagators_torch.ops import _cuda

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    t0 = time.perf_counter()
    _cuda.load()
    regs = [ln.strip() for ln in _cuda.build_info.get("ptxas", "").splitlines()
            if "registers" in ln]
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_cuda.build_info['seconds']:.2f} s); ptxas: {regs}")

    errs = compare_kernels(device)
    launches, rates, matvecs = main_path(device, card)
    round_trip(device)
    times = time_kernels(device, card)
    for tier, (steps_s, gnnz) in rates.items():
        log(f"phase 6 main path {tier} L={L_MAIN}: {steps_s:.3f} steps/s, "
            f"{gnnz:.3f} Gnnz/s ({matvecs} matvecs/step, nnz=(L+1)*2^L) "
            f"[{card}]")

    kernels = []
    for name in REPLACES:
        entry = {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": launches["dd"][name] + launches["pallas"][name],
            "max_abs_err": errs[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
        }
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        kernels.append(entry)
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
