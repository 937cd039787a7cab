"""Multi-amplitude driven lattice at reference accuracy, on the
PyTorch/CUDA port.

The 10-site chain of ``multi_amplitude_dd.py`` with THREE independent
controls — a diagonal drive and two separately driven transverse-field
groups (odd/even sites) — the reference's general generator form
``Ĥ₀ + Σₗ aₗ(t)Ĥₗ`` (``src/generators.jl:44-61``).  ``kernel="dd"``
propagates it in complex128 on the flip kernels (the CUDA kernels on
the GPU, their plain versions on the CPU), every interval's control
values folded into per-bit flip scales; it is held against the generic
complex128 path (``kernel="xla"``) to 1e-12.

Run: ``python examples/multi_amplitude_dd_torch.py`` (on the GPU) or
``python examples/multi_amplitude_dd_torch.py --device cpu``
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

import quantumpropagators_torch as qt
from quantumpropagators_torch.fused import cheby_propagate_fused
from quantumpropagators_torch.models.lattice import (
    SiteOperatorSum,
    transverse_field_ising,
)
from quantumpropagators_torch.ops.operators import resolve_device

L = 10


def problem(device, n_steps=100):
    """``(gen, psi0, tlist, kw)``: the three-control generator, the
    seeded start state, the first ``n_steps`` of the 100-step grid over
    [0, 2] and the certified envelope."""
    device = resolve_device(device)
    H_diag, _ = transverse_field_ising(L, J=1.0, g=1.0, h=0.3,
                                       dtype=torch.float64, device=device)

    # two disjoint flip groups: odd and even sites, each with its own drive
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    mats_odd = np.zeros((L, 2, 2))
    mats_even = np.zeros((L, 2, 2))
    for i in range(L):
        (mats_odd if i % 2 else mats_even)[i] = sx
    Hx_odd = SiteOperatorSum(
        torch.as_tensor(mats_odd, device=device), L=L,
        active=tuple(i % 2 == 1 for i in range(L)),
    )
    Hx_even = SiteOperatorSum(
        torch.as_tensor(mats_even, device=device), L=L,
        active=tuple(i % 2 == 0 for i in range(L)),
    )

    eps_d = lambda t: 1.0 + 0.3 * np.sin(0.9 * t)    # diagonal drive
    eps_o = lambda t: 1.2 + 0.4 * np.cos(1.7 * t)    # odd-site field
    eps_e = lambda t: 0.9 + 0.5 * np.sin(2.3 * t)    # even-site field
    gen = qt.hamiltonian(
        (H_diag, eps_d), (Hx_odd, eps_o), (Hx_even, eps_e), check=False
    )

    rng = np.random.default_rng(0)
    psi0 = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi0 = torch.as_tensor(psi0 / np.linalg.norm(psi0), device=device)

    tlist = np.linspace(0.0, 2.0, 101)[:n_steps + 1]
    # certified spectral envelope over the control ranges
    bound = 1.3 * (1.0 * (L - 1) + 0.3 * L) + 1.6 * L
    kw = dict(specrange_method="manual", E_min=-bound, E_max=bound)
    return gen, psi0, tlist, kw


def main(device="cuda", n_steps=100):
    """Propagate with ``kernel="dd"`` and ``kernel="xla"``; prints the
    JAX example's lines and returns ``{"err", "norm", "psi_dd"}``."""
    gen, psi0, tlist, kw = problem(device, n_steps)
    n_steps = len(tlist) - 1
    psi_dd, _ = cheby_propagate_fused(psi0, gen, tlist, kernel="dd", **kw)
    psi_ref, _ = cheby_propagate_fused(psi0, gen, tlist, kernel="xla", **kw)

    err = float((psi_dd - psi_ref).abs().max())
    nrm = float(torch.linalg.vector_norm(psi_dd))
    print(f"{n_steps} steps, 3 independent controls on {L} sites")
    print(f"dd kernel vs complex128 oracle: max|Δ| = {err:.2e}")
    print(f"‖Ψ‖ = {nrm:.12f}")
    assert err < 1e-12
    return {"err": err, "norm": nrm, "psi_dd": psi_dd}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
