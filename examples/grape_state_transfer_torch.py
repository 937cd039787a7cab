"""GRAPE-style optimal control with differentiable propagation, on the
PyTorch/CUDA port.

Optimizes a σx drive to transfer a two-level system |0⟩ → |1⟩ (the
problem of ``grape_state_transfer.py``).  The control values are one
coefficient table, a leaf tensor; ``make_fused_cheby_propagator`` runs
the forward propagation over it and ``torch.autograd`` takes the
gradient of the infidelity, where the JAX example has
``jax.value_and_grad``.

Run: ``python examples/grape_state_transfer_torch.py`` (on the GPU) or
``python examples/grape_state_transfer_torch.py --device cpu``
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

import quantumpropagators_torch as qt
from quantumpropagators_torch.fused import make_fused_cheby_propagator
from quantumpropagators_torch.models.generators import coeff_table
from quantumpropagators_torch.ops.operators import resolve_device


def problem(device):
    """``(loss_and_grad, table0, tlist)``: ``loss_and_grad(table)`` is the
    infidelity after the whole propagation and its gradient with respect
    to the coefficient table; ``table0`` the guess's table."""
    device = resolve_device(device)
    sx = torch.tensor([[0, 1], [1, 0]], dtype=torch.complex128, device=device)
    sz = torch.tensor([[1, 0], [0, -1]], dtype=torch.complex128,
                      device=device)

    # initial guess: a weak flattop pulse
    guess = lambda t: 0.3 * qt.flattop(t, T=2.0, t_rise=0.5)
    H = qt.hamiltonian(0.0 * sz, (sx, guess))
    tlist = np.linspace(0, 2.0, 81)
    psi0 = torch.tensor([1, 0], dtype=torch.complex128, device=device)
    target = torch.tensor([0, 1], dtype=torch.complex128, device=device)

    # a manually certified spectral envelope that covers any pulse
    # amplitude the optimization will reach
    propagate = make_fused_cheby_propagator(
        psi0, H, tlist, E_min=-4.0, E_max=4.0, specrange_method="manual"
    )

    def loss_and_grad(table):
        table = table.detach().requires_grad_(True)
        psi_T, _ = propagate(psi0, table)
        loss = 1.0 - torch.vdot(target, psi_T).abs() ** 2
        (grad,) = torch.autograd.grad(loss, table)
        return loss.detach(), grad

    return loss_and_grad, coeff_table(H, tlist).to(device), tlist


def main(device="cuda", max_iter=300, lr=1.5):
    """Run the optimization; prints the JAX example's lines and returns
    ``{"iterations", "infidelity", "area", "losses"}`` (``iterations``
    the index of the last iteration run)."""
    loss_and_grad, table, tlist = problem(device)
    losses = []
    for it in range(max_iter):
        loss, grad = loss_and_grad(table)
        table = table - lr * grad
        losses.append(float(loss))
        if it % 50 == 0 or float(loss) < 1e-8:
            print(f"iter {it:3d}  infidelity = {float(loss):.3e}")
        if float(loss) < 1e-8:
            break

    dt = tlist[1] - tlist[0]
    area = float(torch.sum(table[:, 0])) * dt
    print(f"final infidelity: {float(loss):.3e}")
    print(f"pulse area: {area:.4f} (π/2 = {np.pi/2:.4f})")
    return {"iterations": it, "infidelity": float(loss), "area": area,
            "losses": losses}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
