"""Krotov's method on the stateful propagator API of the PyTorch/CUDA
port.

First-order Krotov optimal control of ``krotov_state_transfer.py``:
sequential-in-time pulse updates interleaved with forward propagation,
using the backward-propagated co-state.  ``qt.reinit_prop`` and the
mutable ``propagator.parameters`` play the role of the reference's
``reinit_prop!`` fast path: the control values are a numpy array that
the propagator reads at each step, so an update written into it takes
effect at the next step.

Each iteration propagates the co-state backward under the OLD pulse
(storing the trajectory on the host), then sweeps forward updating each
interval's pulse value from the local overlap Im⟨χ(t)|H₁|ψ(t)⟩ before
stepping through it.

Run: ``python examples/krotov_state_transfer_torch.py`` (on the GPU) or
``python examples/krotov_state_transfer_torch.py --device cpu``
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

import quantumpropagators_torch as qt
from quantumpropagators_torch.ops.operators import resolve_device


def host(x):
    return x.detach().cpu().numpy()


def main(device="cuda", max_iter=30):
    """Run the optimization; prints the JAX example's lines and returns
    ``{"iterations", "fidelity", "guess_fidelity", "fidelities"}``
    (``fidelities`` one per iteration run)."""
    device = resolve_device(device)
    sx_np = np.array([[0, 1], [1, 0]], dtype=complex)
    sx = torch.as_tensor(sx_np, device=device)
    sz = torch.tensor([[1, 0], [0, -1]], dtype=torch.complex128,
                      device=device)
    H0 = 0.5 * sz
    tlist = np.linspace(0, 5.0, 101)
    psi0 = torch.tensor([1, 0], dtype=torch.complex128, device=device)
    target = torch.tensor([0, 1], dtype=torch.complex128, device=device)

    guess = lambda t: 0.2 * qt.flattop(t, T=5.0, t_rise=1.0)
    gen = qt.hamiltonian(H0, (sx, guess))
    lam = 2.0  # Krotov step-size parameter (1/λ update weight)

    # propagators reused across iterations; control values live in
    # .parameters (the optimal-control aliasing contract)
    fwd = qt.init_prop(psi0, gen, tlist, method="cheby",
                       control_ranges=qt.IdDict([(guess, (-3.0, 3.0))]))
    bwd = qt.init_prop(target, gen, tlist, method="cheby", backward=True,
                       control_ranges=qt.IdDict([(guess, (-3.0, 3.0))]))
    control = fwd.controls[0]
    eps = np.asarray(fwd.parameters[control]).copy()

    def fidelity(pulse):
        fwd.parameters[control] = pulse
        qt.reinit_prop(fwd, psi0)
        while fwd.prop_step() is not None:
            pass
        return abs(complex(torch.vdot(target, fwd.state))) ** 2

    F0 = fidelity(eps)
    print(f"guess fidelity: {F0:.6f}")

    nt = len(tlist)
    fidelities = []
    for it in range(max_iter):
        # backward propagation of the co-state under the CURRENT pulse,
        # storing chi at every grid point
        bwd.parameters[control] = eps
        qt.reinit_prop(bwd, target)
        chi = np.zeros((nt, 2), dtype=complex)
        chi[-1] = host(bwd.state)
        n = nt - 2
        while bwd.prop_step() is not None:
            chi[n] = host(bwd.state)
            n -= 1

        # forward sweep with sequential pulse updates
        new_eps = eps.copy()
        fwd.parameters[control] = new_eps  # aliased: updates take effect
        qt.reinit_prop(fwd, psi0)
        for i in range(nt - 1):
            psi = host(fwd.state)
            overlap = chi[i].conj() @ sx_np @ psi
            new_eps[i] = eps[i] + (1.0 / lam) * np.imag(overlap)
            fwd.prop_step()
        F = abs(complex(torch.vdot(target, fwd.state))) ** 2
        fidelities.append(F)
        eps = new_eps
        if it % 5 == 0 or F > 1 - 1e-6:
            print(f"iter {it:2d}: fidelity = {F:.8f}")
        if F > 1 - 1e-6:
            break

    print(f"final fidelity: {F:.8f}")
    return {"iterations": it, "fidelity": F, "guess_fidelity": F0,
            "fidelities": fidelities}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    out = main(ap.parse_args().device)
    assert out["fidelity"] > 0.999, "Krotov optimization failed to converge"
