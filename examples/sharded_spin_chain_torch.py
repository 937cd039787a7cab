"""Sharded propagation of a 2^L spin chain on the PyTorch/CUDA port.

The run of ``sharded_spin_chain.py``: 100 complex64 Chebyshev steps of
the L = 14 transverse-field Ising chain over the shard slots of
``chain_mesh`` (``quantumpropagators_torch.parallel``).  One process
holds every slot, on one GPU by default (4 slots) or on the CPU; each
slot-bit flip is an exchange between slots.

Run: ``python examples/sharded_spin_chain_torch.py`` (on the GPU) or
``python examples/sharded_spin_chain_torch.py --device cpu --slots 8``
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from quantumpropagators_torch import Operator
from quantumpropagators_torch.models.lattice import transverse_field_ising
from quantumpropagators_torch.ops.cheby import cheby_coeffs
from quantumpropagators_torch.ops.operators import resolve_device
from quantumpropagators_torch.parallel.mesh import (chain_mesh, replicate,
                                                    shard_vector)
from quantumpropagators_torch.parallel.sharded_chain import (
    make_sharded_cheby_step,
    prepare_sharded_operator,
)


def main(device="cuda", slots=4, n_steps=100):
    """Run ``n_steps`` sharded steps; prints the JAX example's lines and
    returns ``{"norm", "state"}`` (``state`` the slots, ``(slots,
    2^L / slots)``)."""
    device = resolve_device(device)
    L = 14
    J, g, h = 1.0, 1.2, 0.3
    print(f"{slots} slots on {device.type}, L={L} (dim {2**L})")

    H_diag, H_x = transverse_field_ising(L, J=J, g=g, h=h,
                                         dtype=torch.complex64, device=device)
    op = Operator([H_diag, H_x], np.array([1.0], dtype=np.float32))
    op_sharded = prepare_sharded_operator(op, slots)

    bound = J * (L - 1) + abs(h) * L + g * L
    e_min, delta = -bound, 2 * bound
    dt = 0.05
    mesh = chain_mesh(slots, device=device)
    coeffs = replicate(mesh, torch.as_tensor(cheby_coeffs(delta, dt),
                                             dtype=torch.float32))
    step = make_sharded_cheby_step(mesh, op_sharded, delta=delta,
                                   e_min=e_min, dt=dt)

    rng = np.random.default_rng(0)
    psi = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi = torch.as_tensor(psi / np.linalg.norm(psi), dtype=torch.complex64)
    v = shard_vector(mesh, psi)

    for k in range(n_steps):
        v = step(op_sharded, v, coeffs)
    nrm = float(torch.linalg.vector_norm(v))
    print(f"{n_steps} steps done; ‖Ψ‖ = {nrm:.8f} (unitarity check)")
    return {"norm": nrm, "state": v}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--slots", type=int, default=4)
    args = ap.parse_args()
    main(args.device, args.slots)
