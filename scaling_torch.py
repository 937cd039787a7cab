"""Weak-scaling harness of the PyTorch/CUDA port: ``scaling.py``'s
measurements on :mod:`quantumpropagators_torch`, over shard slots.

Each regime of ``scaling.py`` is a builder (the sharded step, its start
state, nnz and the coefficient count) and a timer with ``scaling.py``'s
method: 2 warm steps, then ``steps``, then ``3·steps``, the difference
of the last two, Gnnz/s = ``2·steps·(coefficients − 1)·nnz / elapsed``.

- ``hypercube``: the f32 sharded chain (``make_sharded_cheby_step``,
  plain PyTorch as the JAX step is plain XLA);
- ``hypercube-dd``: the reference-accuracy chain
  (``make_sharded_fused_cheby_step_dd``, complex128 on the flip kernels);
- ``banded-dd``: the block-tridiagonal float64 operator with its halo
  exchange (``make_sharded_bsr_cheby_step_dd``), the headline regime;
- ``banded-vs-ag``: halo vs all-gather vs no exchange at a fixed count.

A mesh device of the JAX harness is a shard slot here
(:mod:`quantumpropagators_torch.parallel.mesh`).  One process holds
every slot, and the counts are the powers of two up to ``--slots``;
under ``torchrun`` (``WORLD_SIZE > 1``) each rank holds its share and
the counts start at the world size.  A run with more slots than ranks
is *shared*: its slots share one card (or the CPU), so the line prints
``scaling.py``'s shared-branch metric, total-throughput retention, and
measures what the exchange costs per slot count, not weak scaling,
which needs two cards or more.

    python3 scaling_torch.py --mode all --slots 4 --L-base 22 \\
        --R-local 2048 --block 128 --steps 5
    python3 scaling_torch.py --mode banded-vs-ag --cpu 4 --R-local 4 \\
        --block 8 --L-base 10 --steps 2
    torchrun --nproc-per-node 2 scaling_torch.py --mode banded-dd --cpu 4

Prints one JSON line on stdout (rank 0) with ``scaling.py``'s keys plus
``card`` (the ``nvidia-smi --query-gpu=name,power.limit`` line, null on
the CPU); diagnostics go to stderr.  ``--device`` defaults to ``cuda``:
with no GPU the script raises unless it is ``cpu`` (or ``--cpu N``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from bench_torch import card_line, log

J, G, H_FIELD = 1.0, 1.2, 0.3
#: at most this many block entries (R·b·b) the banded build goes through
#: scipy and ``partition_bsr_dd``; above it the planes are built directly
SCIPY_MAX_ENTRIES = 1 << 22


class Point(NamedTuple):
    """One regime at one slot count: ``step(state) -> state`` on the
    sharded ``state``; ``nnz`` of the operator and ``n_coeffs``
    Chebyshev coefficients per step (the matvec count's basis)."""

    step: Callable
    state: torch.Tensor
    nnz: int
    n_coeffs: int
    mesh: object


def _chain_envelope(L):
    bound = J * (L - 1) + abs(H_FIELD) * L + G * L
    return -bound, 2 * bound


def _random_state(n, rng):
    psi = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return psi / np.linalg.norm(psi)


def _mesh(n_slots, device, mesh, group):
    from quantumpropagators_torch.parallel.mesh import chain_mesh

    return mesh if mesh is not None else chain_mesh(
        n_slots, group=group, device=device)


def build_hypercube(n_slots, L, dt, *, device, mesh=None, group=None):
    """``scaling.py:run_config``'s problem: the f32 TFIM chain over
    ``n_slots`` slots (``Operator([H_diag, H_x], [1])``, its site sum
    split by ``prepare_sharded_operator``)."""
    from quantumpropagators_torch import Operator
    from quantumpropagators_torch.models.lattice import transverse_field_ising
    from quantumpropagators_torch.ops.cheby import cheby_coeffs
    from quantumpropagators_torch.parallel.mesh import replicate, shard_vector
    from quantumpropagators_torch.parallel.sharded_chain import (
        make_sharded_cheby_step, prepare_sharded_operator)

    mesh = _mesh(n_slots, device, mesh, group)
    H_diag, H_x = transverse_field_ising(L, J=J, g=G, h=H_FIELD,
                                         dtype=torch.complex64, device=device)
    op = Operator([H_diag, H_x], np.array([1.0], dtype=np.float32))
    op_sh = prepare_sharded_operator(op, n_slots)
    e_min, delta = _chain_envelope(L)
    coeffs = replicate(mesh, torch.as_tensor(cheby_coeffs(delta, dt),
                                             dtype=torch.float32))
    step = make_sharded_cheby_step(mesh, op_sh, delta=delta, e_min=e_min,
                                   dt=dt)
    psi = _random_state(2 ** L, np.random.default_rng(0))
    v = shard_vector(mesh, torch.as_tensor(psi, dtype=torch.complex64))
    return Point(lambda st: step(op_sh, st, coeffs), v, (L + 1) * 2 ** L,
                 len(coeffs), mesh)


def banded_blocks(R, b, comm, rng):
    """The block-tridiagonal operator's random blocks, drawn as
    ``scaling.py`` draws them: ``diags (R, b, b)`` (symmetrized when
    placed) and ``offd (R − 1, b, b)`` (zero for ``comm='none'``)."""
    diags = rng.normal(size=(R, b, b))
    offd = rng.normal(size=(R - 1, b, b))
    if comm == "none":
        offd = np.zeros_like(offd)
    return diags, offd


def banded_scipy(diags, offd):
    """The operator as a scipy CSR matrix (``scaling.py``'s small-shard
    route)."""
    import scipy.sparse as sp

    R, b, _ = diags.shape
    rows, cols, blocks = [], [], []
    for r in range(R):
        for c in (r - 1, r, r + 1):
            if c < 0 or c >= R:
                continue
            if c == r:
                B = 0.5 * (diags[r] + diags[r].T)
            elif c == r + 1:
                B = offd[r]
            else:
                B = offd[c].T
            rows.append(r)
            cols.append(c)
            blocks.append(B)
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=R))]).astype(np.int64)
    return sp.bsr_matrix((np.stack(blocks), np.asarray(cols), indptr),
                         shape=(R * b, R * b)).tocsr()


def banded_planes(diags, offd, n_slots, comm, mesh):
    """The partition built directly (``scaling.py``'s representative-
    shard route): float64 blocked-ELL planes ``(P, R_local, 3, b, b)``
    with extended-local column ids (``wb = 1``, halo), global ids
    (``wb = −1``, all-gather) or slot-local ids (``wb = 0``, no
    exchange).  The planes are assembled on the mesh's device, and only
    this rank's slots are kept.  Returns the partition and the
    operator's largest absolute row sum."""
    from quantumpropagators_torch.parallel.sharded_bsr import PartitionedBSRdd

    R, b, _ = diags.shape
    k, Rl = 3, R // n_slots
    dev = mesh.device
    d = torch.as_tensor(diags).to(dev)
    o = torch.as_tensor(offd).to(dev)
    blocks = torch.zeros((R, k, b, b), dtype=torch.float64, device=dev)
    blocks[:, 1] = 0.5 * (d + d.transpose(1, 2))
    blocks[1:, 0] = o.transpose(1, 2)   # row 0's block 0: padding
    blocks[: R - 1, 2] = o              # row R − 1's block 2: padding
    del d, o
    bound = float(blocks.abs().sum(dim=(1, 3)).max())
    cols = np.zeros((R, k), dtype=np.int64)
    cols[:, 1] = np.arange(R)
    cols[1:, 0] = np.arange(R - 1)
    cols[: R - 1, 2] = np.arange(1, R)
    cols[R - 1, 2] = R - 1
    # the nonzero blocks: every diagonal one, and the hopping blocks
    # unless they are zero (random normal entries are never all zero)
    nz = np.zeros((R, k), dtype=bool)
    nz[:, 1] = True
    if comm != "none":
        nz[1:, 0] = nz[: R - 1, 2] = True
    nz = nz.reshape(n_slots, Rl, k)
    first = np.arange(n_slots)[:, None, None] * Rl
    ext = cols.reshape(n_slots, Rl, k)
    if comm == "allgather":
        wb = -1
    elif comm == "none":
        wb = 0
        ext = np.where(nz, ext - first, 0)
    else:
        wb = 1
        ext = np.where(nz, ext - (first - wb), wb)
    lo, hi = mesh.first_slot, mesh.first_slot + mesh.n_local
    local = blocks.view(n_slots, Rl, k, b, b)[lo:hi]
    pb = PartitionedBSRdd(
        blocks=local if hi - lo == n_slots else local.clone(),
        cols=torch.as_tensor(ext[lo:hi]).to(dev),
        halo_blocks=wb,
        n_block_rows_local=Rl,
        n_devices=n_slots,
        block_size=b,
        shape=(R * b, R * b),
    )
    return pb, bound


def build_banded_dd(n_slots, R_local, b, dt, comm="banded", *, device,
                    mesh=None, group=None, scipy_max=SCIPY_MAX_ENTRIES):
    """``scaling.py:run_config_banded_dd``'s problem: the random
    block-tridiagonal float64 operator of ``R_local`` block rows per
    slot, through scipy and ``partition_bsr_dd`` when ``R·b·b ≤
    scipy_max`` and as directly built planes otherwise, stepped in
    complex128 by ``make_sharded_bsr_cheby_step_dd``.  ``comm``:
    ``'banded'`` (halo), ``'allgather'`` or ``'none'`` (block-diagonal:
    the same work and no exchange)."""
    from quantumpropagators_torch.ops.cheby import cheby_coeffs
    from quantumpropagators_torch.parallel.mesh import shard_vector
    from quantumpropagators_torch.parallel.sharded_bsr import (
        make_sharded_bsr_cheby_step_dd, partition_bsr_dd)

    mesh = _mesh(n_slots, device, mesh, group)
    R = R_local * n_slots
    rng = np.random.default_rng(17)
    diags, offd = banded_blocks(R, b, comm, rng)
    if R * b * b <= scipy_max:
        A = banded_scipy(diags, offd)
        pb = partition_bsr_dd(
            A, n_slots, block_size=b, device=mesh.device,
            mode="allgather" if comm == "allgather" else "auto")
        if comm == "banded" and pb.halo_blocks != (1 if n_slots > 1 else 0):
            raise AssertionError(f"halo {pb.halo_blocks} at {n_slots} slots")
        bound = float(abs(A).sum(axis=1).max())
    else:
        pb, bound = banded_planes(diags, offd, n_slots, comm, mesh)
    del diags, offd
    e_min, delta = -bound, 2 * bound
    c64 = cheby_coeffs(delta, dt)
    step = make_sharded_bsr_cheby_step_dd(mesh, pb, delta=delta,
                                          e_min=e_min, dt=dt)
    psi = _random_state(R * b, rng)
    state = shard_vector(mesh, torch.as_tensor(psi, dtype=torch.complex128))
    return Point(lambda st: step(pb, st, c64), state, (3 * R - 2) * b * b,
                 len(c64), mesh)


def build_hypercube_dd(n_slots, L, dt, *, device, mesh=None, group=None):
    """``scaling.py:run_config_hypercube_dd``'s problem: the TFIM chain
    at reference accuracy, complex128 on the flip kernels, the slot-bit
    flips exchanged per order (``make_sharded_fused_cheby_step_dd``)."""
    from quantumpropagators_torch.models.lattice import (chain_bonds,
                                                         ising_diagonal_np)
    from quantumpropagators_torch.ops.cheby import cheby_coeffs
    from quantumpropagators_torch.parallel.mesh import shard_vector
    from quantumpropagators_torch.parallel.sharded_fused import \
        make_sharded_fused_cheby_step_dd

    mesh = _mesh(n_slots, device, mesh, group)
    diag64 = ising_diagonal_np(L, chain_bonds(L), J, H_FIELD)
    e_min, delta = _chain_envelope(L)
    beta = delta / 2.0 + e_min
    step = make_sharded_fused_cheby_step_dd(mesh, L, G, delta=delta,
                                            e_min=e_min, dt=dt,
                                            tile_rows=None)
    psi = _random_state(2 ** L, np.random.default_rng(0))
    c64 = cheby_coeffs(delta, dt)
    dmb = shard_vector(mesh, torch.as_tensor(diag64 - beta))
    state = shard_vector(mesh, torch.as_tensor(psi))
    return Point(lambda st: step(dmb, st, c64), state, (L + 1) * 2 ** L,
                 len(c64), mesh)


def time_point(p: Point, steps: int) -> float:
    """Total Gnnz/s of ``p`` by ``scaling.py``'s method; every timed run
    ends when the device has finished (and, across ranks, starts
    together)."""
    def run(n, st):
        for _ in range(n):
            st = p.step(st)
        if st.device.type == "cuda":
            torch.cuda.synchronize(st.device)
        return st

    st = run(2, p.state)  # warm
    if p.mesh.group is not None:
        dist.barrier(group=p.mesh.group)
    t0 = time.perf_counter()
    run(steps, st)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    run(3 * steps, st)
    t3 = time.perf_counter() - t0
    elapsed = max(t3 - t1, 1e-9)
    return 2 * steps * (p.n_coeffs - 1) * p.nnz / elapsed / 1e9


def run_config(n_slots, L, steps, dt, *, device, mesh=None, group=None):
    """Gnnz/s of the f32 chain (``scaling.py:run_config``)."""
    return time_point(build_hypercube(n_slots, L, dt, device=device,
                                      mesh=mesh, group=group), steps)


def run_config_banded_dd(n_slots, R_local, b, steps, dt, comm="banded", *,
                         device, mesh=None, group=None):
    """Gnnz/s of the banded float64 regime
    (``scaling.py:run_config_banded_dd``)."""
    return time_point(build_banded_dd(n_slots, R_local, b, dt, comm,
                                      device=device, mesh=mesh,
                                      group=group), steps)


def run_config_hypercube_dd(n_slots, L, steps, dt, *, device, mesh=None,
                            group=None):
    """Gnnz/s of the reference-accuracy chain
    (``scaling.py:run_config_hypercube_dd``)."""
    return time_point(build_hypercube_dd(n_slots, L, dt, device=device,
                                         mesh=mesh, group=group), steps)


def slot_counts(slots, world):
    """The powers of two from ``world`` up to ``slots``."""
    counts, n = [], world
    while n <= slots:
        counts.append(n)
        n *= 2
    if not counts or counts[-1] != slots:
        raise ValueError(f"--slots {slots} is not {world} times a power "
                         "of two")
    return counts


def shared_note(device, world):
    holder = "one card" if device.type == "cuda" else "the CPU"
    return (f"{world} rank(s) hold several shard slots each: the slots "
            f"share {holder}, so the total Gnnz/s per slot count measures "
            "what the slot exchange costs (total-throughput retention), "
            "not weak scaling, which needs two or more cards. Headline "
            "regime = banded float64 BSR (reference-accuracy halo "
            "exchange); the hypercube regimes exchange whole slots.")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--L-base", type=int, default=14)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dt", type=float, default=0.05)
    ap.add_argument("--mode",
                    choices=("hypercube", "hypercube-dd", "banded-dd",
                             "banded-vs-ag", "both", "all"),
                    default="both",
                    help="hypercube = spin chain with slot-bit exchange "
                         "(f32); hypercube-dd = the same at reference "
                         "accuracy on the flip kernels; banded-dd = "
                         "float64 BSR halo exchange (the headline regime);"
                         " both = banded-dd + hypercube; all = all three; "
                         "banded-vs-ag = halo vs all-gather vs none at "
                         "the largest slot count")
    ap.add_argument("--R-local", type=int, default=64,
                    help="banded-dd: block-rows per slot")
    ap.add_argument("--block", type=int, default=32,
                    help="banded-dd: block size")
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="shorthand for --device cpu --slots N")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--slots", type=int, default=None,
                    help="total shard slots (default: one per rank)")
    args = ap.parse_args(argv)

    from quantumpropagators_torch.ops.operators import (resolve_device,
                                                        set_default_device)
    from quantumpropagators_torch.parallel.distributed import \
        initialize_multihost

    if args.cpu:
        args.device, args.slots = "cpu", args.cpu
    device = resolve_device(args.device)  # raises without a GPU
    group, started = None, False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or dist.is_initialized():
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
            torch.cuda.set_device(device)
        set_default_device(device)
        if not dist.is_initialized():
            initialize_multihost()
            started = True
        group = dist.group.WORLD
    else:
        set_default_device(device)
    try:
        out = measure(args, device, group)
    finally:
        if started:
            dist.destroy_process_group()
    if out is not None:
        print(json.dumps(out), flush=True)
    return out


def measure(args, device, group):
    """The mode's JSON line (``None`` on ranks other than 0)."""
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    say = log if rank == 0 else (lambda *a: None)
    counts = slot_counts(args.slots or world, world)
    shared = counts[-1] > world
    pinned = (shared and device.type == "cpu"
              and len(os.sched_getaffinity(0)) == 1)
    card = card_line(device)
    kw = dict(device=device, group=group)

    def table_for(run_point):
        results = {}
        for n in counts:
            gnnz, label = run_point(n)
            results[n] = {"size": label, "gnnz_total": gnnz,
                          "gnnz_per_dev": gnnz / n}
            say(f"{n} slots, {label}: {gnnz:.2f} Gnnz/s total, "
                f"{gnnz / n:.2f}/slot")
        base = results[counts[0]]["gnnz_per_dev"]
        base_total = results[counts[0]]["gnnz_total"]
        for n in counts:
            results[n]["efficiency"] = results[n]["gnnz_per_dev"] / base
            results[n]["total_retention"] = (results[n]["gnnz_total"]
                                             / base_total)
        return results

    if args.mode == "banded-vs-ag":
        # the same shards, the same slots: only the exchange differs
        n = counts[-1]
        res = {}
        for comm in ("banded", "allgather", "none"):
            res[comm] = run_config_banded_dd(n, args.R_local, args.block,
                                             args.steps, args.dt, comm, **kw)
            say(f"{n} slots [{comm}]: {res[comm]:.3f} Gnnz/s total")
        ratio = res["banded"] / max(res["allgather"], 1e-12)
        exch_cost = 1.0 - res["banded"] / max(res["none"], 1e-12)
        out = {
            "metric": "banded_halo_vs_allgather_gnnz_ratio",
            "value": ratio,
            "unit": (
                f"banded-halo / all-gather total Gnnz/s at {n} shards "
                "(same shards, same emulation overhead; >1 = the "
                "shard-size-independent halo exchange wins)"
            ),
            "vs_baseline": None,
            "n_devices": n,
            "exchange_cost_vs_no_comm": exch_cost,
            "note": (
                "'none' = block-diagonal (zero exchange, same FLOPs): "
                "banded/none isolates the halo-exchange cost. "
                + (shared_note(device, world) if shared else "")
            ),
            "tables": {"banded": res["banded"],
                       "allgather": res["allgather"],
                       "no_comm": res["none"],
                       "size": f"R_local={args.R_local},b={args.block}"},
            "card": card,
        }
        return out if rank == 0 else None

    tables = {}
    if args.mode in ("banded-dd", "both", "all"):
        say("=== banded-dd regime (reference accuracy, halo exchange) ===")
        tables["banded_dd"] = table_for(lambda n: (
            run_config_banded_dd(n, args.R_local, args.block, args.steps,
                                 args.dt, **kw),
            f"R_local={args.R_local},b={args.block}"))
    chain_L = {n: args.L_base + int(np.log2(n // counts[0])) for n in counts}
    if args.mode in ("hypercube", "both", "all"):
        say("=== hypercube regime (spin chain, slot-bit exchange) ===")
        tables["hypercube"] = table_for(lambda n: (
            run_config(n, chain_L[n], args.steps, args.dt, **kw),
            f"L={chain_L[n]}"))
    if args.mode in ("hypercube-dd", "all"):
        say("=== hypercube regime at reference accuracy (sharded dd) ===")
        tables["hypercube_dd"] = table_for(lambda n: (
            run_config_hypercube_dd(n, chain_L[n], args.steps, args.dt,
                                    **kw),
            f"L={chain_L[n]}"))
    if rank != 0:
        return None

    head = (tables.get("banded_dd") or tables.get("hypercube")
            or tables["hypercube_dd"])
    last = head[counts[-1]]
    value = last["total_retention"] if shared else last["efficiency"]
    return {
        "metric": (
            "weak_scaling_total_retention_shared_virtual" if shared
            else "weak_scaling_efficiency"
        ),
        "value": value,
        "unit": (
            "total nnz/s at n devices / total nnz/s at 1 device "
            "(PASS >= 1.0: virtual devices share one socket)"
            if shared else "nnz/s-per-device vs 1 device (target >= 0.8)"
        ),
        "pass_criterion": (
            "retention >= 0.8 (single PINNED core: n-fold work on "
            "constant compute, so retention = exchange-mechanics "
            "efficiency, directly comparable to the real-chip 0.8 bar)"
            if pinned else (
                "retention >= 1.0 on shared-socket virtual devices"
                if shared else "efficiency >= 0.8 on real chips"
            )
        ),
        "vs_baseline": value / (0.8 if (pinned or not shared) else 1.0),
        "regime": next(r for r in ("banded_dd", "hypercube", "hypercube_dd")
                       if r in tables),
        "tables": tables,
        "note": shared_note(device, world) if shared else None,
        "card": card,
    }


if __name__ == "__main__":
    main()
