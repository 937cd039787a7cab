"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``quantumpropagators_torch/csrc``
with ``nvcc``, holds each kernel instantiation against its plain PyTorch
version, then runs Chebyshev propagation through
``propagate(..., fused=True)`` on two paths:

- phases 2-6: the driven transverse-field Ising chain at L = 24 (2^24
  states) in the reference-accuracy tier (``kernel="dd"``, complex128)
  and the f32 tier (``kernel="pallas"``, complex64), on the flip kernels;
- phase 7: the static block-banded chain of ``bench.py --config banded20``
  at 2^20 states (8192 coupled 128-level units) in the reference tier
  (``kernel="dd"``), on the banded SpMV kernel.

Phase 9 then runs the Krylov methods on phase 7's operator and band
planes, again on the banded SpMV kernel: fixed-Leja Newton through
``propagate(..., fused=True, method="newton_leja")`` over the same 20
steps, and ``newton`` and ``expv`` at ``precision="dd"`` over 5 steps,
each held against phase 7's Chebyshev result; and every registered
method on two small configurations against host ``expm`` oracles.

Phase 10 runs the sharded layer (``quantumpropagators_torch.parallel``)
on four shard slots of the one card over a world-size-1 NCCL group: the
L = 24 chain in both tiers against phases 3 and 4, with a trace of each,
and again on 32 slots (five slot-bit partners a high pass), one step
with a zero-coupling slot bit, banded20 against phase 7 (band
planes split on the card), and small chain, CSR and BSR checks; norms go
through the mesh's ``psum``.  Phase 2 holds the flip kernels on a
4-slot stack as phase 10 launches them (and with 2, 5 and 8 slot-bit
partners), and phase 10 holds the banded
kernel on each slot's planes.

Phase 11 runs the Krylov methods on a sharded state over the same
group: phase 7's banded20 operator partitioned into 4 slots
(``partition_bsr`` in halo mode) behind ``DistributedBSR``, so that
``specrange``, ``newton`` and ``expv`` reduce over the mesh's ``psum``;
it holds them against the unsharded ``specrange`` and phase 7's
Chebyshev result, runs ``check_propagator`` on a sharded Newton
propagator and on every registered method at the N = 1024 sparse
Hermitian, and traces one sharded Newton step (slab matvec, CGS2 and
halo exchange).  Its slab matvec is the plain ``torch.einsum``, as the
JAX class's is, so it launches none of the kernels.

Phase 12 runs the last modules of the port: (a) 5 planar steps
(``ops/planar.py``, float32 planes) of the static L = 24 chain against 5
f32 flip-kernel steps; (b) an ``(8, 2^20)`` batch through ``cheby_apply``
against single calls, and ``torch.func.vmap`` over 8 drive amplitudes
against a loop; (c) gradients through ``make_fused_cheby_propagator`` on
5 intervals of phase 3's chain at L = 24 (the forward against phase 3
and ``kernel="dd"``, autograd against finite differences, 3 descent
steps, a trajectory cost through ``observable_fn``, the peak device
memory); (d) the host assembly library (``native.py``, built with
``g++``): the 2^20 chain and 4 × 5 lattice assembled on the host, held
against the lattice operators and the ``kernel="dd"`` path on the card.

Phase 13 runs ``bench_torch.py`` (the port of ``bench.py``) through its
command line, one process per mode (``BENCH_MODES``): the headline chain
at 2^20 with each of the four kernels (dd with the f64 host oracle), the
4 × 6 lattice and northstar (100 steps) at 2^24 without the oracle,
banded20, multiamp, optomech, newton, transmon and rabi.  Each JSON line
must hold every key of the ``bench.py`` line it mirrors (read from
``bench.py``'s source with ``ast``), finite numbers and the modes'
accuracy bounds; its launches are not counted in the kernels line.

Phase 14 runs the port's entry points: ``scaling_torch.py``'s
reference-accuracy chain regime (hypercube-dd) in this process at L = 24,
4 slots against 1 slot and one step against the f64 host oracle, its
flip launches counted; the four ``examples/*_torch.py`` (GRAPE, Krotov,
the multi-amplitude dd chain, the sharded chain) as processes, held at
the numbers the JAX examples reach; and ``scaling_torch.py``'s command
line through its ``main`` in this process (``--mode all`` and ``--mode
banded-vs-ag`` on 4 slots, chains 2^22 → 2^24, banded 2^18 → 2^20),
each run alone on the card, each JSON line held against
``scaling.py``'s (read with ``ast``).

Phase 15 (after phase 9, while its operators live) runs the fused
layer's one-program scan (``quantumpropagators_torch.utils.scan``): each
routed path's own step (the L = 24 dd and f32 main path,
``bench_torch.py``'s 2^20 dd chain, multiamp at 2^20, banded20 dd and
fixed-Leja Newton on banded20) as the eager loop and as a replayed CUDA
graph, bit for bit and with equal launches a step, with steps/s and host
µs a step both ways; traces of 5 dd steps at 2^20 and 2^24 both ways;
``make_fused_cheby_propagator`` on three tables with one capture; and an
observable that reads the host, which must raise at capture.  Every
fused path of the other phases (3, 4, 5, 7, 8, 9, 12, 13) runs through
the same graphs.

Phase 16 (after phase 15, before phase 10's NCCL group) runs the port
of the TPU probes under ``docs/profiling/``
(``quantumpropagators_torch/profiling/`` on ``csrc/probes.cu``): every
probe kernel against its plain version (bit for bit where the kernel
adds in the plain version's order), each timed beside its plain
version, its bound and the library call that computes the same function
(``copy_``, ``addcmul``, ``torch.matmul`` with TF32 on and off), then
each probe module's command line at 5 repetitions with the launch
counts set to 0 before and read after (stream rates, XOR-scattered
streaming, four flip formulations, the flip order's stages at L = 24,
FMA contraction, σ-extraction and tensor-core exactness).  Its kernels
join the kernels line.

Phase 17 (after phase 10, on its world-size-1 NCCL group and 4 slots)
runs every sharded step of ``parallel/`` as one replayed CUDA graph a
call (``utils/scan.graphed``, the port of the JAX package's
``jax.jit(shard_map(...))`` sites) against its own body run eagerly:
the L = 24 chain in both tiers with a tensor and with a Python-float
flip scale that changes every call, banded20 over 4 slots, the BSR
complex and dd steps on banded20's partition, the chain step over
``sharded_apply`` at L = 24 and the BSR and CSR applies; each bit for
bit with equal launches a call, one capture over its calls and one
more for a new operator, with steps/s and host µs a call both ways;
then traces of 3 dd chain steps graphed and eager (busy share).  Phases
10, 14 and the sharded example step through the same graphs.

Phase 18 (after phase 9, before the NCCL group) runs the stepwise path's
graphed sites (the port of the JAX package's ``jax.jit`` of the Chebyshev
interval and of the Arnoldi iteration) graphed and with every site's body
run eagerly: (a) 20 stepwise ``propagate(method="cheby",
precision="dd")`` intervals on banded20 with phase 7's band planes as
``dd_operator_terms`` (bit for bit both ways, within 1e-10 of phase 7,
``orders − 1`` banded launches an interval); (b) 100 stepwise intervals
with ``check_normalization=True`` on the N = 10 transmon and a driven
N = 1024 sparse Hermitian, amplitudes changing every interval: one
capture a propagator, none for new controls nor for a moved envelope
of the same length; and 20 ``newton`` and ``expv`` steps in complex128
on both (the Arnoldi call and Newton's restart tail or ``expv``'s
combine each a graph); (c) the Arnoldi site: ``specrange`` on banded20
(``Hess`` bit for bit), 5 ``newton`` and ``expv`` dd steps (one capture
a propagator for the Arnoldi site and one a Krylov dimension for the
tail, none after the first propagation, matvecs = banded launches, host
reads a restart), and the reserved memory before an envelope, after it
and after its propagator is dropped; (d) the standalone dd Chebyshev
applies as graphed sites: ``cheby_apply_dd`` on the L = 20 chain and
``cheby_apply_dd_bsr`` on an optomech chain, 10 calls with new
coefficients in one scope against 10 eager calls (bit for bit, one
capture, host oracles at 1e-10); (e) a ``torch.cos`` control with the
default ``check`` through ``cheby``, ``newton``, ``expprop`` and
``ode`` against a ``numpy`` control at 1e-12.

Phase 19 (after phase 18) runs the stepwise ODE and expprop intervals
(the port of the JAX package's ``lax.while_loop`` of DP5 under the
``jax.jit`` of ``_pwc_ode_step`` and ``_cont_step``, and of
``_exp_step``) graphed (captured chunks of masked DP5 attempts, the
step control on the card, one flag read a chunk; one graph an expprop
interval) and with every site's body run eagerly: (a) ``method="ode"``
``pwc=True`` and continuous (a ``torch.cos`` drive) on phase 9's
N = 1024 sparse Hermitian (its drive term the operator itself, so that
``expm`` of the integrated generator is the oracle, 1e-7) and on 10
intervals of the N = 10 transmon; (b) both variants on the driven
L = 20 chain over 2 intervals of DT (the continuous drive the chain's
flattop in ``torch`` math), against fused dd Chebyshev results at 1e-7;
(c) ``method="expprop"`` on both small systems against ``expm`` at
1e-10.  Each path: steps/s both ways, attempts and host reads an
interval, one capture a propagator and none after ``reinit_prop`` or
for a new time grid of the same length, graph equal to eager bit for
bit, peak reserved memory both ways.

It checks the results, and times every kernel beside its plain version,
its bound and (where one exists) the one PyTorch call that computes the
same function.  The flip setup and the flip iteration are two kernels
each on the card (the high pass ``cheby_flip_high`` for the top bits,
then the tiled pass ``cheby_flip_first`` or ``cheby_flip_iter``); phase
6 times each as the whole wrapper call and each pass alone, and phase 8
records a ``torch.profiler`` trace of 5 reference-tier steps at L = 24.
One line per phase; the second-to-last line is the kernels' JSON record,
the last line ``{"ok": true, "device": ...}``.
Any failed check raises, and the script exits nonzero without printing
a result.  It refuses to run without a CUDA device.
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import torch

from quantumpropagators_torch.profiling import HBM_BYTES_S, card_line

T_START = time.perf_counter()
SEED = 20240611
L_MAIN = 24          # 2^24 states: the BASELINE north-star size
L_CHECK = 20         # kernel-vs-plain and round-trip size
N_STEPS = 20
DT = 0.05
J, G_FIELD, H_FIELD = 1.0, 1.2, 0.3
SOURCE = "quantumpropagators_torch/csrc/cheby_flip.cu"
BANDED_SOURCE = "quantumpropagators_torch/csrc/banded_spmv.cu"
BANDED = "banded_spmv<double>"
BANDED_REPLACES = "quantumpropagators/ops/bsr_dd_pallas.py:267"
N_BANDED = 2 ** 20   # bench.py --config banded20: 2^20 amplitudes
PARTNER_L_SUM = 16   # phase 2's slots without top bits (h = 0): 4 x 2^16
# phase 2's one-rank meshes at L_MAIN: P = 2, 5 and 8 slot bits, each a
# partner of every high pass (4 x 2^22, h = 4; phase 10's 32 x 2^19, h = 1;
# 256 x 2^16, h = 0)
PARTNER_SLOTS = (4, 32, 256)
WIDE_SLOTS = 32      # phase 10's wide mesh: five slot-bit partners a pass
B_BANDED = 128       # 128-level units, dense blocks
GRAD_CALLS = 2       # phase 17 under autograd: chained calls at full width
GRAD_CALLS_SMALL = 3  # ... and at 2^14
# H100 SXM peaks (NVIDIA data sheet): FP64 / FP32 FLOP/s outside the
# tensor cores (the HBM rate is profiling.HBM_BYTES_S)
PEAK_FLOPS = {"double": 34e12, "float": 67e12,
              # dense tensor-core rates: TF32 and FP64 (probe phase 16)
              "tf32": 495e12, "fp64 mma": 67e12}
# file:line of the pl.pallas_call each instantiation replaces
REPLACES = {
    "cheby_flip_first<float>": "quantumpropagators/ops/fused_cheby.py:440",
    "cheby_flip_iter<float>": "quantumpropagators/ops/fused_cheby.py:474",
    "cheby_flip_high<float>": "quantumpropagators/ops/fused_cheby.py:474",
    "cheby_flip_first<double>": "quantumpropagators/ops/fused_cheby_dd.py:1063",
    "cheby_flip_iter<double>": "quantumpropagators/ops/fused_cheby_dd.py:1022",
    "cheby_flip_high<double>": "quantumpropagators/ops/fused_cheby_dd.py:1022",
}
ALSO_REPLACES = {
    # the dd path's f32 tail runs on the float iteration and its high
    # pass; the high pass also runs before the setup's tiled pass
    "cheby_flip_iter<float>": "quantumpropagators/ops/fused_cheby_dd.py:1165",
    "cheby_flip_high<float>": "quantumpropagators/ops/fused_cheby_dd.py:1165"
                              ", quantumpropagators/ops/fused_cheby.py:440",
    "cheby_flip_high<double>": "quantumpropagators/ops/fused_cheby_dd.py:1063"
                               ", docs/profiling/scratch_prof_dd.py:68",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(n_bytes, flops, ctype):
    """Least time (ms) the card could take to move ``n_bytes`` and do
    ``flops`` operations of type ``ctype``; returns (ms, what bounds it)."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[ctype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_state(L, dtype, device, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi /= np.linalg.norm(psi)
    return torch.as_tensor(psi).to(device=device, dtype=dtype)


def kernel_inputs(L, ctype, device, seed):
    """Seeded inputs for one launch at size 2^L, made on the card: unit
    states, a generic ``dmb = diag − β`` with β ≠ 0 (the chain's Ising
    diagonal), and per-bit flip coefficients."""
    from quantumpropagators_torch.models.lattice import (z_chain_diagonal,
                                                         zz_chain_diagonal)

    cdtype = torch.complex64 if ctype == "float" else torch.complex128
    rdtype = torch.float32 if ctype == "float" else torch.float64
    rng = np.random.default_rng(seed)
    kw = dict(dtype=torch.float64, device=device)
    diag = zz_chain_diagonal(L, J, **kw) + z_chain_diagonal(L, H_FIELD, **kw)
    beta = 0.37 * L
    dmb = (diag - beta).to(rdtype)
    G = torch.as_tensor(rng.uniform(0.5, 1.5, L)).to(device=device,
                                                      dtype=rdtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)

    def state():
        v = torch.randn(2 ** L, generator=gen, dtype=torch.complex128,
                        device=device)
        return (v / torch.linalg.vector_norm(v)).to(cdtype)

    v0, v1, phi = state(), state(), state()
    s = -2.0 / (2.5 * L)
    return v0, v1, phi, dmb, G, s


def run_instantiation(name, inputs, plain: bool, h=None, w=None):
    """One call of ``name``'s wrapper (kernel or plain version) on copies
    of ``inputs``, with ``w`` added to every product (the high pass:
    ``w``, default ``v0``); returns the output tensors.  The iteration's
    wrapper runs both passes where its split has a high pass; the high
    pass takes ``h`` bits (default: the split's own)."""
    from quantumpropagators_torch.ops import cheby_flip as cf

    v0, v1, phi, dmb, G, s = inputs
    kind = name.split("<")[0]
    if kind == "cheby_flip_first":
        fn = cf.cheby_flip_first_plain if plain else cf.cheby_flip_first
        return fn(v0, dmb, G, s, 0.81, -0.45, w)
    if kind == "cheby_flip_high":
        fn = cf.cheby_flip_high_plain if plain else cf.cheby_flip_high
        if h is None:
            h = cf.flip_split(G.numel(), v1.dtype)[1]
        return (fn(v1, G, h, v0 if w is None else w),)
    fn = cf.cheby_flip_iter_plain if plain else cf.cheby_flip_iter
    v0c, phic = v0.clone(), phi.clone()
    fn(v0c, v1, phic, dmb, G, 2.0 * s, 0.13, w)
    return v0c, phic


def slot_stack(inputs, slots=4):
    """Phase 10's per-slot launches at L_MAIN: the L_MAIN ``inputs`` as a
    ``(slots, 2^(L_MAIN − p))`` stack of slot states with the slot-local
    flip coefficients, and a stack ``w`` standing in for the slot bits'
    exchanged flips; returns ``(stack_inputs, w)``."""
    v0, v1, phi, dmb, G, s = inputs
    p = slots.bit_length() - 1
    stack = tuple(x.view(slots, -1) for x in (v0, v1, phi, dmb))
    w = torch.roll(v1, 1 << (L_MAIN - 1)).view(slots, -1)
    return stack + (G[:L_MAIN - p].contiguous(), s), w


def check_cases(name):
    """The ``(L, h)`` at which phase 2 holds ``name`` against its plain
    version (``h = None``: the split's own): every kernel at
    ``flip_check_sizes``, L_CHECK, L_MAIN − 2 (phase 10's slots) and
    L_MAIN; the high pass at those of them where it runs, and at L_MAIN
    for every h it takes."""
    from quantumpropagators_torch.ops import cheby_flip as cf

    kind, ctype = name[:-1].split("<")
    cdtype = torch.complex64 if ctype == "float" else torch.complex128
    sizes = sorted(set(cf.flip_check_sizes(cdtype))
                   | {L_CHECK, L_MAIN - 2, L_MAIN})
    if kind != "cheby_flip_high":
        return [(L, None) for L in sizes]
    cases = [(L, None) for L in sizes if cf.flip_split(L, cdtype)[1]]
    max_h = cf.flip_split(cf.MAX_BITS, cdtype)[1]
    return cases + [(L_MAIN, h) for h in range(1, max_h + 1)]


def compare_kernels(device):
    """Phase 2: every instantiation against its plain version at the
    cases of :func:`check_cases`, the inputs of each size and type built
    once, on :func:`slot_stack`'s 4-slot stack with a ``w``, and with the
    slot bits' partners (:func:`compare_partners`); returns
    ``{name: max_abs_err}`` over all of them."""
    errs = {}
    for ctype in ("float", "double"):
        cases = {name: check_cases(name) for name in REPLACES
                 if name.endswith(f"<{ctype}>")}
        for L in sorted({L for c in cases.values() for L, _ in c}):
            inputs = kernel_inputs(L, ctype, device, SEED)
            for name, name_cases in cases.items():
                for h in (h for L_, h in name_cases if L_ == L):
                    errs[name] = max(compare_case(name, ctype, inputs, L, h),
                                     errs.get(name, 0.0))
            if L == L_MAIN:
                stack, w = slot_stack(inputs)
                for name in cases:
                    errs[name] = max(compare_case(
                        name, ctype, stack, L_MAIN - 2, None, w), errs[name])
                del stack, w
            if L == L_MAIN:
                for slots in PARTNER_SLOTS:
                    for name, err in compare_partners(ctype, inputs,
                                                      slots).items():
                        errs[name] = max(err, errs[name])
            del inputs
        inputs = kernel_inputs(PARTNER_L_SUM + 2, ctype, device, SEED)
        for name, err in compare_partners(ctype, inputs).items():
            errs[name] = max(err, errs[name])
        del inputs
        for name, name_cases in cases.items():
            where = ", ".join(f"{L}" if h is None else f"{L} (h={h})"
                              for L, h in name_cases)
            meshes = ", ".join(
                f"{n} x 2^{L_MAIN - n.bit_length() + 1}"
                for n in PARTNER_SLOTS)
            log(f"phase 2 kernel-vs-plain {name}: ok at L = {where}, "
                f"on a 4 x 2^{L_MAIN - 2} slot stack with w and with the "
                f"slot bits' partners on {meshes} (and on 4 x "
                f"2^{PARTNER_L_SUM}), max|d| = {errs[name]:.3e}")
    return errs


def partner_inputs(inputs, slots=4):
    """The one-rank sharded step's partner launches on ``inputs`` seen
    as a ``slots``-slot stack: the stack ``x`` (``v1``'s rows), the
    slot-local flip coefficients followed by the ``p = log2(slots)``
    slot bits', and the slot bits' partners, rows ``s ^ 2^r`` of ``x``
    itself for ``r < p``."""
    v0, v1, phi, dmb, G, s = inputs
    p = slots.bit_length() - 1
    L = G.numel() - p
    x = v1.view(slots, -1)
    return x, G, [(x, 1 << r) for r in range(p)], L


def compare_partners(ctype, inputs, slots=4):
    """Phase 2's partner cases on :func:`partner_inputs`' stack of
    ``slots`` (at L_MAIN: :data:`PARTNER_SLOTS`; 4 x 2^PARTNER_L_SUM:
    h = 0): the high pass with the slot bits' partners against its plain
    version, with and without a ``w``, and the whole setup and order
    with them; returns ``{name: max_abs_err}``."""
    from quantumpropagators_torch.ops import cheby_flip as cf

    v0, v1, phi, dmb, G, s = inputs
    x, G_all, parts, L = partner_inputs(inputs, slots)
    h = cf.flip_split(L, v1.dtype)[1]
    y0, d4, ph = (t.view(x.shape) for t in (v0, dmb, phi))
    calls = {
        f"cheby_flip_high<{ctype}>": lambda f: (
            f(x, G_all, h, partners=parts), f(x, G_all, h, y0, parts)),
        f"cheby_flip_first<{ctype}>": lambda f: f(
            x, d4, G_all, s, 0.81, -0.45, partners=parts),
        f"cheby_flip_iter<{ctype}>": lambda f: (f(
            y0.clone(), x, ph.clone(), d4, G_all, 2.0 * s, 0.13,
            partners=parts),),
    }
    plains = {"cheby_flip_high": cf.cheby_flip_high_plain,
              "cheby_flip_first": cf.cheby_flip_first_plain,
              "cheby_flip_iter": cf.cheby_flip_iter_plain}
    errs = {}
    for name, call in calls.items():
        kind = name.split("<")[0]
        got = call(getattr(cf, kind))
        want = call(plains[kind])
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        scale = max(float(b.abs().max()) for b in want)
        ok = err <= (1e-13 if ctype == "double" else 1e-5 * scale)
        log(f"phase 2 kernel-vs-plain {name} {slots} x 2^{L} slot stack "
            f"with the slot bits' {len(parts)} partners (h={h}): "
            f"max|d|={err:.3e} max|ref|={scale:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} with partners disagrees with its "
                                 f"plain version at {slots} x 2^{L}")
        errs[name] = err
    return errs


def compare_case(name, ctype, inputs, L, h, w=None):
    """One case of phase 2 (``w``: on a slot stack, with that ``w``);
    returns its max-abs error or raises."""
    got = run_instantiation(name, inputs, plain=False, h=h, w=w)
    want = run_instantiation(name, inputs, plain=True, h=h, w=w)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    scale = max(float(b.abs().max()) for b in want)
    if ctype == "double":
        ok = err <= 1e-13
        tol = "max|d| <= 1e-13"
    else:
        ok = err <= 1e-5 * scale
        tol = "max|d| <= 1e-5 * max|ref|"
    if (h is None and L in (L_CHECK, L_MAIN)) or w is not None or not ok:
        where = f"L={L}" if w is None else f"4 x 2^{L} slot stack with w"
        log(f"phase 2 kernel-vs-plain {name} {where}: "
            f"max|d|={err:.3e} max|ref|={scale:.3e} ({tol}) "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain "
                             f"version at L={L}, h={h}, stack "
                             f"{w is not None}")
    return err


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


def check_launches(tier, counts, ctype, n_steps=N_STEPS):
    """One ``n_steps``-step run of ``tier`` launched the setup's tiled
    pass once a step in ``ctype``, the iteration's in ``ctype`` (and, in
    the dd tier, the f32 tail's in float), and the high pass once before
    each tiled pass: ``high = first + iter`` in each type."""
    other = "float" if ctype == "double" else "double"
    want_first = {ctype: n_steps, other: 0}
    iters = ("double", "float") if tier == "dd" else ("float",)
    ok = all(counts[f"cheby_flip_iter<{c}>"] > 0 for c in iters)
    for c in ("float", "double"):
        first, it, high = (counts[f"cheby_flip_{k}<{c}>"]
                           for k in ("first", "iter", "high"))
        ok &= first == want_first[c] and high == first + it
    if not ok:
        raise AssertionError(f"{tier} path launches: {counts} (expected "
                             f"{n_steps} setups in {ctype} and one high "
                             f"pass before every tiled pass)")


def median_wall(run, reps=3):
    """``run()``'s last result and the median of ``reps`` wall times of
    it, each synchronized: one run's time on a shared host varies by a
    few percent."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, float(np.median(walls))


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
    check_launches("dd", launches["dd"], "double")
    # timed runs: the same path without observables, after the one above
    psi_dd, t_dd = median_wall(lambda: qt.propagate(
        psi0, H, tlist, method="cheby", fused=True, kernel="dd",
        workspace=wrk))
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

    def run_32():
        return qt.propagate(psi0.to(torch.complex64), H, tlist,
                            method="cheby", fused=True, kernel="pallas",
                            workspace=wrk)

    psi_32 = run_32()
    torch.cuda.synchronize()
    launches["pallas"] = dict(cf.LAUNCHES)
    check_launches("pallas", launches["pallas"], "float")
    _, t_32 = median_wall(run_32)
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
    return launches, rates, matvecs, (psi0, H, wrk), (psi_dd, psi_32), p_xla


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
    """Milliseconds a call of ``fn``: ``reps`` eager calls back to back
    between two CUDA events after two warm-ups, the host's cost of a call
    included where it exceeds the device's.  The package kernels (phase 6)
    and every plain version are timed so; the probe kernels and library
    calls of phase 16 by ``profiling.time_ms``, a replayed CUDA graph."""
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
    every repetition, as it does inside a step.  The setup's and the
    order's time is the whole wrapper call (high pass and tiled pass),
    held against the setup's or the order's bound, and each pass is also
    timed alone."""
    from quantumpropagators_torch.ops import cheby_flip as cf

    times = {}
    for name in REPLACES:
        kind, ctype = name[:-1].split("<")
        v0, v1, phi, dmb, G, s = kernel_inputs(L_MAIN, ctype, device, SEED)
        h = cf.flip_split(L_MAIN, v0.dtype)[1]
        vec = v0.numel() * v0.element_size()
        g_bytes = G.numel() * G.element_size()
        ins = dmb.numel() * dmb.element_size() + g_bytes
        # each input read once and each output written once: first reads
        # v0, dmb, G and writes v1, Φ; iter reads v0, v1, Φ, dmb, G and
        # writes v2, Φ; the high pass reads v1, G and writes w_hi.
        # Operations per element: 4 per flip and for the diagonal, 12 for
        # the recurrence and the Φ update.
        if kind == "cheby_flip_first":
            def run(fn):
                return lambda: fn(v0, dmb, G, s, 0.81, -0.45)

            kernel, plain = cf.cheby_flip_first, cf.cheby_flip_first_plain
            n_bytes, flops = ins + 3 * vec, (4 * L_MAIN + 16) * v0.numel()
        elif kind == "cheby_flip_high":
            def run(fn):
                return lambda: fn(v1, G, h)

            kernel, plain = cf.cheby_flip_high, cf.cheby_flip_high_plain
            n_bytes, flops = g_bytes + 2 * vec, 4 * h * v0.numel()
        else:
            def run(fn):
                return lambda: fn(v0, v1, phi, dmb, G, 2.0 * s, 0.13)

            kernel, plain = cf.cheby_flip_iter, cf.cheby_flip_iter_plain
            n_bytes, flops = ins + 5 * vec, (4 * L_MAIN + 16) * v0.numel()
        ms = time_ms(run(kernel), 20)
        plain_ms = time_ms(run(plain), 3)
        bound_ms, bound_by = bound(n_bytes, flops, ctype)
        times[name] = (ms, plain_ms, bound_ms, bound_by)
        what = {"cheby_flip_first": f"setup (high pass h={h} + tiled "
                                    f"setup pass)",
                "cheby_flip_iter": f"order (high pass h={h} + iteration "
                                   f"pass)",
                "cheby_flip_high": f"high pass alone (h={h})"}[kind]
        log(f"phase 6 time {name} L={L_MAIN}: {what} {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}, {100 * bound_ms / ms:.1f} % of it reached) [{card}]")
        if kind == "cheby_flip_high":
            for slots in (4, WIDE_SLOTS):
                time_partners(name, (v0, v1, phi, dmb, G, s), card, slots)
        if kind == "cheby_flip_first":
            # each pass alone, beside the bytes it moves: the high pass
            # reads v0 and writes w_hi; the tiled pass reads v0, dmb and
            # w_hi and writes v1 and Φ
            hi_ms = time_ms(lambda: cf.cheby_flip_high(v0, G, h), 20)
            w_hi = cf.cheby_flip_high(v0, G, h)
            lo_ms = time_ms(lambda: cf.cheby_flip_first_low(
                v0, dmb, G, s, 0.81, -0.45, L_MAIN - h, w_hi), 20)
            hi_bound = bound(g_bytes + 2 * vec, 4 * h * v0.numel(), ctype)[0]
            lo_bound = bound(ins + 4 * vec, (4 * L_MAIN + 16) * v0.numel(),
                             ctype)[0]
            log(f"phase 6 time {name} L={L_MAIN}: high pass alone on v0 "
                f"{hi_ms:.4f} ms (its bytes' bound {hi_bound:.4f} ms), "
                f"tiled setup pass alone (bits < {L_MAIN - h}, w_hi read) "
                f"{lo_ms:.4f} ms (its bytes' bound {lo_bound:.4f} ms) "
                f"[{card}]")
            del w_hi
        if kind == "cheby_flip_iter":
            w_hi = cf.cheby_flip_high(v1, G, h)
            it_ms = time_ms(lambda: cf.cheby_flip_iter_low(
                v0, v1, phi, dmb, G, 2.0 * s, 0.13, L_MAIN - h, w_hi), 20)
            log(f"phase 6 time {name} L={L_MAIN}: iteration pass alone "
                f"(bits < {L_MAIN - h}, w_hi read) {it_ms:.4f} ms [{card}]")
            del w_hi
        del v0, v1, phi, dmb
    return times


def time_partners(name, inputs, card, slots=4):
    """Phase 6: the high pass as the one-rank ``slots``-slot sharded step
    runs it at L_MAIN (:func:`partner_inputs`: 4 x 2^22, h = 4, or 32 x
    2^19, h = 1; the P slot bits' partners read in the kernel) beside
    its plain version, its bound (each slot's x and P partners read and
    w_hi written once: 32 + 16 P bytes an element in double, 16 + 8 P in
    float) and the same sum the way the step made it before the high
    pass read partners: the partner rows copied into stacks, their
    weighted sum in PyTorch, and the high pass reading it as its w.  The
    kernel and that way are timed by ``profiling.time_ms`` (a replayed
    CUDA graph): eager, the host's cost of 32 slot launches outlasts
    their device time."""
    from quantumpropagators_torch.ops import cheby_flip as cf
    from quantumpropagators_torch.profiling import time_ms as graph_ms

    ctype = name[:-1].split("<")[1]
    x, G_all, parts, L = partner_inputs(inputs, slots)
    h = cf.flip_split(L, x.dtype)[1]
    G_loc = G_all[:L].contiguous()
    n, vec = x.numel(), x.numel() * x.element_size()
    ms = graph_ms(lambda: cf.cheby_flip_high(x, G_all, h, partners=parts),
                  20)
    plain_ms = time_ms(lambda: cf.cheby_flip_high_plain(
        x, G_all, h, partners=parts), 3)

    def copies_then_sum():
        terms = [G_all[L + r] * torch.stack([x[j ^ k]
                                             for j in range(x.shape[0])])
                 for r, (_, k) in enumerate(parts)]
        return cf.cheby_flip_high(x, G_loc, h, sum(terms[1:], terms[0]))

    old_ms = graph_ms(copies_then_sum, 20)
    b_ms, b_by = bound(G_all.numel() * G_all.element_size()
                       + (2 + len(parts)) * vec, 4 * (h + len(parts)) * n,
                       ctype)
    log(f"phase 6 time {name} {slots} x 2^{L} slot stack with the slot "
        f"bits' {len(parts)} partners (h={h}): {ms:.4f} ms a step's order "
        f"({x.shape[0]} slot launches), plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f} % of it reached); "
        f"copies + PyTorch sum + high pass with w {old_ms:.4f} ms [{card}]")


def trace_steps(run, label, n_steps, card, top=8, regions=None,
                show_copies=False):
    """One ``torch.profiler`` trace of ``run()`` (``n_steps`` steps), after
    one untraced call of it.  Prints the device-busy share of the
    device's active window (first kernel start to last kernel end), the
    device time a step of the flip kernels, of copies and of PyTorch's
    elementwise kernels, and the device operations by time; returns the
    device ms a step of the flip kernels and of everything else.

    ``regions`` maps a name to the ``(object, attribute)`` functions
    whose calls count under it: they are wrapped in
    ``torch.profiler.record_function(name)`` for the traced call, and
    the device time of the kernels launched inside each region is
    printed a step.  Also returns the busy share of the window.  With
    ``show_copies`` each copy operation's device ms and count a step is
    printed too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    regions = regions or {}
    saved = []
    for name, targets in regions.items():
        for obj, attr in targets:
            fn = getattr(obj, attr)

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                with record_function(_name):
                    return _fn(*args, **kwargs)

            saved.append((obj, attr, fn))
            setattr(obj, attr, wrapped)
    run()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    # a region also shows as a device-side annotation span: not a kernel
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and e.name not in regions)
    if not spans:
        raise AssertionError("the trace holds no device operation")
    busy, end = 0.0, spans[0][0]
    by_name = {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + stop - start, count + 1)
    window = end - spans[0][0]
    kernel_sum = sum(t for t, _ in by_name.values())

    def ms(pred):
        return sum(t for n, (t, _) in by_name.items()
                   if pred(n)) / 1e3 / n_steps

    def is_copy(n):
        return "opy" in n or "Memcpy" in n or "CatArray" in n

    flip = ms(lambda n: "cheby_flip" in n)
    other = kernel_sum / 1e3 / n_steps - flip
    log(f"{label} {n_steps} steps: wall {1e3 * wall / n_steps:.4f} ms/step, "
        f"device window {window / 1e3 / n_steps:.4f} ms/step, busy "
        f"{100 * busy / window:.2f} % of it ({len(spans)} device "
        f"operations); device ms/step: flip kernels {flip:.4f} "
        f"({100 * flip / (flip + other):.2f} %), copies "
        f"{ms(is_copy):.4f}, PyTorch elementwise "
        f"{ms(lambda n: 'elementwise' in n and not is_copy(n)):.4f}, "
        f"all else {other:.4f} [{card}]")
    if show_copies:
        log(f"{label} copies ms/step: " + ("; ".join(
            f"{t / 1e3 / n_steps:.4f} x{count / n_steps:g}/step {name[:80]}"
            for name, (t, count) in sorted(by_name.items(),
                                           key=lambda kv: -kv[1][0])
            if is_copy(name)) or "none") + f" [{card}]")
    if regions:
        # kernels of the CPU events of each region (children included);
        # a region nested in another counts in both
        got = {name: 0.0 for name in regions}
        for e in prof.events():
            if e.name in got and e.device_type == DeviceType.CPU:
                got[e.name] += e.device_time_total
        rest = kernel_sum - sum(got.values())
        log(f"{label} device ms/step by region: " + ", ".join(
            f"{name} {t / 1e3 / n_steps:.4f} ({100 * t / kernel_sum:.2f} %)"
            for name, t in got.items())
            + f", the rest {rest / 1e3 / n_steps:.4f} "
            f"({100 * rest / kernel_sum:.2f} %) [{card}]")
        if not any(got.values()):
            raise AssertionError("the trace gives no region device time")
    for name, (t, count) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:top]:
        log(f"{label} top: {t / 1e3 / n_steps:.4f} ms/step "
            f"{100 * t / kernel_sum:.2f} % x{count // n_steps}/step "
            f"{name[:110]}")
    return flip, other, busy / window


def trace_phase(psi0, H, wrk, card, n_steps=5, top=8):
    """Phase 8: one trace of ``n_steps`` dd steps of the main path at
    L_MAIN (:func:`trace_steps`): one ``propagate`` call, so its first
    interval runs eagerly and the graph is captured inside the window
    (phase 15 traces the replays alone).  Prints each copy operation's
    ms a step: the step writes its new carry into the other graph's
    carry buffer, so no replay copies the 2^24 complex128 state."""
    import quantumpropagators_torch as qt

    tlist = np.linspace(0.0, n_steps * DT, n_steps + 1)

    def run():
        return qt.propagate(psi0, H, tlist, method="cheby", fused=True,
                            kernel="dd", workspace=wrk)

    trace_steps(run, f"phase 8 trace dd L={L_MAIN}", n_steps, card, top,
                show_copies=True)


def banded20_operator(device):
    """The banded20 chain of ``bench.py:775-822`` as a port
    :class:`BSROperator` on the card, from a seeded generator: R = 8192
    coupled 128-level units with dense symmetric on-site blocks D_r and
    dense hopping blocks U_r between units r and r + 1 (block (r+1, r)
    is U_r^T), scale 1/sqrt(3·128), block offsets (-1, 0, 1).  In the
    blocked-ELL layout the first and last block rows hold two blocks
    and one all-zero padding block pointing at block-column 0."""
    from quantumpropagators_torch.ops.operators import BSROperator

    b, R = B_BANDED, N_BANDED // B_BANDED
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 40)
    scale = 1.0 / np.sqrt(3 * b)
    kw = dict(generator=g, device=device, dtype=torch.float64)
    D = torch.randn((R, b, b), **kw)
    D = 0.5 * (D + D.transpose(1, 2)) * scale
    U = torch.randn((R - 1, b, b), **kw) * scale
    blocks = torch.zeros((R, 3, b, b), dtype=torch.float64, device=device)
    cols = torch.zeros((R, 3), dtype=torch.int64, device=device)
    r = torch.arange(R, device=device)
    blocks[1:, 0], cols[1:, 0] = U.transpose(1, 2), r[1:] - 1
    blocks[1:, 1], cols[1:, 1] = D[1:], r[1:]
    blocks[1:-1, 2], cols[1:-1, 2] = U[1:], r[1:-1] + 1
    blocks[0, 0], blocks[0, 1], cols[0, 1] = D[0], U[0], 1
    return BSROperator(blocks=blocks, cols=cols, shape=(N_BANDED, N_BANDED),
                       block_size=b)


def banded_phase(device, card):
    """Phase 7: the banded20 chain at 2^20 through
    ``propagate(..., fused=True, kernel="dd")`` on the banded SpMV
    kernel.  Returns the kernel's entry of the kernels line (without
    name, route, source and replaces)."""
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.fused import cheby_propagate_fused
    from quantumpropagators_torch.ops import banded_spmv as bs
    from quantumpropagators_torch.ops.bsr_dd import banded_dd_from_bsr
    from quantumpropagators_torch.ops.cheby import ChebyWorkspace
    from quantumpropagators_torch.ops.operators import DiagonalOperator
    from quantumpropagators_torch.propagators.cheby import ChebyPropagator

    b, R, L = B_BANDED, N_BANDED // B_BANDED, N_BANDED.bit_length() - 1
    t0 = time.perf_counter()
    op = banded20_operator(device)
    psi0 = random_state(L, torch.complex128, device, SEED + 50)
    # the default specrange (Arnoldi), its start vector seeded; dt from
    # the envelope so that Δ·dt/2 = 3, about 19 orders per step
    # (bench.py:826-829)
    env = ChebyPropagator(psi0, op, [0.0, 1.0], coeffs_pad_to=1,
                          rng=np.random.default_rng(SEED + 60)).wrk
    dt = 6.0 / env.delta
    wrk = ChebyWorkspace.create(env.delta, env.e_min, dt)
    orders = len(wrk.coeffs)
    beta = env.delta / 2.0 + env.e_min
    torch.cuda.synchronize()
    log(f"phase 7 banded20 workspace 2^{L} (R={R}, b={b}): "
        f"E_min={env.e_min:.6f} delta={env.delta:.6f} beta={beta:.3e} "
        f"dt={dt:.6f} orders/step={orders} "
        f"(operator + specrange {time.perf_counter() - t0:.2f} s)")
    if not abs(beta) > 1e-9 * env.delta:
        raise AssertionError("the envelope must be generic (beta != 0)")

    # -- kernel vs plain, at the main path's b = 128 and at b = 8 ---------
    banded = banded_dd_from_bsr(op)
    if banded.offsets != (-1, 0, 1):
        raise AssertionError(f"banded20 offsets {banded.offsets}")
    planes, offsets = banded.planes, banded.offsets
    x = random_state(L, torch.complex128, device, SEED + 70)
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 80)
    planes8 = torch.randn((3, 8, N_BANDED // 8, 8), generator=g,
                          device=device, dtype=torch.float64) / np.sqrt(24)
    max_err = 0.0
    for bb, pl in ((b, planes), (8, planes8)):
        got = bs.banded_spmv(pl, offsets, x)
        want = bs.banded_spmv_plain(pl, offsets, x)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        log(f"phase 7 kernel-vs-plain {BANDED} b={bb} 2^{L}: max|d|={err:.3e} "
            f"rel={rel:.3e} (rel <= 1e-13) {'ok' if rel <= 1e-13 else 'FAIL'}")
        if not rel <= 1e-13:
            raise AssertionError(f"{BANDED} disagrees with its plain version")
        max_err = max(max_err, err)
    del planes8, got, want

    # -- the main path: 20 steps with observables -------------------------
    tlist = np.linspace(0.0, N_STEPS * dt, N_STEPS + 1)
    unit = DiagonalOperator((torch.arange(N_BANDED, device=device) // b)
                            .to(torch.float64) / R)
    obs = (unit, lambda psi: torch.linalg.vector_norm(psi))
    plain_calls = []
    plain = bs.banded_spmv_plain

    def counted_plain(*args, **kwargs):
        plain_calls.append(1)
        return plain(*args, **kwargs)

    bs.banded_spmv_plain = counted_plain
    bs.reset_launches()
    try:
        data = qt.propagate(psi0, op, tlist, method="cheby", fused=True,
                            kernel="dd", workspace=wrk, observables=obs,
                            storage=True)
        torch.cuda.synchronize()
    finally:
        bs.banded_spmv_plain = plain
    launches = bs.LAUNCHES[BANDED]
    if launches != N_STEPS * (orders - 1) or plain_calls:
        raise AssertionError(
            f"banded path: {launches} launches (expected "
            f"{N_STEPS * (orders - 1)}), {len(plain_calls)} plain calls")
    if data.shape != (2, N_STEPS + 1) or not np.all(np.isfinite(data)):
        raise AssertionError(f"bad observable storage {data.shape}")
    norm_err = float(np.abs(np.abs(data[1]) - 1.0).max())
    if not norm_err <= 1e-12:
        raise AssertionError(f"norm not kept: {norm_err}")
    pos = data[0]
    if np.abs(pos.imag).max() > 1e-12 or not np.all((pos.real >= 0)
                                                    & (pos.real < 1)):
        raise AssertionError("<unit>/R not a real number in [0, 1)")
    log(f"phase 7 dd banded20 {N_STEPS} steps: max|norm-1|={norm_err:.2e} "
        f"(<= 1e-12), <unit>/R(T)={pos[-1].real:.12f}, launches={launches} "
        f"= {N_STEPS} x ({orders} - 1), plain calls 0 ok")

    # timed run: the same path without observables
    t0 = time.perf_counter()
    psi_T = qt.propagate(psi0, op, tlist, method="cheby", fused=True,
                         kernel="dd", workspace=wrk)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    steps_s = N_STEPS / t_run
    nnz_stored = planes.numel()
    gnnz = steps_s * 2 * (orders - 1) * nnz_stored / 1e9

    # the plain generic path (kernel="xla", BSROperator.apply), 5 steps
    short = tlist[:6]
    p_dd, _ = cheby_propagate_fused(psi0, op, short, workspace=wrk,
                                    kernel="dd")
    p_xla, _ = cheby_propagate_fused(psi0, op, short, workspace=wrk,
                                     kernel="xla")
    torch.cuda.synchronize()
    err_xla = float((p_dd - p_xla).abs().max())
    if not err_xla <= 1e-10:
        raise AssertionError(f"banded dd vs xla after 5 steps: {err_xla}")
    log(f"phase 7 dd vs plain generic path (xla) after 5 steps: "
        f"max|d|={err_xla:.3e} (<= 1e-10) ok")
    back = qt.propagate(psi_T, op, tlist, method="cheby", fused=True,
                        kernel="dd", workspace=wrk, backward=True)
    torch.cuda.synchronize()
    err_rt = float((back - psi0).abs().max())
    if not err_rt <= 1e-12:
        raise AssertionError(f"banded backward round trip: {err_rt}")
    log(f"phase 7 dd backward round trip 2^{L}: max|d|={err_rt:.3e} "
        f"(<= 1e-12) ok")
    del data, p_xla, back

    # -- times: kernel, plain version, one-call library equivalent -------
    ms = time_ms(lambda: bs.banded_spmv(planes, offsets, x), 20)
    plain_ms = time_ms(lambda: bs.banded_spmv_plain(planes, offsets, x), 3)
    # torch.einsum over the planes and a window view of the zero-padded
    # state: windows[k, r] = x block row r + offsets[k] (offsets -1, 0, 1)
    xp = torch.zeros((R + 2, b, 2), dtype=torch.float64, device=device)
    xp[1:R + 1] = torch.view_as_real(x).reshape(R, b, 2)
    windows = xp.as_strided((3, R, b, 2), (2 * b, 2 * b, 2, 1))

    def library():
        return torch.einsum("kiro,krix->rox", planes, windows)

    lib_err = float((torch.view_as_complex(library().contiguous()).reshape(-1)
                     - bs.banded_spmv_plain(planes, offsets, x)).abs().max())
    library_ms = time_ms(library, 3)
    y_bytes = x.numel() * x.element_size()
    bound_ms, bound_by = bound(planes.numel() * planes.element_size()
                               + 2 * y_bytes, 4 * planes.numel(), "double")
    log(f"phase 7 time {BANDED} b={b} 2^{L}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (einsum, max|d| vs plain "
        f"{lib_err:.1e}) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}, {100 * bound_ms / ms:.1f} % of it reached) [{card}]")
    log(f"phase 7 main path dd banded20 2^{L}: {steps_s:.3f} steps/s, "
        f"{gnnz:.3f} Gnnz/s (2 x {orders - 1} matvecs/step x "
        f"{nnz_stored} stored nnz) [{card}]")
    del xp, windows
    entry = {"launches": launches, "max_abs_err": max_err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": library_ms}
    # what phase 9 reuses: the operator, its band planes, the envelope and
    # the Chebyshev results after 20 and after 5 steps
    ctx = dict(op=op, banded=banded, psi0=psi0, env=env, wrk=wrk,
               tlist=tlist, steps_s=steps_s, psi_T=psi_T, psi_5=p_dd)
    return entry, ctx


def krylov_phase(device, card, ctx):
    """Phase 9: the Krylov methods on phase 7's banded20 operator at 2^20,
    on the same band planes (``dd_operator_terms``) and envelope:
    fixed-Leja Newton through ``propagate(fused=True)`` over the 20 steps
    (every node one ``banded_spmv<double>`` launch), against phase 7's
    Chebyshev result, its norm, its backward round trip and three steps
    with the plain product on the card; then 5 steps each of ``newton``
    and ``expv`` at ``precision="dd"`` against 5 Chebyshev steps.
    Returns each path's banded launches and each method's (steps,
    seconds)."""
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.ops import banded_spmv as bs
    from quantumpropagators_torch.ops.newton_leja import newton_leja_plan
    from quantumpropagators_torch.propagate import propagate_propagator
    from quantumpropagators_torch.utils.timings import (disable_timings,
                                                        enable_timings)

    op, psi0, tlist = ctx["op"], ctx["psi0"], ctx["tlist"]
    env = ctx["env"]
    e_min, e_max = env.e_min, env.e_min + env.delta
    dt = float(tlist[1] - tlist[0])
    L = N_BANDED.bit_length() - 1
    leja = dict(method="newton_leja", fused=True, e_min=e_min, e_max=e_max,
                dd_operator_terms=(ctx["banded"],))
    nodes = len(newton_leja_plan(e_min, e_max, dt).points)
    obs = (lambda psi: torch.linalg.vector_norm(psi),)
    launches = {}

    # -- fixed-Leja Newton, 20 steps ---------------------------------------
    bs.reset_launches()
    norms = qt.propagate(psi0, op, tlist, observables=obs, storage=True,
                         **leja)
    torch.cuda.synchronize()
    n = launches["phase 9 newton_leja"] = bs.LAUNCHES[BANDED]
    if n != N_STEPS * (nodes - 1):
        raise AssertionError(f"Leja path: {n} banded launches, expected "
                             f"{N_STEPS} x ({nodes} - 1)")
    norm_err = float(np.abs(np.abs(norms) - 1.0).max())
    if norms.shape != (N_STEPS + 1,) or not norm_err <= 1e-12:
        raise AssertionError(f"Leja norm not kept: {norm_err}")
    t0 = time.perf_counter()
    psi_L = qt.propagate(psi0, op, tlist, **leja)
    torch.cuda.synchronize()
    t_leja = time.perf_counter() - t0
    err = float((psi_L - ctx["psi_T"]).abs().max())
    if not err <= 1e-10:
        raise AssertionError(f"Leja vs Chebyshev after 20 steps: {err}")
    log(f"phase 9 newton_leja banded20 2^{L} {N_STEPS} steps: {nodes} Leja "
        f"nodes/step, max|d| vs phase 7 cheby dd={err:.3e} (<= 1e-10), "
        f"max|norm-1|={norm_err:.2e} (<= 1e-12), launches={n} = "
        f"{N_STEPS} x ({nodes} - 1) ok")
    back = qt.propagate(psi_L, op, tlist, backward=True, **leja)
    torch.cuda.synchronize()
    err_rt = float((back - psi0).abs().max())
    if not err_rt <= 1e-11:
        raise AssertionError(f"Leja backward round trip: {err_rt}")
    log(f"phase 9 newton_leja backward round trip 2^{L}: "
        f"max|d|={err_rt:.3e} (<= 1e-11) ok")
    # three steps with the plain product on the card
    short = tlist[:4]
    psi_k = qt.propagate(psi0, op, short, **leja)
    kernel = bs.banded_spmv
    bs.banded_spmv = bs.banded_spmv_plain
    try:
        psi_p = qt.propagate(psi0, op, short, **leja)
        torch.cuda.synchronize()
    finally:
        bs.banded_spmv = kernel
    err_p = float((psi_k - psi_p).abs().max())
    if not err_p <= 1e-12:
        raise AssertionError(f"Leja kernel vs plain product: {err_p}")
    log(f"phase 9 newton_leja 3 steps, kernel vs plain product on the "
        f"card: max|d|={err_p:.3e} (<= 1e-12) ok")
    del back, psi_k, psi_p, norms
    rates = {"newton_leja": (N_STEPS, t_leja)}

    # -- newton and expv at precision="dd", 5 steps ---------------------------
    short = tlist[:6]
    enable_timings()
    try:
        for method, kw in (("newton", {}), ("expv", {})):
            bs.reset_launches()
            prop = qt.init_prop(psi0, op, short, method=method,
                                precision="dd",
                                dd_operator_terms=(ctx["banded"],), **kw)
            t0 = time.perf_counter()
            propagate_propagator(prop)
            torch.cuda.synchronize()
            rates[method] = (5, time.perf_counter() - t0)
            n = launches[f"phase 9 {method} dd"] = bs.LAUNCHES[BANDED]
            matvecs = prop.timing_data.counters.get("matvec", 0)
            if n != matvecs or n == 0:
                raise AssertionError(f"{method}: {n} banded launches, "
                                     f"{matvecs} matvecs")
            err = float((prop.state_dd - ctx["psi_5"]).abs().max())
            if not err <= 1e-10:
                raise AssertionError(f"{method} dd vs cheby: {err}")
            log(f"phase 9 {method} dd banded20 2^{L} 5 steps: max|d| vs "
                f"5 cheby dd steps={err:.3e} (<= 1e-10), launches={n} = "
                f"the restarts' matvecs ok")
            del prop
    finally:
        disable_timings()
    t_cheby = N_STEPS / ctx["steps_s"]
    for method, (steps, t) in [("cheby dd (phase 7)", (N_STEPS, t_cheby))] \
            + list(rates.items()):
        log(f"phase 9 time {method} banded20 2^{L}: {steps / t:.3f} steps/s, "
            f"{1e3 * t / steps:.3f} ms/step [{card}]")
    return launches, rates


def sparse_hermitian(N=1024):
    """The sparse Hermitian of ``bench.py:330-342`` (spectral radius 10)
    as a scipy matrix, and its seeded state."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import eigsh

    rng = np.random.default_rng(42)
    A = sp.random(N, N, density=0.01, random_state=rng,
                  data_rvs=rng.standard_normal)
    H = (0.5 * (A + A.T)).tocsr()
    lam = [abs(eigsh(H, k=1, which=w, return_eigenvectors=False)[0])
           for w in ("LA", "SA")]
    H = (H * (10.0 / max(lam))).astype(np.float64)
    psi0 = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    return H, psi0 / np.linalg.norm(psi0)


def small_configs(device, card):
    """Phase 9, small configurations against host ``expm`` oracles: every
    registered method on the N = 1024 sparse Hermitian of
    ``bench.py:330-342`` (spectral radius 10, dt = 0.5, 20 steps), and
    fixed-Leja Newton on the N = 10 driven transmon ladder of
    ``bench.py:142-290`` (100 steps).  Returns the sparse Hermitian's
    operator and state on the card."""
    import scipy.linalg
    import scipy.sparse as sp

    import quantumpropagators_torch as qt
    from quantumpropagators_torch.models.controls import \
        discretize_on_midpoints

    H, psi0 = sparse_hermitian()
    N = H.shape[0]
    tlist = np.linspace(0.0, 10.0, 21)
    oracle = scipy.linalg.expm(-10j * H.toarray()) @ psi0
    op = qt.csr_from_scipy(H, device=device)
    psi = torch.as_tensor(psi0, device=device)
    # the JAX tests' tolerances: 1e-10, and 1e-7 for the DP5 integrator
    for method, kw, tol in (("cheby", {}, 1e-10), ("newton", {}, 1e-10),
                            ("expv", {}, 1e-10), ("expprop", {}, 1e-10),
                            ("ode", {}, 1e-7)):
        t0 = time.perf_counter()
        out = qt.propagate(psi, op, tlist, method=method, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        if out.device != device:
            raise AssertionError(f"{method} left the device")
        err = float(np.linalg.norm(out.cpu().numpy() - oracle))
        if not err <= tol:
            raise AssertionError(f"sparse N={N} {method} vs expm: {err}")
        log(f"phase 9 sparse Hermitian N={N} {method} 20 steps: |d| vs "
            f"expm={err:.3e} (<= {tol:g}), {20 / t:.3f} steps/s, "
            f"{1e3 * t / 20:.3f} ms/step [{card}]")

    N = 10
    a = sp.diags(np.sqrt(np.arange(1, N, dtype=float)), 1).tocsr()
    ad = a.T.tocsr()
    n_op = (ad @ a).tocsr()
    H0 = (6.0 * n_op - 0.1 * (n_op @ (n_op - sp.identity(N)))).tocsr()
    Hd = (a + ad).tocsr()
    eps = lambda t: 0.3 * float(np.cos(5.8 * t))
    gen = qt.hamiltonian(qt.dia_from_scipy(H0, device=device),
                         (qt.dia_from_scipy(Hd, device=device), eps))
    tlist = np.linspace(0.0, 10.0, 101)
    ev = np.concatenate([np.linalg.eigvalsh(H0.toarray() + s * Hd.toarray())
                         for s in (-0.3, 0.3)])
    buf = 0.02 * (ev.max() - ev.min())
    psi0 = np.eye(N)[0].astype(complex)
    vals = discretize_on_midpoints(eps, tlist)
    oracle = psi0
    for k in range(len(tlist) - 1):
        oracle = scipy.linalg.expm(-0.1j * (H0 + vals[k] * Hd).toarray()) \
            @ oracle
    t0 = time.perf_counter()
    out = qt.propagate(torch.as_tensor(psi0, device=device), gen, tlist,
                       method="newton_leja", fused=True,
                       e_min=float(ev.min() - buf), e_max=float(ev.max() + buf),
                       dd_operator_terms=[H0, Hd])
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    err = float(np.abs(out.cpu().numpy() - oracle).max())
    if out.device != device or not err <= 1e-11:
        raise AssertionError(f"transmon newton_leja vs expm: {err}")
    log(f"phase 9 transmon N={N} newton_leja 100 steps: max|d| vs expm="
        f"{err:.3e} (<= 1e-11), {100 / t:.3f} steps/s [{card}]")
    return op, psi


@contextlib.contextmanager
def bodies_only():
    """Every graphed site (``utils/scan.Graphed``) runs its body while
    entered: the eager way of phase 18."""
    from quantumpropagators_torch.utils import scan

    route = scan.Graphed._route
    scan.Graphed._route = lambda self, arguments: (None, False)
    try:
        yield
    finally:
        scan.Graphed._route = route


def _timed_run(prop, psi, reps=1):
    """``reps`` stepwise propagations of ``prop`` from ``psi``
    (``reinit_prop`` each), the device synchronized: ``(final state,
    seconds of the last)``."""
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.propagate import propagate_propagator

    for _ in range(reps):
        qt.reinit_prop(prop, psi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = propagate_propagator(prop)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
    return out, t


def _reserved_gib():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2 ** 30


def step_graph_banded(device, card, ctx):
    """Phase 18a: 20 stepwise dd Chebyshev intervals on banded20 with
    phase 7's band planes as ``dd_operator_terms``, graphed and eager.
    Returns the graphed run's banded launches."""
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.ops import banded_spmv as bs

    op, psi0, tlist = ctx["op"], ctx["psi0"], ctx["tlist"]
    L = N_BANDED.bit_length() - 1
    kw = dict(method="cheby", precision="dd",
              dd_operator_terms=(ctx["banded"],), coeffs_pad_to=1)
    runs = {}
    for way in ("graph", "eager"):
        with bodies_only() if way == "eager" else contextlib.nullcontext():
            bs.reset_launches()
            prop = qt.init_prop(psi0, op, tlist,
                                rng=np.random.default_rng(SEED + 60), **kw)
            torch.cuda.synchronize()
            n_env = bs.LAUNCHES[BANDED]
            orders = len(prop.wrk.coeffs)
            bs.reset_launches()
            psi, _ = _timed_run(prop, psi0)
            n = bs.LAUNCHES[BANDED]
            _, t = _timed_run(prop, psi0, reps=2)
            runs[way] = (psi, t, n, n_env, orders, prop._step.captures)
            del prop
    (pg, tg, ng, eg, orders, cg), (pe, te, ne, ee, oe, ce) = \
        runs["graph"], runs["eager"]
    same = torch.equal(pg, pe)
    err = float((pg - ctx["psi_T"]).abs().max())
    want = N_STEPS * (orders - 1)
    if not (same and err <= 1e-10 and ng == ne == want and oe == orders
            and cg == 1 and ce == 0):
        raise AssertionError(
            f"phase 18a: graph vs eager equal {same} (max|d| "
            f"{float((pg - pe).abs().max())}), vs phase 7 {err} (<= 1e-10), "
            f"banded launches graph {ng} eager {ne} (expected {want}), "
            f"orders {orders} / {oe}, captures {cg} / {ce}")
    log(f"phase 18a stepwise cheby dd banded20 2^{L} {N_STEPS} steps: graph "
        f"vs eager bit for bit, max|d| vs phase 7 fused dd={err:.3e} (<= "
        f"1e-10), {BANDED} launches={ng} = {N_STEPS} x ({orders} - 1) both "
        f"ways (the envelope's own: {eg}), 1 capture over 3 propagations; "
        f"graph {N_STEPS / tg:.3f} steps/s, eager {N_STEPS / te:.3f} "
        f"steps/s [{card}]")
    return ng


def _small_driven(device, sparse):
    """Phase 18b's systems: the N = 10 transmon ladder of phase 9 (its
    terms on the card, and as numpy matrices, which a propagator copies
    onto the card once) and phase 9's N = 1024 sparse Hermitian with a
    diagonal drive, each ``(generator, state, tlist)`` over 100
    intervals."""
    import scipy.sparse as sp

    import quantumpropagators_torch as qt

    N = 10
    a = sp.diags(np.sqrt(np.arange(1, N, dtype=float)), 1).tocsr()
    ad = a.T.tocsr()
    n_op = (ad @ a).tocsr()
    H0 = (6.0 * n_op - 0.1 * (n_op @ (n_op - sp.identity(N)))).tocsr()
    Hd = (a + ad).tocsr()
    transmon = qt.hamiltonian(
        qt.dia_from_scipy(H0, device=device),
        (qt.dia_from_scipy(Hd, device=device),
         lambda t: 0.3 * float(np.cos(5.8 * t))))
    psi_t = torch.as_tensor(np.eye(N)[0].astype(complex), device=device)
    host = qt.hamiltonian(H0.toarray(), (Hd.toarray(),
                                         transmon.amplitudes[0]))
    op, psi_s = sparse
    rng = np.random.default_rng(SEED + 90)
    drive = qt.csr_from_scipy(sp.diags(rng.uniform(-1.0, 1.0, 1024))
                              .tocsr(), device=device)
    hermitian = qt.hamiltonian(op, (drive,
                                    lambda t: 0.5 * float(np.cos(2.0 * t))))
    return {"transmon N=10": (transmon, psi_t, np.linspace(0.0, 10.0, 101)),
            "transmon N=10 numpy terms": (host, psi_t,
                                          np.linspace(0.0, 10.0, 101)),
            "sparse Hermitian N=1024": (hermitian, psi_s,
                                        np.linspace(0.0, 10.0, 101))}


def _moved_envelope(prop):
    """New controls past the certified range whose envelope keeps the
    coefficient count: widens the range until one does."""
    import quantumpropagators_torch as qt

    (control,) = prop.parameters.keys()
    vals = prop.parameters[control]
    lo, hi = prop.control_ranges[control]
    n, delta = len(prop.wrk.coeffs), prop.wrk.delta
    for f in (0.002, 0.005, 0.01, 0.02, 0.05):
        vals[:] = np.linspace(lo - f * (hi - lo), hi + f * (hi - lo),
                              len(vals))
        qt.reinit_prop(prop, prop.state)
        if len(prop.wrk.coeffs) == n and prop.wrk.delta != delta:
            return f
    raise AssertionError("no moved envelope kept the coefficient count")


def step_graph_small(device, card, sparse):
    """Phase 18b: 100 stepwise Chebyshev intervals with
    ``check_normalization=True`` and amplitudes changing every interval,
    graphed and eager, on two small systems; one capture a propagator
    through new controls and a moved envelope of the same length."""
    import quantumpropagators_torch as qt

    for label, (gen, psi0, tlist) in _small_driven(device, sparse).items():
        n = len(tlist) - 1
        finals, rates = {}, {}
        for way in ("graph", "eager"):
            with bodies_only() if way == "eager" \
                    else contextlib.nullcontext():
                prop = qt.init_prop(psi0, gen, tlist, method="cheby",
                                    check_normalization=True)
                _timed_run(prop, psi0)
                first = prop._step.captures
                psi, t = _timed_run(prop, psi0, reps=2)
                # new controls inside the certified range
                (control,) = prop.parameters.keys()
                vals = prop.parameters[control]
                vals[:] = 0.5 * vals[::-1].copy()
                _timed_run(prop, psi0)
                new = prop._step.captures - first
                f = _moved_envelope(prop)
                moved, _ = _timed_run(prop, psi0)
                again = prop._step.captures - first - new
                finals[way], rates[way] = (psi, moved), n / t
                counts = (first, new, again)
                del prop
            if way == "graph" and counts != (1, 0, 0):
                raise AssertionError(f"phase 18b {label}: captures {counts} "
                                     f"(expected 1, 0, 0)")
        err = max(float((g - e).abs().max())
                  for g, e in zip(finals["graph"], finals["eager"]))
        norm_err = abs(float(torch.linalg.vector_norm(finals["graph"][0]))
                       - 1.0)
        if not (err <= 1e-12 and norm_err <= 1e-12):
            raise AssertionError(f"phase 18b {label}: graph vs eager {err}, "
                                 f"norm {norm_err}")
        log(f"phase 18b stepwise cheby {label} {n} steps, "
            f"check_normalization: graph vs eager max|d|={err:.3e} (<= "
            f"1e-12, also after a moved envelope, range +{f:g} a side), "
            f"captures 1, then 0 for new controls, 0 for the moved "
            f"envelope; graph {rates['graph']:.3f} "
            f"steps/s, eager {rates['eager']:.3f} steps/s [{card}]")


def _krylov_captures(prop, method):
    """A Newton or Krylov propagator's captures: its Arnoldi site's, its
    tail's (Newton's restart tail, ``expv``'s combine) and the Krylov
    dimensions the tail has a site for."""
    from quantumpropagators_torch.ops import arnoldi, dd_linalg, expv, newton

    sites = prop._arnoldi_sites
    tail = newton._newton_tail if method == "newton" else expv._expv_combine
    return (sites.captures_of(arnoldi._arnoldi_impl,
                              dd_linalg._arnoldi_dd_impl),
            sites.captures_of(tail), tuple(sites.parts(tail)))


def _counted_run(prop, psi):
    """One stepwise propagation of ``prop`` from ``psi``: ``(state,
    Arnoldi calls, host reads)``, the reads being the synchronizing
    operations ``torch.cuda.set_sync_debug_mode`` reports while it
    runs."""
    import warnings

    import quantumpropagators_torch as qt
    from quantumpropagators_torch.ops import arnoldi as arn
    from quantumpropagators_torch.ops import dd_linalg
    from quantumpropagators_torch.propagate import propagate_propagator

    qt.reinit_prop(prop, psi)
    torch.cuda.synchronize()
    calls, read = [], arn._read
    # each Arnoldi call reads its Hessenberg matrix once, by _read
    arn._read = dd_linalg._read = \
        lambda *args: calls.append(1) or read(*args)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = propagate_propagator(prop)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        arn._read = dd_linalg._read = read
    torch.cuda.synchronize()
    reads = sum("synchroniz" in str(w.message) for w in caught)
    return out, len(calls), reads


def krylov_ways(label, method, make, psi0, n, card, banded=False,
                ordered=False):
    """Phase 18b/c: the Newton or Krylov propagator ``make()`` over ``n``
    steps graphed and with every site's body run eagerly
    (:func:`bodies_only`): the states of a first and a later propagation
    bit for bit, captures after the first (the Arnoldi site's 1, the
    tail's 1 for each Krylov dimension it met) and none after, Arnoldi
    calls (restarts) and host reads of the later one, banded launches
    equal to matvecs (``banded``), steps/s of a third.  ``ordered``:
    both ways under :func:`deterministic` (a CSR product's sums in one
    order).  Returns each way's numbers."""
    from quantumpropagators_torch.ops import banded_spmv as bs
    from quantumpropagators_torch.utils.timings import (disable_timings,
                                                        enable_timings)

    ways = {}
    enable_timings()
    try:
        for way in ("graph", "eager"):
            with bodies_only() if way == "eager" \
                    else contextlib.nullcontext(), \
                    deterministic(warn_only=True) if ordered \
                    else contextlib.nullcontext():
                prop = make()
                bs.reset_launches()
                prop.timing_data.reset()
                first, _ = _timed_run(prop, psi0)
                launches = bs.LAUNCHES[BANDED]
                matvecs = prop.timing_data.counters.get("matvec", 0)
                captures = _krylov_captures(prop, method)
                state, calls, reads = _counted_run(prop, psi0)
                _, t = _timed_run(prop, psi0, reps=2)
                ways[way] = dict(first=first, state=state, launches=launches,
                                 matvecs=matvecs, captures=captures,
                                 after=_krylov_captures(prop, method),
                                 calls=calls, reads=reads, rate=n / t)
                del prop
    finally:
        disable_timings()
    g, e = ways["graph"], ways["eager"]
    same = torch.equal(g["first"], e["first"]) and torch.equal(g["state"],
                                                               e["state"])
    arnoldi, tail, parts = g["captures"]
    ok = (same and arnoldi == 1 and tail == len(parts) >= 1
          and g["after"] == g["captures"] and e["after"][:2] == (0, 0)
          and g["calls"] == e["calls"]
          and g["reads"] <= n + 2 * g["calls"])
    if banded:
        ok = ok and g["launches"] == g["matvecs"] == e["launches"] \
            == e["matvecs"] > 0
    if not ok:
        raise AssertionError(
            f"phase {label}: graph vs eager equal {same} (max|d| "
            f"{float((g['state'] - e['state']).abs().max())}), captures "
            f"{g['captures']} then {g['after']} (eager {e['after']}), "
            f"Arnoldi calls {g['calls']} / {e['calls']}, host reads "
            f"{g['reads']} (at most {n} + 2 x {g['calls']}), launches "
            f"{g['launches']} / {e['launches']}, matvecs {g['matvecs']} / "
            f"{e['matvecs']}")
    restarts = g["calls"] / n
    tail_what = "restart tail" if method == "newton" else "combine"
    log(f"phase {label} {n} steps: graph vs eager bit for bit (two "
        f"propagations), captures Arnoldi {arnoldi}, {tail_what} {tail} "
        f"(Krylov dimensions {[m for _, m in parts]}), 0 after the first "
        f"propagation; {restarts:g} Arnoldi calls a step, host reads "
        f"graph {g['reads']} = {n} start norms + "
        f"{(g['reads'] - n) / g['calls']:.3f} a call (eager "
        f"{e['reads']})"
        + (f", {BANDED} launches={g['launches']} = matvecs both ways"
           if banded else "")
        + f"; graph {g['rate']:.3f} steps/s, eager {e['rate']:.3f} steps/s"
        f" [{card}]")
    return ways


def step_graph_krylov_small(device, card, sparse):
    """Phase 18b (Krylov): ``newton`` and ``expv`` in complex128 on the
    N = 10 transmon and the driven N = 1024 sparse Hermitian of 18b, 20
    steps each, graphed and eager."""
    import quantumpropagators_torch as qt

    systems = _small_driven(device, sparse)
    for label in ("transmon N=10", "sparse Hermitian N=1024"):
        gen, psi0, tlist = systems[label]
        for method in ("newton", "expv"):
            krylov_ways(f"18b {method} {label}", method,
                        lambda: qt.init_prop(psi0, gen, tlist[:21],
                                             method=method), psi0, 20, card,
                        ordered=label.startswith("sparse"))


def step_graph_dd_applies(device, card):
    """Phase 18d: the standalone dd Chebyshev applies as graphed sites.
    ``cheby_apply_dd`` on the diagonal and flip table of the L = 20
    chain of phase 19b and ``cheby_apply_dd_bsr`` on the optomech chain
    of ``bench_torch.py:602-622`` at R = 16 (64-level units, block 64):
    10 calls with new coefficients inside one scope against 10 eager
    calls, bit for bit, one capture, the first call against a host
    oracle (``bench_torch.flip_oracle_step``, dense ``expm``) at 1e-10;
    the flip apply also against ``flip_cheby_step`` with the
    coefficients as kernel arguments, bit for bit.  Returns the flip
    launches of the graphed calls."""
    import scipy.linalg
    import scipy.sparse as sp

    from bench_torch import flip_oracle_step
    from quantumpropagators_torch.ops import arnoldi as arn
    from quantumpropagators_torch.ops import cheby_flip as cf
    from quantumpropagators_torch.ops import df64, df64_sparse
    from quantumpropagators_torch.ops.cheby import cheby_coeffs
    from quantumpropagators_torch.ops.fused_cheby import flip_cheby_step

    H_diag, _ = tfim_generator(ODE_L, device)
    diag = H_diag.diag.real.to(torch.float64).contiguous()
    bound = float(diag.abs().max()) + ODE_L * G_FIELD
    delta, e_min = 2.0 * bound, -bound
    psi = random_state(ODE_L, torch.complex128, device, SEED + 260)
    flip = [G_FIELD] * ODE_L

    rng = np.random.default_rng(1)
    R, b = 16, 64
    blocks, rows, cols = [], [], []
    for r in range(R):
        for c in (r - 1, r, r + 1):
            if 0 <= c < R:
                rows.append(r)
                cols.append(c)
                blocks.append(rng.standard_normal((b, b)))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=R))])
    H2 = sp.bsr_matrix((np.stack(blocks), np.asarray(cols), indptr),
                       shape=(R * b, R * b)).tocsr()
    H2 = (0.5 * (H2 + H2.T)).tocsr()
    op = df64_sparse.bsr_dd_from_scipy(H2, block_size=b, device=device)
    bound2 = float(np.abs(H2).sum(axis=1).max())
    psi2 = random_state(10, torch.complex128, device, SEED + 261)

    cases = {
        f"cheby_apply_dd L={ODE_L}": (
            df64._cheby_dd_impl, cheby_coeffs(delta, DT),
            lambda c: df64.cheby_apply_dd(psi, diag, flip, c, delta, e_min,
                                          DT, L=ODE_L),
            lambda c: flip_oracle_step(
                psi.cpu().numpy(), diag.cpu().numpy(), G_FIELD, ODE_L, c,
                delta, e_min, DT)),
        f"cheby_apply_dd_bsr optomech chain R={R} (dim {R * b})": (
            df64_sparse._cheby_dd_bsr_impl, cheby_coeffs(2 * bound2, 0.02),
            lambda c: df64_sparse.cheby_apply_dd_bsr(op, psi2, c, 2 * bound2,
                                                     -bound2, 0.02),
            lambda c: scipy.linalg.expm(-0.02j * H2.toarray())
            @ psi2.cpu().numpy()),
    }
    launches = {}
    for label, (body, coeffs, call, oracle) in cases.items():
        # new coefficients at every call, their count kept
        tables = [coeffs * (1.0 + 1e-3 * k) for k in range(10)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = [call(c) for c in tables]  # outside every scope: the body
        torch.cuda.synchronize()
        te = time.perf_counter() - t0
        cf.reset_launches()
        with arn.arnoldi_sites(arn.ArnoldiSites()) as sites:
            graph = [call(tables[0])]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph += [call(c) for c in tables[1:]]
            torch.cuda.synchronize()
            tg = time.perf_counter() - t0
            captures = sites.captures_of(body)
        if body is df64._cheby_dd_impl:
            launches[f"phase 18d {label} graph"] = dict(cf.LAUNCHES)
        same = all(torch.equal(g, e) for g, e in zip(graph, eager))
        err = float(np.abs(graph[0].cpu().numpy() - oracle(tables[0])).max())
        scalar = None if body is not df64._cheby_dd_impl else (
            torch.equal(graph[0], flip_cheby_step(
                psi, (diag - (delta / 2 + e_min)).contiguous(),
                torch.full((ODE_L,), G_FIELD, dtype=torch.float64,
                           device=device), tables[0], delta, e_min, DT)))
        if not (same and captures == 1 and err <= 1e-10
                and scalar in (None, True)):
            raise AssertionError(
                f"phase 18d {label}: graph vs eager equal {same}, captures "
                f"{captures}, vs the host oracle {err} (<= 1e-10), vs "
                f"coefficients as kernel arguments {scalar}")
        log(f"phase 18d {label}, {len(coeffs)} coefficients: 10 calls with "
            f"new coefficients graph vs eager bit for bit, 1 capture, first "
            f"call vs the host oracle {err:.3e} (<= 1e-10)"
            + (", equal to the coefficients as kernel arguments"
               if scalar else "")
            + f"; 9 later calls graph {1e3 * tg / 9:.4f} ms a call, eager "
            f"{1e3 * te / 10:.4f} ms a call [{card}]")
    return launches


def torch_controls_on_card(device, card):
    """Phase 18e: a control written in ``torch`` math (``torch.cos``) on
    the N = 10 transmon through ``cheby``, ``newton``, ``expprop`` and
    ``ode`` (``pwc=True``) with the default ``check``, each against the
    same generator with the ``numpy`` control at 1e-12."""
    import scipy.sparse as sp

    import quantumpropagators_torch as qt

    N = 10
    a = sp.diags(np.sqrt(np.arange(1, N, dtype=float)), 1).tocsr()
    n_op = (a.T @ a).tocsr()
    H0 = (6.0 * n_op - 0.1 * (n_op @ (n_op - sp.identity(N)))).tocsr()
    H0, Hd = (qt.dia_from_scipy(M, device=device) for M in (H0, a + a.T))
    psi0 = torch.as_tensor(np.eye(N)[0].astype(complex), device=device)
    tlist = np.linspace(0.0, 2.0, 21)
    errs = {}
    for method, kw in (("cheby", {}), ("newton", {}), ("expprop", {}),
                       ("ode", {"pwc": True})):
        out = [qt.propagate(psi0, qt.hamiltonian(H0, (Hd, control)), tlist,
                            method=method, **kw)
               for control in (lambda t: 0.3 * torch.cos(5.8 * t),
                               lambda t: 0.3 * np.cos(5.8 * t))]
        errs[method] = float((out[0] - out[1]).abs().max())
    if not all(e <= 1e-12 for e in errs.values()):
        raise AssertionError(f"phase 18e torch vs numpy controls: {errs}")
    log(f"phase 18e torch.cos control with the default check, transmon "
        f"N={N} 20 steps, max|d| vs the numpy control: "
        + ", ".join(f"{m} {e:.3e}" for m, e in errs.items())
        + f" (<= 1e-12) [{card}]")


def step_graph_arnoldi(device, card, ctx):
    """Phase 18c: the Arnoldi site on banded20: ``specrange`` graphed and
    eager (``Hess`` bit for bit), 5 ``newton`` and ``expv`` dd steps both
    ways, and the reserved memory around an envelope.  Returns the
    graphed runs' banded launches."""
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.ops import arnoldi as arn
    from quantumpropagators_torch.ops import banded_spmv as bs
    from quantumpropagators_torch.ops.specrange import random_state

    op, psi0, tlist = ctx["op"], ctx["psi0"], ctx["tlist"]
    L = N_BANDED.bit_length() - 1
    start = torch.as_tensor(random_state(op, rng=np.random.default_rng(
        SEED + 95)), device=device)
    m = 60

    def hess():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        H, _, m_eff = arn._arnoldi(op, start, m, 1.0, extended=False,
                                   basis=False)
        return H, m_eff, time.perf_counter() - t0

    with arn.arnoldi_sites(arn.ArnoldiSites()) as sites:
        _, _, t_first = hess()  # eager
        _, _, t_capture = hess()  # captured, then replayed
        Hg, mg, tg = hess()
        captures = sites.captures
    with bodies_only():
        He, me, te = hess()
    if not (np.array_equal(Hg, He) and mg == me and captures == 1):
        raise AssertionError(f"phase 18c specrange: Hess equal "
                             f"{np.array_equal(Hg, He)}, m_eff {mg} / {me}, "
                             f"captures {captures}")
    log(f"phase 18c Arnoldi m={m} banded20 2^{L} (specrange's call): Hess "
        f"bit for bit graph vs eager, m_eff={mg}, 1 capture; graph "
        f"{tg:.4f} s, eager {te:.4f} s, first call (eager) "
        f"{t_first:.4f} s, second (capture and replay) {t_capture:.4f} s "
        f"[{card}]")

    launches = {}
    for method in ("newton", "expv"):
        ways = krylov_ways(
            f"18c {method} dd banded20 2^{L}", method, lambda: qt.init_prop(
                psi0, op, tlist[:6], method=method, precision="dd",
                dd_operator_terms=(ctx["banded"],)), psi0, 5, card,
            banded=True)
        err5 = float((ways["graph"]["state"] - ctx["psi_5"]).abs().max())
        if not err5 <= 1e-10:
            raise AssertionError(f"phase 18c {method} dd vs 5 cheby steps "
                                 f"{err5}")
        launches[f"phase 18c {method} dd graph"] = ways["graph"]["launches"]
        log(f"phase 18c {method} dd banded20: vs phase 7's 5 steps "
            f"{err5:.3e} (<= 1e-10) [{card}]")

    before = _reserved_gib()
    prop = qt.init_prop(psi0, op, tlist, method="cheby",
                        rng=np.random.default_rng(SEED + 60))
    torch.cuda.synchronize()
    after_env = torch.cuda.memory_reserved() / 2 ** 30
    _timed_run(prop, psi0)
    after_run = torch.cuda.memory_reserved() / 2 ** 30
    del prop
    dropped = _reserved_gib()
    if not abs(dropped - before) <= 0.5:
        raise AssertionError(f"phase 18c: reserved {before:.3f} GiB before, "
                             f"{dropped:.3f} after the propagator is dropped")
    log(f"phase 18c reserved GiB around a banded20 cheby propagator (m=60 "
        f"envelope, 20 graphed steps): {before:.3f} before, {after_env:.3f} "
        f"after the envelope, {after_run:.3f} after the steps, {dropped:.3f} "
        f"after it is dropped (within 0.5 of before) [{card}]")
    return launches


def step_graph_phase(device, card, ctx, sparse):
    """Phase 18: the stepwise path's graphed sites (a-e).  Returns the
    banded launches of its graphed paths and the flip launches of 18d's
    graphed calls."""
    t0 = time.perf_counter()
    launches = {"phase 18a stepwise cheby dd graph":
                step_graph_banded(device, card, ctx)}
    step_graph_small(device, card, sparse)
    step_graph_krylov_small(device, card, sparse)
    launches.update(step_graph_arnoldi(device, card, ctx))
    flips = step_graph_dd_applies(device, card)
    torch_controls_on_card(device, card)
    log(f"phase 18 {time.perf_counter() - t0:.1f} s")
    return launches, flips


# -- phase 19: the ODE loop and expprop's step as graphed sites -------------

ODE_L = 20             # phase 19b's chain: 2^20 complex128 amplitudes
ODE_INTERVALS = 2      # ... over 2 intervals of DT
TRANSMON_ODE_STEPS = 10  # phase 19a's transmon: the first 10 intervals
RICHARDSON = (32, 64)  # 19b's continuous reference: substeps an interval


def _torch_flattop(T, t_rise, a=0.16):
    """``qt.flattop(t, T=T, t_rise=t_rise)`` (half Blackman windows, the
    chain's drive) in ``torch`` math, which the continuous ODE variant
    calls on a time on the card."""
    import math

    def drive(t):
        ramps = []
        for x in (t / (2.0 * t_rise), (t - T + 2.0 * t_rise) / (2.0 * t_rise)):
            ramps.append(0.5 * (1.0 - a - torch.cos(2.0 * math.pi * x)
                                + a * torch.cos(4.0 * math.pi * x)))
        on, off = ramps
        inner = torch.where(t < t_rise, on, torch.where(
            t > T - t_rise, off, torch.ones_like(t)))
        return torch.where((t >= 0.0) & (t <= T), inner, torch.zeros_like(t))

    return drive


def _loop_state(prop):
    """The loop state ``(t, y, h, k, done, n, err_prev)`` of ``prop``'s
    graphed loop site: its static buffers, as the last replay left them."""
    (state,) = [loop[1] for _, _, loop in prop._step._call.graph.parts
                if loop is not None]
    return state


def _stepwise(prop, psi, attempts=False):
    """One stepwise propagation of ``prop`` from ``psi``, timed:
    ``(final state, seconds, flag reads an interval, attempts an
    interval)``.  With ``attempts``, each interval's count is copied on
    the card from the loop site's state and read after the run."""
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.utils import scan

    qt.reinit_prop(prop, psi)
    torch.cuda.synchronize()
    reads, counts = [], []
    t0 = time.perf_counter()
    while True:
        before = sum(scan.FLAG_READS.values())
        out = prop.prop_step()
        if out is None:
            break
        final = out
        reads.append(sum(scan.FLAG_READS.values()) - before)
        if attempts:
            counts.append(_loop_state(prop)[5].clone())
    torch.cuda.synchronize()
    return final, time.perf_counter() - t0, reads, [int(c) for c in counts]


@contextlib.contextmanager
def deterministic(warn_only=False):
    """PyTorch's deterministic algorithms while entered: the port's CSR
    product sums a row by ``index_add``, whose atomics add in another
    order each run on the card, so that two eager runs differ in their
    last bits; deterministic, it sums in one order, graphed or not.
    ``warn_only``: the operations with no deterministic form (cuBLAS
    products without a workspace setting, which sum in one order on one
    stream) run, their warnings ignored."""
    import warnings

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*determinis")
            yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def hold_ways(label, make, psi, card, check, ordered=False):
    """One phase-19 path both ways: graphed (a first run, which captures;
    a timed run; a run on a new time grid of the same length) and with
    every site's body run eagerly (a timed run).  Holds the graph to the
    body bit for bit, the captures to 1, 0, 0, the flag reads of an ODE
    interval to at most ``⌈attempts / K⌉ + 2`` (none for expprop), and
    the result by ``check(result) -> (ok, text)``; logs one line.
    ``ordered``: both ways under :func:`deterministic`.  Returns the
    graphed result."""
    from quantumpropagators_torch.utils import scan

    K = scan.WHILE_CHUNK
    runs, peaks = {}, {}
    for way in ("graph", "eager"):
        base = _reserved_gib()
        torch.cuda.reset_peak_memory_stats()
        with bodies_only() if way == "eager" else \
                contextlib.nullcontext(), \
                deterministic() if ordered else contextlib.nullcontext():
            prop = make()
            loop = prop._step.loop
            if way == "graph":
                _stepwise(prop, psi)
                first = prop._step.captures
            runs[way] = _stepwise(prop, psi, loop and way == "graph")
            if way == "graph":
                again = prop._step.captures - first
                tlist = prop.tlist
                prop.tlist = tlist[0] + 0.9 * (tlist - tlist[0])
                _stepwise(prop, psi)
                prop.tlist = tlist
                captures = (first, again, prop._step.captures - first - again)
            del prop
        peaks[way] = torch.cuda.max_memory_reserved() / 2 ** 30 - base
    (pg, tg, reads, att), (pe, te, reads_e, _) = runs["graph"], runs["eager"]
    n = len(reads)
    err = float((pg - pe).abs().max())
    limits = [-(-a // K) + 2 for a in att] if loop else [0] * n
    ok, text = check(pg)
    ok = ok and err == 0.0 and captures == (1, 0, 0) and all(
        (r > 0 or not loop) and r <= m for r, m in zip(reads, limits)) \
        and len(limits) == n
    if not ok:
        raise AssertionError(
            f"phase 19 {label}: graph vs eager max|d| {err}, captures "
            f"{captures}, reads {reads} (limits {limits}), {text}")
    how = (f"attempts/interval mean {np.mean(att):.1f} (min {min(att)}, "
           f"max {max(att)}), host reads/interval graph mean "
           f"{np.mean(reads):.2f} (max {max(reads)}, limit "
           f"ceil(attempts/{K}) + 2), eager mean {np.mean(reads_e):.2f}"
           if loop else f"host reads/interval graph {max(reads)}, eager "
           f"{max(reads_e)}")
    log(f"phase 19 {label} {n} steps: graph {n / tg:.3f} steps/s, eager "
        f"{n / te:.3f} steps/s; {how}; captures 1, 0 after reinit_prop, 0 "
        f"for a new tlist of the same length; graph vs eager max|d|="
        f"{err:.1e}; {text}; peak reserved GiB above before: graph "
        f"{peaks['graph']:.3f}, eager {peaks['eager']:.3f} [{card}]")
    return pg


def _near(oracle, tol, what):
    """A ``check`` for :func:`hold_ways`: ‖result − oracle‖₂ ≤ ``tol``."""
    def check(out):
        d = float(np.linalg.norm(out.cpu().numpy() - oracle))
        return d <= tol, f"|d| vs {what}={d:.3e} (<= {tol:g})"
    return check


def _host_product(H0, Hd, values, dt, substeps=1):
    """``Π exp(−i·(H0 + v·Hd)·dt)`` over ``values`` on the host, each
    interval as ``substeps`` equal steps of its own values: a list of
    ``substeps`` values an interval, or one."""
    import scipy.linalg

    U = np.eye(H0.shape[0], dtype=complex)
    for v in values:
        for s in np.atleast_1d(v):
            U = scipy.linalg.expm(-1j * (H0 + s * Hd) * (dt / substeps)) @ U
    return U


def ode_expprop_small(device, card, sparse):
    """Phase 19a and 19c on the small systems: ``method="ode"``
    (``pwc=True`` and a continuous ``torch.cos`` drive) and
    ``method="expprop"`` on phase 9's N = 1024 sparse Hermitian (20
    steps; its drive term is the operator itself, so that ``expm`` of
    the integrated generator is the oracle) and on the N = 10 transmon
    of phase 18b."""
    import scipy.sparse as sp

    import quantumpropagators_torch as qt
    from quantumpropagators_torch.models.controls import \
        discretize_on_midpoints

    op, psi = sparse
    H, psi_h = sparse_hermitian()
    N = H.shape[0]
    lam, V = np.linalg.eigh(H.toarray())
    tlist = np.linspace(0.0, 10.0, 21)
    host_drive = lambda t: 0.5 * float(np.cos(2.0 * t))
    S_pwc = float(np.sum(np.diff(tlist) * (1.0 + discretize_on_midpoints(
        host_drive, tlist))))
    S_cont = 10.0 + 0.25 * np.sin(20.0)  # ∫ (1 + cos(2t)/2) dt over [0, 10]

    def oracle(S):
        return V @ (np.exp(-1j * lam * S) * (V.T @ psi_h))

    pwc_gen = qt.hamiltonian(op, (op, host_drive))
    cont_gen = qt.hamiltonian(op, (op, lambda t: 0.5 * torch.cos(2.0 * t)))
    # the ODE's every product is the CSR one: summed in one order
    # (deterministic); expprop's are dense matrix products
    for label, gen, kw, S, tol, ordered in (
            (f"19a ode pwc sparse Hermitian N={N}", pwc_gen,
             dict(method="ode", pwc=True), S_pwc, 1e-7, True),
            (f"19a ode continuous (torch.cos drive) sparse Hermitian N={N}",
             cont_gen, dict(method="ode", pwc=False), S_cont, 1e-7, True),
            (f"19c expprop sparse Hermitian N={N}", pwc_gen,
             dict(method="expprop"), S_pwc, 1e-10, False)):
        hold_ways(label, lambda: qt.init_prop(psi, gen, tlist, **kw), psi,
                  card, _near(oracle(S), tol, "expm"), ordered)

    N = 10
    a = sp.diags(np.sqrt(np.arange(1, N, dtype=float)), 1).toarray()
    n_op = a.T @ a
    H0 = 6.0 * n_op - 0.1 * (n_op @ (n_op - np.eye(N)))
    Hd = a + a.T
    host_eps = lambda t: 0.3 * float(np.cos(5.8 * t))
    terms = [qt.dia_from_scipy(sp.csr_matrix(H0), device=device),
             qt.dia_from_scipy(sp.csr_matrix(Hd), device=device)]
    psi_t = torch.as_tensor(np.eye(N)[0].astype(complex), device=device)
    e0 = np.eye(N)[0]
    full = np.linspace(0.0, 10.0, 101)
    short = full[:TRANSMON_ODE_STEPS + 1]
    dt = full[1] - full[0]

    def fine(M):
        mids = [short[k] + dt * (np.arange(M) + 0.5) / M
                for k in range(len(short) - 1)]
        return _host_product(H0, Hd, [0.3 * np.cos(5.8 * m) for m in mids],
                             dt, M) @ e0

    coarse, finer = (fine(M) for M in RICHARDSON)
    cont_oracle = (4.0 * finer - coarse) / 3.0
    pwc_gen = qt.hamiltonian(terms[0], (terms[1], host_eps))
    cont_gen = qt.hamiltonian(terms[0], (terms[1],
                                         lambda t: 0.3 * torch.cos(5.8 * t)))
    for label, gen, tl, kw, want, tol, what in (
            ("19a ode pwc transmon N=10", pwc_gen, short,
             dict(method="ode", pwc=True),
             _host_product(H0, Hd, discretize_on_midpoints(host_eps, short),
                           dt) @ e0, 1e-7, "expm"),
            ("19a ode continuous (torch.cos drive) transmon N=10", cont_gen,
             short, dict(method="ode", pwc=False), cont_oracle, 1e-7,
             f"Richardson of expm on {RICHARDSON} substeps"),
            ("19c expprop transmon N=10", pwc_gen, full,
             dict(method="expprop"),
             _host_product(H0, Hd, discretize_on_midpoints(host_eps, full),
                           dt) @ e0, 1e-10, "expm")):
        hold_ways(label, lambda: qt.init_prop(psi_t, gen, tl, **kw), psi_t,
                  card, _near(want, tol, what))


def ode_chain(device, card):
    """Phase 19b: the L = 20 chain with its driven amplitude over 2
    intervals of DT, ``pwc=True`` (against the fused dd Chebyshev result
    of the same grid) and continuous (the drive in ``torch`` math; against
    the Richardson extrapolation of the fused dd Chebyshev results on the
    grid cut into 32 and 64 substeps an interval: the piecewise error is
    O(dt²)).  Returns the flip launches of the Chebyshev references."""
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.ops import cheby_flip as cf

    T = N_STEPS * DT
    H_diag, H = tfim_generator(ODE_L, device)
    cont = qt.hamiltonian(H_diag, (H.ops[1], _torch_flattop(T, 0.3 * T)))
    psi0 = random_state(ODE_L, torch.complex128, device, SEED + 190)
    tlist = np.linspace(0.0, ODE_INTERVALS * DT, ODE_INTERVALS + 1)
    cf.reset_launches()
    refs = {}
    for M in (1,) + RICHARDSON:
        grid = np.linspace(0.0, tlist[-1], ODE_INTERVALS * M + 1)
        refs[M] = qt.propagate(psi0, H, grid, method="cheby", fused=True,
                               kernel="dd").cpu().numpy()
    torch.cuda.synchronize()
    launches = dict(cf.LAUNCHES)
    lo, hi = (refs[M] for M in RICHARDSON)
    for label, gen, kw, want, what in (
            ("19b ode pwc chain", H, dict(pwc=True), refs[1],
             "fused dd cheby"),
            ("19b ode continuous (torch flattop) chain", cont,
             dict(pwc=False), (4.0 * hi - lo) / 3.0,
             f"Richardson of fused dd cheby on {RICHARDSON} substeps")):
        hold_ways(f"{label} L={ODE_L}", lambda: qt.init_prop(
            psi0, gen, tlist, method="ode", **kw), psi0, card,
            _near(want, 1e-7, what))
    return launches


def ode_phase(device, card, sparse):
    """Phase 19: the ODE loop and expprop's step as graphed sites (19a,
    19c small systems; 19b the L = 20 chain).  Returns the flip launches
    of 19b's Chebyshev references."""
    t0 = time.perf_counter()
    ode_expprop_small(device, card, sparse)
    launches = ode_chain(device, card)
    log(f"phase 19 {time.perf_counter() - t0:.1f} s")
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_phase(device, card, chain, finals, ctx, rates, group):
    """Phase 10: the sharded paths on four shard slots of this card, all
    in this process, over the world-size-1 NCCL ``group``: the L = 24
    chain in both tiers against phases 3 and 4 (then a trace of 3 steps
    of each), the same on 32 slots (:func:`wide_sharded`: five slot-bit
    partners a high pass), one step with a zero-coupling slot bit,
    banded20 against phase 7 (after ``banded_spmv`` on each slot's
    planes against its plain version), and small checks of the chain,
    CSR and BSR paths.
    Norms go through the mesh's ``psum`` (NCCL ``all_reduce``).  Returns
    the flip launches of each counted path and the banded launches of
    the banded20 path."""
    from quantumpropagators_torch.models.generators import (
        coeff_table, coeff_table_np)
    from quantumpropagators_torch.ops import banded_spmv as bs
    from quantumpropagators_torch.ops import cheby_flip as cf
    from quantumpropagators_torch.ops.fused_cheby import make_flip_plan
    from quantumpropagators_torch.ops.fused_cheby_dd import (
        cheby_step_fused_dd, f32_tail_orders)
    from quantumpropagators_torch.parallel import sharded_banded as sbd
    from quantumpropagators_torch.parallel import sharded_fused as sf
    from quantumpropagators_torch.parallel.mesh import chain_mesh, \
        shard_vector

    t_phase = time.perf_counter()
    mesh = chain_mesh(4, group=group, device=device)

    def norm_err(x):
        return abs(float(mesh.psum((x.abs() ** 2).sum(-1))) - 1.0)

    psi0, H, wrk = chain
    psi_dd, psi_32 = finals
    L = L_MAIN
    tlist = np.linspace(0.0, N_STEPS * DT, N_STEPS + 1)
    diag = H.ops[0].diag.real.to(torch.float64)
    beta = wrk.delta / 2.0 + wrk.e_min
    c64 = np.asarray(wrk.coeffs, dtype=np.float64)
    tail = f32_tail_orders(c64)
    # the dd main path's per-step, per-bit flip table (fused._dd_path)
    drive = np.asarray(coeff_table_np(H, tlist))[:, 0]
    Gbits = torch.as_tensor(np.outer(drive, np.full(L, G_FIELD)),
                            device=device)
    kw = dict(delta=wrk.delta, e_min=wrk.e_min, dt=wrk.dt)
    paths, out = {}, {}

    # -- (b) TFIM L = 24 over 4 slots, reference tier -------------------
    step_dd = sf.make_sharded_fused_cheby_step_dd(mesh, L, 1.0,
                                                  f32_tail=tail, **kw)
    dmb = shard_vector(mesh, diag - beta)

    def run_dd(n=N_STEPS):
        state = shard_vector(mesh, psi0)
        for k in range(n):
            state = step_dd(dmb, state, c64, flip_scale=Gbits[k])
        return state

    exchanges = count_exchanges(mesh)
    cf.reset_launches()
    t0 = time.perf_counter()
    state = run_dd()
    torch.cuda.synchronize()
    t_dd = time.perf_counter() - t0
    paths["phase 10 sharded dd"] = counts = dict(cf.LAUNCHES)
    if not all(counts[k] > 0 for k in (
            "cheby_flip_first<double>", "cheby_flip_iter<double>",
            "cheby_flip_high<double>", "cheby_flip_iter<float>",
            "cheby_flip_high<float>")):
        raise AssertionError(f"sharded dd launches: {counts}")
    err = float((state.reshape(-1) - psi_dd).abs().max())
    nerr = norm_err(state)
    if not (err <= 1e-12 and nerr <= 1e-12):
        raise AssertionError(f"sharded dd vs phase 3: {err}, norm {nerr}")
    flips = sum(counts.values()) / N_STEPS
    log(f"phase 10 sharded dd L={L} 4 slots {N_STEPS} steps: max|d| vs "
        f"phase 3={err:.3e} (<= 1e-12), |psum norm^2-1|={nerr:.2e}, "
        f"exchange {step_dd.exchange_plan}, Mesh.ppermute calls "
        f"{len(exchanges)} (slot bits read in the kernels), flip "
        f"launches/step {flips:.0f} ok")
    out["dd"] = (N_STEPS / t_dd, N_STEPS / median_wall(run_dd)[1])
    del state
    trace_steps(lambda: run_dd(3), f"phase 10 trace sharded dd L={L} 4 "
                f"slots", 3, card, top=6)

    # -- (b) f32 tier -----------------------------------------------------
    table = coeff_table(H, tlist)
    table = (table.real if table.is_complex() else table).to(
        torch.float32)[:, 0]
    step_32 = sf.make_sharded_fused_cheby_step(mesh, L, G_FIELD, **kw)
    d32 = shard_vector(mesh, diag)
    p32 = psi0.to(torch.complex64)

    def run_32(n=N_STEPS):
        re = shard_vector(mesh, p32.real.contiguous())
        im = shard_vector(mesh, p32.imag.contiguous())
        for k in range(n):
            re, im = step_32(d32, re, im, c64, flip_scale=table[k])
        return torch.complex(re, im)

    cf.reset_launches()
    t0 = time.perf_counter()
    state = run_32()
    torch.cuda.synchronize()
    t_32 = time.perf_counter() - t0
    if exchanges:
        raise AssertionError(f"one-rank sharded steps exchanged "
                             f"{len(exchanges)} times")
    del mesh.ppermute
    paths["phase 10 sharded f32"] = counts = dict(cf.LAUNCHES)
    if not all(counts[f"cheby_flip_{k}<float>"] > 0
               for k in ("first", "iter", "high")):
        raise AssertionError(f"sharded f32 launches: {counts}")
    err = float((state.reshape(-1) - psi_32).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"sharded f32 vs phase 4: {err}")
    log(f"phase 10 sharded f32 L={L} 4 slots {N_STEPS} steps: max|d| vs "
        f"phase 4={err:.3e} (<= 1e-5), Mesh.ppermute calls 0, flip "
        f"launches/step {sum(counts.values()) / N_STEPS:.0f} ok")
    out["pallas"] = (N_STEPS / t_32, N_STEPS / median_wall(run_32)[1])
    del state
    trace_steps(lambda: run_32(3), f"phase 10 trace sharded f32 L={L} 4 "
                f"slots", 3, card, top=6)
    del d32, p32
    paths.update(wide_sharded(device, card, group, chain, finals, out,
                              (diag, beta, c64, tail, Gbits, table, kw)))

    # -- (b) a zero-coupling slot bit: its exchange is skipped -----------
    g_bits = np.full(L, G_FIELD)
    g_bits[5] = 0.0
    order, g_perm = sf.weak_site_permutation(L, g_bits, 4)
    step_w = sf.make_sharded_fused_cheby_step_dd(mesh, L, g_perm,
                                                 f32_tail=tail, **kw)
    if step_w.exchange_plan["skipped_zero_coupling_bits"] != 1:
        raise AssertionError(f"weak-site plan {step_w.exchange_plan}")
    got = step_w(sf.permute_index_bits(diag - beta, order),
                 sf.permute_index_bits(psi0, order), c64)
    got = sf.permute_index_bits(got, sf.invert_bit_order(order))
    want = cheby_step_fused_dd(make_flip_plan(L, g_bits), diag - beta,
                               psi0, c64, f32_tail=tail, **kw)
    err = float((got - want).abs().max())
    if not err <= 1e-12:
        raise AssertionError(f"weak-site step vs unsharded: {err}")
    log(f"phase 10 weak-site slot bits {order[-2:]} (g[5] = 0): "
        f"skipped_zero_coupling_bits=1, one step vs the unsharded dd "
        f"step max|d|={err:.3e} (<= 1e-12) ok")
    del got, want, dmb

    # -- (c) banded20 over 4 slots ---------------------------------------
    bw = ctx["wrk"]
    pb, step_b, kind = sbd.make_sharded_dd_cheby_step(
        mesh, ctx["banded"], 4, delta=bw.delta, e_min=bw.e_min,
        dt=bw.dt, tile_rows=8)
    if kind != "banded_pallas":
        raise AssertionError(f"banded20 sharded kind {kind}")
    err_b = slot_planes_check(pb, shard_vector(mesh, ctx["psi0"]))
    cb = np.asarray(bw.coeffs, dtype=np.float64)

    def run_b():
        state = shard_vector(mesh, ctx["psi0"])
        for _ in range(N_STEPS):
            state = step_b(pb, state, cb)
        return state

    bs.reset_launches()
    t0 = time.perf_counter()
    state = run_b()
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    n_banded = bs.LAUNCHES[BANDED]
    want_n = 4 * N_STEPS * (len(cb) - 1)
    if n_banded != want_n:
        raise AssertionError(f"sharded banded launches {n_banded}, "
                             f"expected {want_n}")
    err = float((state.reshape(-1) - ctx["psi_T"]).abs().max())
    nerr = norm_err(state)
    if not (err <= 1e-10 and nerr <= 1e-12):
        raise AssertionError(f"sharded banded20 vs phase 7: {err}, "
                             f"norm {nerr}")
    log(f"phase 10 sharded banded20 2^{N_BANDED.bit_length() - 1} 4 "
        f"slots (R_local={pb.R_local}, "
        f"kind={kind}) {N_STEPS} steps: max|d| vs phase 7={err:.3e} "
        f"(<= 1e-10), |psum norm^2-1|={nerr:.2e}, launches={n_banded} "
        f"= 4 x {N_STEPS} x ({len(cb)} - 1) ok")
    del state
    out["banded20"] = (N_STEPS / t_b, N_STEPS / median_wall(run_b)[1])
    del pb

    small_sharded_checks(mesh, device)
    for tier, base in (("dd", rates["dd"][0]), ("pallas", rates["pallas"][0]),
                       ("banded20", ctx["steps_s"])):
        log(f"phase 10 time {tier}: sharded 4 slots {out[tier][0]:.3f} "
            f"steps/s (the counted run), {out[tier][1]:.3f} steps/s "
            f"(median of 3 timed runs after it), unsharded {base:.3f} "
            f"steps/s (phase "
            f"{dict(dd=6, pallas=6, banded20=7)[tier]}) [{card}]")
    log(f"phase 10 wall {time.perf_counter() - t_phase:.1f} s")
    return paths, n_banded, err_b


def wide_sharded(device, card, group, chain, finals, four, inputs, n_time=5):
    """Phase 10 (b) on :data:`WIDE_SLOTS` slots of 2^19: the L = 24
    chain in both tiers, graphed, its five slot bits each a partner of
    every high pass (h = 1, 32 launches a pass, no ``ppermute``): one
    counted run of N_STEPS steps held against phases 3 and 4 as the
    4-slot run is (dd <= 1e-12, f32 <= 1e-5), then steps/s over
    ``n_time``-step runs beside the 4-slot rates ``four`` and a trace of
    3 steps.  Returns the flip launches of each tier's counted run."""
    from quantumpropagators_torch.ops import cheby_flip as cf
    from quantumpropagators_torch.parallel import sharded_fused as sf
    from quantumpropagators_torch.parallel.mesh import chain_mesh, \
        shard_vector

    t0 = time.perf_counter()
    diag, beta, c64, tail, Gbits, table, kw = inputs
    psi0 = chain[0]
    mesh = chain_mesh(WIDE_SLOTS, group=group, device=device)
    L, label = L_MAIN, f"{WIDE_SLOTS} slots"
    step_dd = sf.make_sharded_fused_cheby_step_dd(mesh, L, 1.0,
                                                  f32_tail=tail, **kw)
    step_32 = sf.make_sharded_fused_cheby_step(mesh, L, G_FIELD, **kw)
    dmb, d32 = shard_vector(mesh, diag - beta), shard_vector(mesh, diag)
    p32 = psi0.to(torch.complex64)

    def run_dd(n=N_STEPS):
        state = shard_vector(mesh, psi0)
        for k in range(n):
            state = step_dd(dmb, state, c64, flip_scale=Gbits[k])
        return state

    def run_32(n=N_STEPS):
        re = shard_vector(mesh, p32.real.contiguous())
        im = shard_vector(mesh, p32.imag.contiguous())
        for k in range(n):
            re, im = step_32(d32, re, im, c64, flip_scale=table[k])
        return torch.complex(re, im)

    paths = {}
    for tier, run, want, tol in (("dd", run_dd, finals[0], 1e-12),
                                 ("f32", run_32, finals[1], 1e-5)):
        exchanges = count_exchanges(mesh)
        cf.reset_launches()
        t1 = time.perf_counter()
        state = run()
        torch.cuda.synchronize()
        counted = N_STEPS / (time.perf_counter() - t1)
        del mesh.ppermute
        paths[f"phase 10 sharded {tier} {label}"] = counts = dict(
            cf.LAUNCHES)
        types = ("double", "float") if tier == "dd" else ("float",)
        if exchanges or not all(counts[f"cheby_flip_{k}<{c}>"] > 0
                                for k in ("iter", "high") for c in types):
            raise AssertionError(f"sharded {tier} {label}: launches "
                                 f"{counts}, exchanges {len(exchanges)}")
        err = float((state.reshape(-1) - want).abs().max())
        if not err <= tol:
            raise AssertionError(f"sharded {tier} {label} vs phase "
                                 f"{3 if tier == 'dd' else 4}: {err}")
        del state
        per_step = sum(counts.values()) / N_STEPS
        steps_s = n_time / median_wall(lambda: run(n_time))[1]
        log(f"phase 10 sharded {tier} L={L} {label} {N_STEPS} steps: max|d| "
            f"vs phase {3 if tier == 'dd' else 4}={err:.3e} (<= {tol:g}), "
            f"Mesh.ppermute calls 0, "
            f"{step_dd.exchange_plan['live_device_bits']} slot-bit "
            f"partners a high pass, flip launches/step "
            f"{per_step:.0f} ok; {counted:.3f} steps/s (the counted run), "
            f"{steps_s:.3f} steps/s (median of 3 timed {n_time}-step runs), "
            f"4 slots {four['dd' if tier == 'dd' else 'pallas'][1]:.3f} "
            f"[{card}]")
        trace_steps(lambda: run(3), f"phase 10 trace sharded {tier} L={L} "
                    f"{label}", 3, card, top=6)
    log(f"phase 10 {label} wall {time.perf_counter() - t0:.1f} s")
    return paths


def count_exchanges(mesh):
    """Records the dtype of each ``mesh.ppermute`` call in the returned
    list until ``del mesh.ppermute``."""
    seen, inner = [], mesh.ppermute

    def ppermute(x, perm):
        seen.append(x.dtype)
        return inner(x, perm)

    mesh.ppermute = ppermute
    return seen


def slot_planes_check(pb, x):
    """Phase 10 (c): ``banded_spmv<double>`` in clamped mode on each
    slot's partitioned planes (its cross-slot edge blocks zeroed) and
    that slot's rows of ``x``, against the plain version; returns the
    max-abs error or raises (relative error ``<= 1e-13``, as phase 7)."""
    from quantumpropagators_torch.ops import banded_spmv as bs

    err = rel = 0.0
    for s in range(pb.n_devices):
        got = bs.banded_spmv(pb.planes[s], pb.offsets, x[s])
        want = bs.banded_spmv_plain(pb.planes[s], pb.offsets, x[s])
        d = float((got - want).abs().max())
        err, rel = max(err, d), max(rel, d / float(want.abs().max()))
    if not rel <= 1e-13:
        raise AssertionError(f"{BANDED} on the slot planes: rel {rel}")
    log(f"phase 10 kernel-vs-plain {BANDED} on each of {pb.n_devices} slots' "
        f"planes (R_local={pb.R_local}, edge blocks zeroed): max|d|={err:.3e} "
        f"rel={rel:.3e} (rel <= 1e-13) ok")
    return err


def small_sharded_checks(mesh, device):
    """Phase 10 (d): the chain step (L = 16, prepared site terms), the
    CSR and BSR applies and the BSR dd step (2^14) on the card against
    their unsharded counterparts."""
    import scipy.sparse as sp

    import quantumpropagators_torch as qt
    from quantumpropagators_torch.ops.cheby import cheby_apply, cheby_coeffs
    from quantumpropagators_torch.ops.df64_sparse import (
        bsr_dd_from_scipy, cheby_apply_dd_bsr)
    from quantumpropagators_torch.parallel import sharded_bsr as sbsr
    from quantumpropagators_torch.parallel import sharded_chain as sch
    from quantumpropagators_torch.parallel import sharded_csr as scsr

    errs = {}
    H_diag, H_x = qt.transverse_field_ising(16, J=J, g=G_FIELD, h=H_FIELD,
                                            dtype=torch.complex128,
                                            device=device)
    op = qt.Operator([H_diag, H_x], [1.0])
    bound = (16 - 1) * J + 16 * (G_FIELD + H_FIELD)
    coeffs = cheby_coeffs(2 * bound, DT)
    psi = random_state(16, torch.complex128, device, SEED + 90)
    op_sh = sch.prepare_sharded_operator(op, 4)
    step = sch.make_sharded_cheby_step(mesh, op_sh, delta=2 * bound,
                                       e_min=-bound, dt=DT)
    errs["chain step L=16"] = (step(op_sh, psi, coeffs) - cheby_apply(
        op, psi, coeffs, 2 * bound, -bound, DT)).abs().max()

    rng = np.random.default_rng(SEED + 91)
    N, w = 2 ** 14, 24
    A = sp.diags([rng.standard_normal(N - abs(k)) for k in range(-w, w + 1)],
                 list(range(-w, w + 1))).tocsr()
    A = (0.5 * (A + A.T)).tocsr()
    x = random_state(14, torch.complex128, device, SEED + 92)
    want = qt.csr_from_scipy(A, device=device).apply(x)
    scale = want.abs().max()
    pa = scsr.partition_csr_rows(A, 4, device=device)
    pc = scsr.partition_csr_banded(A, 4, device=device)
    pb = sbsr.partition_bsr(A, 4, block_size=64, device=device)
    errs["CSR all-gather apply (rel)"] = (scsr.make_allgather_csr_apply(
        mesh, pa)(pa, x) - want).abs().max() / scale
    errs["CSR banded apply (rel)"] = (scsr.make_banded_csr_apply(
        mesh, pc)(pc, x) - want).abs().max() / scale
    errs["BSR banded apply (rel)"] = (sbsr.make_banded_bsr_apply(
        mesh, pb)(pb, x) - want).abs().max() / scale
    bound = float(np.abs(A).sum(axis=1).max())
    c = cheby_coeffs(2 * bound, DT)
    pdd = sbsr.partition_bsr_dd(A, 4, block_size=64, device=device)
    dstep = sbsr.make_sharded_bsr_cheby_step_dd(mesh, pdd, delta=2 * bound,
                                                e_min=-bound, dt=DT)
    ref = cheby_apply_dd_bsr(bsr_dd_from_scipy(A, 64, device=device), x, c,
                             2 * bound, -bound, DT)
    errs["BSR dd step"] = (dstep(pdd, x, c) - ref).abs().max()
    torch.cuda.synchronize()
    for name, e in errs.items():
        tol = 1e-13 if "rel" in name else 1e-12
        if not float(e) <= tol:
            raise AssertionError(f"phase 10 {name}: {float(e)} > {tol}")
    log("phase 10 small sharded checks on the card: " + ", ".join(
        f"{name} {float(e):.3e}" for name, e in errs.items())
        + " (<= 1e-13 rel / 1e-12) ok")


class _ErrorLog(logging.Handler):
    """The messages of the contract checkers' ERROR records."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def sharded_krylov_phase(device, card, ctx, group, rates9, sparse):
    """Phase 11: the Krylov methods on banded20 sharded over four slots of
    this card (the world-size-1 NCCL ``group``): phase 7's operator
    partitioned in halo mode behind ``DistributedBSR``, (a) ``specrange``
    against the unsharded one on the same state, (b) 5 ``newton`` steps
    through ``propagate`` against phase 7's 5 Chebyshev steps, (c) the
    same for ``expv``, (d) (b)'s backward round trip, (e) every result
    in the ``(4, 2^18)`` layout on the card, (f) ``check_propagator`` on
    a sharded Newton propagator and on every registered method at the
    N = 1024 sparse Hermitian (``sparse``), nothing logged.  Then times
    against phase 9's unsharded ``rates9`` and a trace of one sharded
    Newton step.  Launches none of the kernels (the slab matvec is the
    plain einsum), which it checks."""
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.ops import arnoldi as arnoldi_mod
    from quantumpropagators_torch.ops import banded_spmv as bs
    from quantumpropagators_torch.ops import cheby_flip as cf
    from quantumpropagators_torch.parallel import sharded_bsr as sbsr
    from quantumpropagators_torch.parallel.mesh import chain_mesh, \
        shard_vector
    from quantumpropagators_torch.propagators import available_methods
    from quantumpropagators_torch.utils.timings import (disable_timings,
                                                        enable_timings)

    t_phase = time.perf_counter()
    mesh = chain_mesh(4, group=group, device=device)
    op, psi0, tlist = ctx["op"], ctx["psi0"], ctx["tlist"]
    short = tlist[:6]
    L = N_BANDED.bit_length() - 1
    layout = (4, N_BANDED // 4)
    t0 = time.perf_counter()
    pbsr = sbsr.partition_bsr(op, 4, mode="banded", device=device)
    dop = sbsr.DistributedBSR(mesh, pbsr)
    torch.cuda.synchronize()
    if pbsr.halo_blocks != 1 or pbsr.blocks.data_ptr() != op.blocks.data_ptr():
        raise AssertionError(f"banded20 partition: halo {pbsr.halo_blocks}, "
                             "slabs not a view of the operator's blocks")
    log(f"phase 11 partition banded20 2^{L} into 4 slots (halo_blocks=1, "
        f"R_local={pbsr.n_block_rows_local}, slabs a view of phase 7's "
        f"blocks): {time.perf_counter() - t0:.3f} s")
    x0 = shard_vector(mesh, psi0)
    gen = qt.hamiltonian(dop)
    bs.reset_launches()
    cf.reset_launches()

    def check_layout(name, x):
        if tuple(x.shape) != layout or x.device != device \
                or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: shape {tuple(x.shape)} on "
                                 f"{x.device}, not a finite {layout} on "
                                 f"{device}")

    # (a) specrange on the sharded state against the unsharded one
    t0 = time.perf_counter()
    lo, hi = qt.specrange(dop, method="arnoldi", state=x0)
    t_sh = time.perf_counter() - t0
    t0 = time.perf_counter()
    lo_u, hi_u = qt.specrange(op, method="arnoldi", state=psi0)
    t_un = time.perf_counter() - t0
    width = hi_u - lo_u
    d_e = max(abs(lo - lo_u), abs(hi - hi_u))
    if not d_e <= 1e-10 * width:
        raise AssertionError(f"sharded specrange: |dE| = {d_e}")
    log(f"phase 11 (a) specrange arnoldi banded20 4 slots: E = [{lo:.12f}, "
        f"{hi:.12f}], |dE| vs unsharded={d_e:.3e} (<= 1e-10 x {width:.3f}) "
        f"ok; sharded {t_sh:.3f} s, unsharded (BSROperator einsum) "
        f"{t_un:.3f} s [{card}]")

    # (b)-(d) newton and expv, 5 steps, against phase 7's Chebyshev
    out, rates = {}, {}
    for method in ("newton", "expv"):
        out[method] = qt.propagate(x0, gen, short, method=method)
        torch.cuda.synchronize()
        check_layout(method, out[method])
        err = float((out[method].reshape(-1) - ctx["psi_5"]).abs().max())
        if not err <= 1e-10:
            raise AssertionError(f"sharded {method} vs cheby: {err}")
        log(f"phase 11 ({'b' if method == 'newton' else 'c'}) {method} "
            f"banded20 4 slots 5 steps: max|d| vs 5 phase 7 cheby dd steps="
            f"{err:.3e} (<= 1e-10), result {layout} on the card ok")
    back = qt.propagate(out["newton"], gen, short, method="newton",
                        backward=True)
    torch.cuda.synchronize()
    check_layout("newton backward", back)
    err = float((back - x0).abs().max())
    if not err <= 1e-10:
        raise AssertionError(f"sharded newton round trip: {err}")
    log(f"phase 11 (d) newton backward round trip 4 slots: max|d|={err:.3e} "
        f"(<= 1e-10) ok; (e) every result {layout} on {device} ok")
    del back, out

    # (f) the propagator contract, nothing logged
    handler = _ErrorLog()
    checks_log = logging.getLogger("quantumpropagators_torch.interfaces")
    checks_log.addHandler(handler)
    try:
        cases = [("newton sharded banded20", qt.init_prop(
            x0, gen, tlist[:3], method="newton"))]
        sp_op, sp_psi = sparse
        for method in available_methods():
            cases.append((f"{method} N=1024", qt.init_prop(
                sp_psi, sp_op, np.linspace(0.0, 0.2, 3), method=method)))
        failed = [name for name, prop in cases
                  if not qt.check_propagator(prop)]
        torch.cuda.synchronize()
    finally:
        checks_log.removeHandler(handler)
    if failed or handler.messages:
        raise AssertionError(f"check_propagator: {failed} failed, logged "
                             f"{handler.messages}")
    log(f"phase 11 (f) check_propagator True, nothing logged: "
        f"{', '.join(name for name, _ in cases)} ok")
    del cases

    # times: the same calls through their propagators, counting matvecs
    enable_timings()
    try:
        for method in ("newton", "expv"):
            prop = qt.init_prop(x0, gen, short, method=method)
            t0 = time.perf_counter()
            qt.propagate(x0, propagator=prop)
            torch.cuda.synchronize()
            rates[method] = (5 / (time.perf_counter() - t0),
                             prop.timing_data.counters.get("matvec", 0) / 5)
            check_layout(method, prop.state)
    finally:
        disable_timings()
    launched = {k: v for k, v in {**bs.LAUNCHES, **cf.LAUNCHES}.items() if v}
    if launched:
        raise AssertionError(f"phase 11 launched kernels: {launched}")
    for method, (steps_s, matvecs) in rates.items():
        steps, t = rates9[method]
        log(f"phase 11 time {method} banded20 2^{L}: sharded 4 slots "
            f"(DistributedBSR, slab einsum) {steps_s:.3f} steps/s, "
            f"{matvecs:.1f} matvecs/step; unsharded (phase 9, precision=dd, "
            f"{BANDED}) {steps / t:.3f} steps/s [{card}]")

    # one sharded Newton step traced: slab matvec, CGS2 + norms, halos
    one = tlist[:2]
    trace_steps(lambda: qt.propagate(x0, gen, one, method="newton",
                                     check=False),
                "phase 11 trace sharded newton banded20 4 slots", 1, card,
                top=6, regions={
                    "slab matvec": [(sbsr, "_bsr_slab_matvec")],
                    "CGS2 + norms": [(arnoldi_mod, "_cgs2"),
                                     (arnoldi_mod, "sharded_norm")],
                    "halo exchange": [(sbsr, "_halo_extend")]})
    log(f"phase 11 wall {time.perf_counter() - t_phase:.1f} s")


def planar_phase(device, card, wrk, pallas_steps_s, L=L_MAIN):
    """Phase 12a: 5 steps of ``cheby_apply_planar`` on the static chain
    (real float32 operators, the state as float32 planes) against 5
    steps of the f32 flip-kernel path (``kernel="pallas"``) on the same
    operator, state and envelope (phase 3's).  Returns the flip
    launches of the pallas run."""
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.ops import cheby_flip as cf
    from quantumpropagators_torch.ops.planar import (
        cheby_apply_planar, is_real_linear)

    n = 5
    tlist = np.linspace(0.0, n * DT, n + 1)
    H_diag, H_x = qt.transverse_field_ising(L, J=J, g=G_FIELD, h=H_FIELD,
                                            dtype=torch.float32,
                                            device=device)
    op = qt.Operator([H_diag, H_x], np.array([1.0]))
    if not is_real_linear(op):
        raise AssertionError("the float32 chain is not real-linear")
    psi = random_state(L, torch.complex128, device, SEED + 120)
    re = psi.real.to(torch.float32).contiguous()
    im = psi.imag.to(torch.float32).contiguous()
    psi32 = torch.complex(re, im)
    del psi

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        re, im = cheby_apply_planar(op, re, im, wrk.coeffs, wrk.delta,
                                    wrk.e_min, wrk.dt)
    torch.cuda.synchronize()
    t_planar = time.perf_counter() - t0
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise AssertionError(f"planar planes became {re.dtype}/{im.dtype}")

    cf.reset_launches()
    out = qt.propagate(psi32, op, tlist, method="cheby", fused=True,
                       kernel="pallas", workspace=wrk)
    torch.cuda.synchronize()
    counts = dict(cf.LAUNCHES)
    check_launches("pallas", counts, "float", n_steps=n)
    diff = torch.linalg.vector_norm(torch.complex(re, im) - out)
    err = float(diff)
    norm_err = abs(float(torch.linalg.vector_norm(torch.complex(re, im)))
                   - 1.0)
    if not (err <= 1e-5 and norm_err <= 1e-5):
        raise AssertionError(f"planar vs pallas: |d|_2 = {err}, "
                             f"norm {norm_err}")
    log(f"phase 12a planar L={L} float32 planes {n} steps: |d|_2 vs "
        f"{n} pallas (f32 flip kernel) steps={err:.3e} (<= 1e-5), "
        f"|norm-1|={norm_err:.2e}; planar {n / t_planar:.3f} steps/s "
        f"(plain PyTorch, no kernel), pallas main path {pallas_steps_s:.3f} "
        f"steps/s (phase 6) [{card}]")
    return counts


def batched_phase(device, card, L=L_CHECK, n_batch=8):
    """Phase 12b: one ``cheby_apply`` on an ``(n_batch, 2^L)`` complex128
    batch of seeded states against single calls, and ``torch.func.vmap``
    over ``n_batch`` drive amplitudes in [0, 1] through
    ``Operator([H_diag, H_x], [amp])`` against a loop (<= 1e-12)."""
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.ops.cheby import cheby_apply, cheby_coeffs

    H_diag, H_x = qt.transverse_field_ising(L, J=J, g=G_FIELD, h=H_FIELD,
                                            dtype=torch.complex128,
                                            device=device)
    bound = (L - 1) * J + L * (G_FIELD + H_FIELD)
    delta, e_min = 2.0 * bound, -bound
    coeffs = cheby_coeffs(delta, DT)
    op = qt.Operator([H_diag, H_x], np.array([1.0]))
    batch = torch.stack([random_state(L, torch.complex128, device,
                                      SEED + 130 + k)
                         for k in range(n_batch)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cheby_apply(op, batch, coeffs, delta, e_min, DT)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    singles = [cheby_apply(op, batch[k], coeffs, delta, e_min, DT)
               for k in range(n_batch)]
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    err_b = max(float((out[k] - singles[k]).abs().max())
                for k in range(n_batch))
    del out, singles

    psi = batch[0]
    amps = torch.linspace(0.0, 1.0, n_batch, dtype=torch.float64,
                          device=device)

    def with_amp(amp):
        return cheby_apply(qt.Operator([H_diag, H_x], amp.reshape(1)), psi,
                           coeffs, delta, e_min, DT)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = torch.func.vmap(with_amp)(amps)
    torch.cuda.synchronize()
    t_vmap = time.perf_counter() - t0
    t0 = time.perf_counter()
    loop = [with_amp(amps[k]) for k in range(n_batch)]
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    err_v = max(float((outs[k] - loop[k]).abs().max())
                for k in range(n_batch))
    if outs.shape != (n_batch, 2 ** L) or not (err_b <= 1e-12
                                               and err_v <= 1e-12):
        raise AssertionError(f"batched: {err_b}, vmap: {err_v}, shape "
                             f"{tuple(outs.shape)}")
    log(f"phase 12b batched L={L} ({n_batch}, 2^{L}) complex128: batch vs "
        f"single calls max|d|={err_b:.3e}, vmap over {n_batch} drive "
        f"amplitudes vs a loop max|d|={err_v:.3e} (<= 1e-12) ok; batch "
        f"{t_batch:.4f} s vs {n_batch} single calls {t_single:.4f} s, vmap "
        f"{t_vmap:.4f} s vs loop {t_loop:.4f} s [{card}]")


@contextlib.contextmanager
def loop_scans():
    """Every :class:`GraphedScan` runs the plain loop of its step inside
    it: the scan under autograd before the tape (and the no-grad scan on
    the CPU)."""
    from quantumpropagators_torch.utils.scan import (GraphedScan, _length,
                                                     _loop)

    saved = GraphedScan._run
    GraphedScan._run = lambda self, carry, xs, length: (
        _loop(self.step, carry, xs, _length(xs, length)), False)
    try:
        yield
    finally:
        GraphedScan._run = saved


@contextlib.contextmanager
def counted_graphs():
    """The CUDA graphs made inside it, counted (a list, one entry each)."""
    real, made = torch.cuda.CUDAGraph, []

    def counted(*args, **kwargs):
        made.append(1)
        return real(*args, **kwargs)

    torch.cuda.CUDAGraph = counted
    try:
        yield made
    finally:
        torch.cuda.CUDAGraph = real


def grad_ways(label, loss_and_grad, table, card, steady=1):
    """``loss_and_grad(table) -> (loss, grad)`` three ways: as the loop
    under autograd, then through the tape's graphs on its first call
    (interval 0 eagerly, both captures) and on ``steady`` later calls
    (replays only).  Each way's seconds a call (host clock to the
    synchronize), peak allocated and peak reserved GiB (after an
    ``empty_cache``) and captures a call; the gradients of both graphed
    calls held against the loop's, bit for bit (the replays run the
    loop's kernels on the same values in the same order).
    Returns ``{way: (s, peak GiB, reserved GiB, captures, graph pools'
    GiB)}`` and the first graphed call's ``(loss, grad)``."""
    gib = 2.0 ** 30

    def run(calls):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with counted_graphs() as made:
            t0 = time.perf_counter()
            for _ in range(calls):
                out = loss_and_grad(table)
            torch.cuda.synchronize()
            t = (time.perf_counter() - t0) / calls
        return out, (t, torch.cuda.max_memory_allocated() / gib,
                     torch.cuda.max_memory_reserved() / gib,
                     len(made) / calls, graph_pool_gib())

    with loop_scans():
        (_, g_loop), loop = run(1)
    first_out, first = run(1)
    (_, g_steady), steady_way = run(steady)
    err = max(float((g - g_loop).abs().max())
              for g in (first_out[1], g_steady))
    if err != 0.0:
        raise AssertionError(f"12c {label}: graphed gradient vs the loop's "
                             f"max|d| {err} (must be 0)")
    ways = {"loop": loop, "graph first": first, "graph": steady_way}
    log(f"phase 12c {label}: graphed gradient vs the loop's max|d| "
        f"{err:.3e} (= 0); forward + backward "
        + "; ".join(f"{way} {t:.4f} s, peak {pk:.3f} GiB allocated, "
                    f"{rs:.3f} reserved ({pool:.3f} in graph pools after "
                    f"it), {c:g} captures a call"
                    for way, (t, pk, rs, c, pool) in ways.items())
        + f" [{card}]")
    return ways, first_out


def grape_grad_ways(device, card):
    """Phase 12c on the GRAPE example's problem
    (``examples/grape_state_transfer_torch.problem``: a two-level system,
    80 intervals): a GRAPE iteration both ways (:func:`grad_ways`, 20
    steady calls)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "examples"))
    from grape_state_transfer_torch import problem

    loss_and_grad, table0, _ = problem(device)
    grad_ways("GRAPE example (2 levels, 80 intervals)", loss_and_grad,
              table0, card, steady=20)


def chain16_grad_ways(device, card, L=16, n=N_STEPS):
    """Phase 12c on the 2^16 driven chain (phase 3's chain at L = 16,
    ``n`` intervals, a manual envelope over the spectrum's bound):
    the infidelity's gradient both ways (:func:`grad_ways`, 3 steady
    calls)."""
    from quantumpropagators_torch.fused import make_fused_cheby_propagator
    from quantumpropagators_torch.models.generators import coeff_table

    _, H = tfim_generator(L, device)
    psi0 = random_state(L, torch.complex128, device, SEED + 170)
    target = random_state(L, torch.complex128, device, SEED + 171)
    tlist = np.linspace(0.0, n * DT, n + 1)
    b = J * (L - 1) + H_FIELD * L + G_FIELD * L
    fn = make_fused_cheby_propagator(psi0, H, tlist, E_min=-b, E_max=b,
                                     specrange_method="manual")

    def loss_and_grad(table):
        table = table.detach().requires_grad_(True)
        psi, _ = fn(psi0, table)
        loss = 1.0 - torch.vdot(target, psi).abs() ** 2
        (g,) = torch.autograd.grad(loss, table)
        return loss.detach(), g

    grad_ways(f"driven chain 2^{L}, {n} intervals", loss_and_grad,
              coeff_table(H, tlist).to(device), card, steady=3)


def gradient_phase(device, card, chain, p_xla, L=L_MAIN, n=5):
    """Phase 12c: gradients through ``make_fused_cheby_propagator`` on the
    first ``n`` intervals of phase 3's driven chain (complex128, phase
    3's envelope): (a) the forward against phase 3's plain generic
    result and ``kernel="dd"``; (b) the autograd gradient of the
    infidelity to a fixed seeded target against central finite
    differences at 3 table entries; (c) 3 gradient-descent steps each
    lower the infidelity; the trajectory cost on ⟨σz₀⟩ through
    ``observable_fn`` has a finite, nonzero gradient; (d) forward and
    forward + backward seconds and the peak device memory.  Every
    gradient runs through the scan's tape (forward and backward graph
    replays); (b) and (d) hold its first and a later call against the
    loop under autograd (:func:`grad_ways`), as do the GRAPE example's
    problem and the 2^16 chain.  Returns the flip launches of the dd
    run."""
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.fused import make_fused_cheby_propagator
    from quantumpropagators_torch.models.generators import coeff_table
    from quantumpropagators_torch.ops import cheby_flip as cf

    psi0, H, wrk = chain
    tlist = np.linspace(0.0, N_STEPS * DT, N_STEPS + 1)[:n + 1]
    envelope = dict(E_min=wrk.e_min, E_max=wrk.e_min + wrk.delta,
                    specrange_method="manual", specrange_buffer=0.0)
    fn = make_fused_cheby_propagator(psi0, H, tlist, **envelope)
    table0 = coeff_table(H, tlist).to(device)
    n_orders = len(wrk.coeffs)

    # (a) the forward, and the reference tier on the flip kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        psi_T, _ = fn(psi0, table0)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    cf.reset_launches()
    p_dd = qt.propagate(psi0, H, tlist, method="cheby", fused=True,
                        kernel="dd", workspace=wrk)
    torch.cuda.synchronize()
    counts = dict(cf.LAUNCHES)
    check_launches("dd", counts, "double", n_steps=n)
    err_xla = float((psi_T - p_xla).abs().max())
    err_dd = float((psi_T - p_dd).abs().max())
    if not (err_xla <= 1e-13 and err_dd <= 1e-10):
        raise AssertionError(f"12c forward: vs plain {err_xla}, vs dd "
                             f"{err_dd}")
    del p_dd

    # the target: the state a seeded perturbation of the table reaches
    rng = np.random.default_rng(SEED + 140)
    kick = torch.as_tensor(0.05 * rng.standard_normal(tuple(table0.shape)),
                           device=device)
    with torch.no_grad():
        target, _ = fn(psi0, table0 + kick)

    def infidelity(table):
        psi, _ = fn(psi0, table)
        return 1.0 - torch.vdot(target, psi).abs() ** 2

    def loss_and_grad(table):
        table = table.detach().requires_grad_(True)
        loss = infidelity(table)
        (g,) = torch.autograd.grad(loss, table)
        return float(loss.detach()), g

    # (b) and (d): forward + backward as the loop and through the tape,
    # its time and peak memory
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    ways, (loss0, g) = grad_ways(f"driven chain 2^{L}, {n} intervals",
                                 loss_and_grad, table0, card)
    t_fb, peak = ways["graph first"][0], ways["graph first"][1] * 2.0 ** 30
    fd_errs = []
    base_np = table0.cpu().numpy()
    for idx in [(0, 0), (2, 0), (4, 0)]:
        eps = 1e-6
        tp, tm = base_np.copy(), base_np.copy()
        tp[idx] += eps
        tm[idx] -= eps
        with torch.no_grad():
            fd = (float(infidelity(torch.as_tensor(tp, device=device)))
                  - float(infidelity(torch.as_tensor(tm, device=device)))) \
                / (2 * eps)
        gi = float(g[idx])
        if not abs(gi - fd) <= max(1e-5 * abs(fd), 1e-8):
            raise AssertionError(f"12c gradient at {idx}: {gi} vs finite "
                                 f"difference {fd}")
        fd_errs.append(abs(gi - fd) / abs(fd))

    # (c) three gradient-descent steps, each lowering the infidelity (the
    # last step's loss needs no gradient)
    losses, table = [loss0], table0
    for k in range(3):
        table = (table - 1.0 * g).detach()
        if k < 2:
            loss, g = loss_and_grad(table)
        else:
            with torch.no_grad():
                loss = float(infidelity(table))
        losses.append(loss)
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"12c gradient descent did not lower the "
                             f"infidelity: {losses}")

    # the trajectory cost on <sz_0> through observable_fn (the first
    # propagator's tape, 2^24 stacks, freed first)
    del fn
    gc.collect()
    torch.cuda.empty_cache()
    sz = sz0(L, device)
    fn_obs = make_fused_cheby_propagator(
        psi0, H, tlist, observable_fn=lambda psi: torch.vdot(
            psi, sz.apply(psi)).real, **envelope)
    table = table0.detach().requires_grad_(True)
    vals = fn_obs(psi0, table)[1]
    (g_obs,) = torch.autograd.grad(torch.mean((vals + 1.0) ** 2), table)
    g_norm = float(torch.linalg.vector_norm(g_obs))
    if vals.shape != (n,) or not (bool(torch.isfinite(g_obs).all())
                                  and g_norm > 1e-6):
        raise AssertionError(f"12c trajectory gradient: {g_obs}")

    gib = 2.0 ** 30
    state_gib = psi0.numel() * psi0.element_size() / gib
    reckoned = 15 * (n_orders / 16) * n * state_gib
    log(f"phase 12c gradients L={L} complex128, {n} intervals of the driven "
        f"chain ({n_orders} orders): (a) forward vs phase 3 plain generic "
        f"max|d|={err_xla:.3e} (<= 1e-13), vs kernel=dd {err_dd:.3e} "
        f"(<= 1e-10); (b) infidelity {loss0:.6e}, autograd vs central "
        f"differences (eps=1e-6) rel {max(fd_errs):.2e} (rel 1e-5, abs "
        f"1e-8) at 3 entries; (c) 3 descent steps lowered it: "
        f"{', '.join(f'{x:.6e}' for x in losses)}; trajectory cost on "
        f"<sz_0>: |grad|={g_norm:.3e} finite ok")
    log(f"phase 12c (d) forward {t_fwd:.3f} s, forward + backward "
        f"{t_fb:.3f} s (first graphed call); peak device memory "
        f"{peak / gib:.3f} GiB ({(peak - base) / gib:.3f} GiB above the "
        f"{base / gib:.3f} GiB live before it); reckoned saved tensors 15 "
        f"x {n_orders}/16 x {n} x {state_gib:.3f} GiB = {reckoned:.3f} GiB "
        f"[{card}]")
    # a tape's stacks live as long as its propagator, and as long as an
    # output autograd can still differentiate (vals)
    del fn_obs, vals
    gc.collect()
    torch.cuda.empty_cache()
    grape_grad_ways(device, card)
    chain16_grad_ways(device, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 12c after it: {torch.cuda.memory_allocated() / gib:.3f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / gib:.3f} GiB reserved, "
        f"{graph_pool_gib():.3f} GiB of it in CUDA graph pools")
    return counts


def graph_pool_gib():
    """GiB the caching allocator holds in the private pools of CUDA
    graphs (the scan's one pool per device among them): not released by
    ``empty_cache`` while a graph uses its pool."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) \
        / 2.0 ** 30


def native_phase(device, card, L=L_CHECK, lattice=(4, 5)):
    """Phase 12d: the host assembly library (``native.py``).  The L-site
    chain and the lattice assembled on the host, moved to the card as
    ``CSROperator``s, held against the lattice operators (apply, 1e-12)
    and against the flip-structure ``kernel="dd"`` path (5 Chebyshev
    steps of ``propagate(..., method="cheby")``, 1e-10); the host
    ``csr_spmv`` against the card's apply (1e-12) and
    ``band_partition_remap`` against its numpy path.  Returns the flip
    launches of each dd run."""
    import scipy.sparse as sp

    import quantumpropagators_torch as qt
    from quantumpropagators_torch import native
    from quantumpropagators_torch.models.lattice import (
        chain_bonds, lattice2d_bonds)
    from quantumpropagators_torch.ops import cheby_flip as cf

    if not native.native_available():
        raise AssertionError("native library did not build (g++)")
    Lx, Ly = lattice
    if Lx * Ly != L:
        raise AssertionError(f"lattice {Lx}x{Ly} is not 2^{L}")
    n = 5
    tlist = np.linspace(0.0, n * DT, n + 1)
    N = 2 ** L
    x = random_state(L, torch.complex128, device, SEED + 150)
    x_host = x.cpu().numpy()
    counts, lines = {}, []
    for name, assemble, build in [
        ("chain", lambda: native.tfim_chain_csr(L, J, G_FIELD, H_FIELD),
         lambda: qt.transverse_field_ising(L, J=J, g=G_FIELD, h=H_FIELD,
                                           dtype=torch.complex128,
                                           device=device)),
        (f"lattice {Lx}x{Ly}",
         lambda: native.tfim_lattice2d_csr(Lx, Ly, J, G_FIELD, H_FIELD),
         lambda: qt.transverse_field_ising_2d(Lx, Ly, J=J, g=G_FIELD,
                                              h=H_FIELD,
                                              dtype=torch.complex128,
                                              device=device)),
    ]:
        t0 = time.perf_counter()
        indptr, cols, vals = assemble()
        t_host = time.perf_counter() - t0
        csr = qt.csr_from_scipy(sp.csr_matrix((vals, cols, indptr),
                                              shape=(N, N)), device=device)
        H_diag, H_x = build()
        y = csr.apply(x)
        err_apply = float((y - H_diag.apply(x) - H_x.apply(x)).abs().max())
        t0 = time.perf_counter()
        y_host = native.csr_spmv(indptr, cols, vals, x_host)
        t_spmv = time.perf_counter() - t0
        err_host = float(np.abs(y_host - y.cpu().numpy()).max())
        remap = native.band_partition_remap(indptr, cols, 4)
        remap_np = native._band_partition_remap_np(indptr, cols, 4)
        same_remap = remap[0] == remap_np[0] and (
            remap[1] is None or np.array_equal(remap[1], remap_np[1]))
        card_ms = time_ms(lambda: csr.apply(x), 10)

        n_bonds = len(chain_bonds(L) if name == "chain"
                      else lattice2d_bonds(Lx, Ly))
        bound = n_bonds * J + L * (G_FIELD + H_FIELD)
        envelope = dict(E_min=-bound, E_max=bound,
                        specrange_method="manual")
        out_csr = qt.propagate(x, csr, tlist, method="cheby", **envelope)
        cf.reset_launches()
        out_dd = qt.propagate(x, qt.Operator([H_diag, H_x], np.array([1.0])),
                              tlist, method="cheby", fused=True, kernel="dd",
                              **envelope)
        torch.cuda.synchronize()
        counts[f"phase 12d dd {name}"] = dict(cf.LAUNCHES)
        check_launches("dd", counts[f"phase 12d dd {name}"], "double",
                       n_steps=n)
        err_prop = float((out_csr - out_dd).abs().max())
        if not (err_apply <= 1e-12 and err_host <= 1e-12 and same_remap
                and err_prop <= 1e-10):
            raise AssertionError(f"12d {name}: apply {err_apply}, host "
                                 f"spmv {err_host}, remap {remap[0]} vs "
                                 f"{remap_np[0]}, propagate {err_prop}")
        lines.append(
            f"phase 12d native {name} 2^{L} ({len(vals)} entries): apply "
            f"vs lattice operators max|d|={err_apply:.3e} (<= 1e-12), host "
            f"csr_spmv vs card apply {err_host:.3e} (<= 1e-12), "
            f"band_partition_remap(4) = numpy path (halo {remap[0]}), 5 "
            f"cheby steps on the CSR vs kernel=dd {err_prop:.3e} (<= 1e-10) "
            f"ok; host assembly {t_host:.4f} s (host), host csr_spmv "
            f"{1e3 * t_spmv:.3f} ms (host), card CSR apply {card_ms:.4f} ms "
            f"[{card}]")
        del csr, y, out_csr, out_dd, indptr, cols, vals, y_host
    # a matrix that is banded for the partition: the remap and its halo
    A = sp.diags([np.ones(N - 3), np.ones(N), np.ones(N - 3)], [-3, 0, 3],
                 format="csr")
    w, ext = native.band_partition_remap(A.indptr, A.indices, 4)
    w_np, ext_np = native._band_partition_remap_np(A.indptr, A.indices, 4)
    if not (w == w_np == 3 and np.array_equal(ext, ext_np)):
        raise AssertionError(f"12d remap of a banded matrix: {w} vs {w_np}")
    for line in lines:
        log(line)
    log(f"phase 12d band_partition_remap(4) of a 2^{L} band (offsets "
        f"-3, 0, 3): halo {w} = numpy path ok")
    return counts


def final_slice_phase(device, card, chain, p_xla, pallas_steps_s):
    """Phase 12: the planar path, batching, gradients and the host
    assembly library (12a-12d).  Returns the flip launches of each
    counted path."""
    t_phase = time.perf_counter()
    paths = {"phase 12a pallas (planar reference)": planar_phase(
        device, card, chain[2], pallas_steps_s)}
    gc.collect()
    torch.cuda.empty_cache()
    batched_phase(device, card)
    gc.collect()
    torch.cuda.empty_cache()
    paths["phase 12c dd (gradient reference)"] = gradient_phase(
        device, card, chain, p_xla)
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(native_phase(device, card))
    log(f"phase 12 wall {time.perf_counter() - t_phase:.1f} s")
    return paths


# phase 13: bench_torch.py through its command line, one process a mode:
# (the bench.py function whose JSON line the mode mirrors, arguments,
# extra keys the line must hold besides bench.py's literal ones).  The
# 2^24 modes run without the host oracle (minutes at 2^24), northstar at
# 100 of its 1000 steps.
TRANSMON_KEYS = tuple(f"{m}_{k}" for m in ("cheby", "newton")
                      for k in ("matvecs_per_100_steps", "steps_per_s"))
BENCH_MODES = (  # the longest first
    ("bench_banded20", ("--config", "banded20"), ()),
    ("main", ("--lattice2d", "4x6", "--kernel", "dd", "--steps", "5",
              "--no-oracle"), ()),
    ("bench_northstar", ("--config", "northstar", "--steps", "100",
                         "--no-oracle"), ()),
    ("bench_transmon", ("--config", "transmon"), TRANSMON_KEYS),
    ("main", ("--L", "20", "--kernel", "dd"), ("per_step_error_vs_f64",)),
    ("main", ("--L", "20", "--kernel", "fused"), ()),
    ("main", ("--L", "20", "--kernel", "planar"), ()),
    ("main", ("--L", "20", "--kernel", "complex"), ()),
    ("bench_optomech", ("--config", "optomech"), ()),
    ("bench_newton", ("--config", "newton"), ()),
    ("bench_multiamp", ("--config", "multiamp"), ()),
    ("bench_rabi", ("--config", "rabi"), ()),
)


def bench_py_lines(path):
    """What each function of ``bench.py`` prints, read from its source
    with ``ast`` (``bench.py`` imports jax and is never imported here):
    ``{function: (metric regex, unit, keys, extra keys)}``.  An f-string
    metric's fields match any text; only literal keys are listed (a
    ``**`` entry of a dict adds keys that depend on the run)."""
    import ast
    import re

    out = {}
    for fn in ast.parse(open(path).read()).body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            keys = [k.value if isinstance(k, ast.Constant) else None
                    for k in getattr(node, "keys", ())]
            if not isinstance(node, ast.Dict) or "metric" not in keys:
                continue
            d = dict(zip(keys, node.values))
            m = d["metric"]
            metric = re.escape(m.value) if isinstance(m, ast.Constant) else \
                "".join(re.escape(v.value) if isinstance(v, ast.Constant)
                        else ".+" for v in m.values)
            extra = {k.value for k in d["extra"].keys
                     if isinstance(k, ast.Constant)}
            out[fn.name] = (metric, d["unit"].value,
                            {k for k in keys if k is not None}, extra)
    return out


def _numbers(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _numbers(v)
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield x


def check_bench_line(name, line, expected, also=()):
    """Hold one JSON line of ``bench_torch.py`` against ``bench.py``'s
    line of the function ``name`` (``expected``, from
    :func:`bench_py_lines`): the metric and unit, every key and extra
    key (and the extra keys ``also``), the key ``card``, finite numbers,
    and the mode's accuracy bounds.  Raises ``AssertionError``."""
    import math
    import re

    metric, unit, keys, extra_keys = expected
    missing = (keys | {"card"}) - set(line)
    missing |= {f"extra.{k}" for k in (extra_keys | set(also))
                - set(line["extra"])}
    if missing or not re.fullmatch(metric, line["metric"]) \
            or line["unit"] != unit:
        raise AssertionError(f"{name}: {line['metric']} [{line['unit']}] "
                             f"against {metric} [{unit}], missing {missing}")
    bad = [x for x in _numbers(line) if not math.isfinite(x)]
    if bad:
        raise AssertionError(f"{name}: non-finite numbers {bad}")
    ex = line["extra"]
    bounds = {"per_step_error_vs_f64": 1e-13,   # PERF.md section 2
              "banded_vs_xla_dd_diff": 1e-12,
              "round_trip_2000_step_err": 1e-10}
    for key, limit in bounds.items():
        if key in ex and not ex[key] <= limit:
            raise AssertionError(f"{name}: {key} {ex[key]} > {limit}")
    if name == "bench_transmon":
        counts = [ex[f"{m}_matvecs_per_100_steps"] for m in ("newton", "cheby")]
        if not all(isinstance(c, int) and c > 0 for c in counts):
            raise AssertionError(f"transmon matvec counts {counts}")


def _branches(node):
    """The regexes a string expression of ``scaling.py`` can print: a
    constant, an f-string (its fields match any text) or either branch
    of a conditional expression."""
    import ast
    import re

    if isinstance(node, ast.IfExp):
        return _branches(node.body) + _branches(node.orelse)
    if isinstance(node, ast.Constant):
        return [re.escape(str(node.value))]
    return ["".join(re.escape(v.value) if isinstance(v, ast.Constant)
                    else ".+" for v in node.values)]


def scaling_py_lines(path):
    """What ``scaling.py`` prints, read from its source with ``ast``
    (it imports jax and is never imported here): one entry per dict
    literal with a ``metric`` key, ``(metric regexes, unit regexes,
    pass_criterion regexes or None, keys)``; the strings are
    conditional expressions, so each lists every branch."""
    import ast

    out = []
    for node in ast.walk(ast.parse(open(path).read())):
        if not isinstance(node, ast.Dict):
            continue
        keys = [k.value if isinstance(k, ast.Constant) else None
                for k in node.keys]
        if "metric" not in keys:
            continue
        d = dict(zip(keys, node.values))
        out.append((_branches(d["metric"]), _branches(d["unit"]),
                    _branches(d["pass_criterion"])
                    if "pass_criterion" in d else None,
                    {k for k in keys if k is not None}))
    return out


def check_scaling_line(line, expected, card):
    """Hold one JSON line of ``scaling_torch.py`` against the
    ``scaling.py`` line whose metric it prints (``expected`` from
    :func:`scaling_py_lines`): the unit and pass criterion among that
    line's branches, every key, ``card``, finite positive throughputs;
    a shared-slot line says that it does not measure weak scaling.
    Raises ``AssertionError``."""
    import math
    import re

    match = [e for e in expected
             if any(re.fullmatch(m, line["metric"]) for m in e[0])]
    if len(match) != 1:
        raise AssertionError(f"scaling line metric {line['metric']}")
    _, units, criteria, keys = match[0]
    missing = (keys | {"card"}) - set(line)
    if missing or line["card"] != card \
            or not any(re.fullmatch(u, line["unit"]) for u in units) \
            or (criteria is not None and not any(
                re.fullmatch(c, line["pass_criterion"]) for c in criteria)):
        raise AssertionError(f"scaling line {line['metric']} "
                             f"[{line['unit']}], card {line['card']}, "
                             f"missing {missing}")
    nums = list(_numbers(line))
    rates = [x for t in line["tables"].values() if isinstance(t, dict)
             for x in (r["gnnz_total"] for r in t.values())] \
        if "regime" in line else [line["tables"][k] for k in
                                  ("banded", "allgather", "no_comm")]
    if not all(math.isfinite(x) for x in nums) or not all(
            x > 0 for x in rates):
        raise AssertionError(f"scaling line numbers {nums}")
    if "shared" in line["metric"] and "not weak scaling" not in line["note"]:
        raise AssertionError(f"shared line note: {line['note']}")


def bench_phase(card, workers=4):
    """Phase 13: every mode of ``bench_torch.py`` (the port of
    ``bench.py``) at ``BENCH_MODES``' sizes, each in its own process
    through the command line, ``workers`` processes at a time (a process
    spends most of its time starting up and building its inputs on the
    host); each JSON line held by :func:`check_bench_line`.  A mode that
    exits nonzero fails the phase.  The modes share the card, so their
    rates are not measurements."""
    from concurrent.futures import ThreadPoolExecutor

    root = os.path.dirname(os.path.abspath(__file__))
    expected = bench_py_lines(os.path.join(root, "bench.py"))
    t_phase = time.perf_counter()

    def run(args):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "bench_torch.py"), *args],
            cwd=root, capture_output=True, text=True, timeout=300,
        )
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(workers) as pool:
        futures = [pool.submit(run, args) for _, args, _ in BENCH_MODES]
        runs = [f.result() for f in futures]
    for (name, args, also), (proc, seconds) in zip(BENCH_MODES, runs):
        cmd = " ".join(args)
        if proc.returncode != 0:
            raise AssertionError(f"bench_torch.py {cmd} exited "
                                 f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        check_bench_line(name, line, expected[name], also)
        if line["card"] != card:
            raise AssertionError(f"bench_torch.py {cmd}: card {line['card']}")
        log(f"phase 13 bench_torch.py {cmd}: {line['metric']} [{line['unit']}]"
            f" keys held, extra {json.dumps(line['extra'])} ({seconds:.1f} s, "
            f"{workers} modes at a time) [{card}]")
    log(f"phase 13 wall {time.perf_counter() - t_phase:.1f} s")

# phase 14: the port's entry points.  scaling_torch.py's command lines
# (chain regimes 2^22 -> 2^24, banded 2^18 -> 2^20, banded20's size), each
# alone on the card, after the four examples, EXAMPLE_WORKERS at a time.
SCALING_SIZES = ("--slots", "4", "--L-base", "22", "--R-local", "2048",
                 "--block", "128", "--steps", "5")
SCALING_RUNS = (("--mode", "all"), ("--mode", "banded-vs-ag"))
EXAMPLE_WORKERS = 4
# 4-slot total retention of each regime at SCALING_SIZES while the
# sharded steps ran eagerly (chip runs on an NVIDIA H100 80GB HBM3 at
# 700 W): phase 14 logs the graphed steps' retention beside it
EAGER_RETENTION = {"banded_dd": "1.019-1.044", "hypercube": "0.799-0.816",
                   "hypercube_dd": "0.499-0.702"}


def _example_numbers(name, out):
    """The numbers an example prints, by name (the JAX example's lines)."""
    import re

    def last(pattern):
        found = re.findall(pattern, out)
        if not found:
            raise AssertionError(f"{name}: no line matching {pattern!r}:\n"
                                 f"{out[-2000:]}")
        return found[-1]

    num = r"([-+0-9.e]+)"
    if name == "grape_state_transfer":
        return {"iteration": int(last(r"iter +(\d+) +infidelity")),
                "infidelity": float(last(r"final infidelity: " + num)),
                "area": float(last(r"pulse area: " + num))}
    if name == "krotov_state_transfer":
        return {"iteration": int(last(r"iter +(\d+): fidelity")),
                "fidelity": float(last(r"final fidelity: " + num))}
    if name == "multi_amplitude_dd":
        return {"err": float(last(r"max\|Δ\| = " + num)),
                "norm": float(last(r"‖Ψ‖ = " + num))}
    return {"norm": float(last(r"‖Ψ‖ = " + num))}


def _example_ok(name, v):
    """The values the JAX examples reach (GRAPE stops at iteration 63
    with infidelity 8.396e-09, Krotov at 21 with fidelity 0.99999930)."""
    if name == "grape_state_transfer":
        return (v["iteration"] == 63
                and abs(v["infidelity"] - 8.396e-09) <= 1e-11
                and abs(v["area"] - 1.5707) <= 5e-5)
    if name == "krotov_state_transfer":
        return v["iteration"] == 21 and abs(v["fidelity"] - 0.99999930) <= 1e-8
    if name == "multi_amplitude_dd":
        return v["err"] < 1e-12 and abs(v["norm"] - 1.0) <= 1e-12
    return abs(v["norm"] - 1.0) <= 1e-5


def entry_points_phase(device, card, L=L_MAIN, n_steps=3):
    """Phase 14: (c) the four ``examples/*_torch.py`` as processes,
    ``EXAMPLE_WORKERS`` at a time, held at the numbers the JAX examples
    reach, while (a) runs ``scaling_torch.py``'s hypercube-dd builder in
    this process at L = 24: 4 slots against 1 slot over ``n_steps`` steps
    (≤ 1e-12), its flip launches counted, and one 4-slot step against the
    f64 host oracle (≤ 1e-13, computed in a thread while the rest of the
    phase runs); then (b) ``scaling_torch.py``'s command line, parsed and
    run by its ``main`` in this process (no process start-up), each run
    alone on the card, each printed JSON line held against
    ``scaling.py``'s.  Returns the flip launches of (a)."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    import scaling_torch as st
    from bench_torch import flip_oracle_step
    from quantumpropagators_torch.models.lattice import (chain_bonds,
                                                         ising_diagonal_np)
    from quantumpropagators_torch.ops import cheby_flip as cf
    from quantumpropagators_torch.ops.cheby import cheby_coeffs

    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()

    def run(script):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, script], cwd=root,
                              capture_output=True, text=True, timeout=400)
        if proc.returncode != 0:
            raise AssertionError(f"{script} exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        return proc.stdout, time.perf_counter() - t0

    # -- (c) the examples, started first -----------------------------------
    names = ("grape_state_transfer", "krotov_state_transfer",
             "multi_amplitude_dd", "sharded_spin_chain")
    pool = ThreadPoolExecutor(EXAMPLE_WORKERS)
    examples = [pool.submit(run, os.path.join("examples", f"{n}_torch.py"))
                for n in names]

    # -- (a) hypercube-dd, 4 slots against 1 and against the host oracle --
    dt = 0.05  # scaling.py's default
    p4 = st.build_hypercube_dd(4, L, dt, device=device)
    psi0 = p4.state.reshape(-1).cpu().numpy()
    one = p4.step(p4.state).reshape(-1).cpu().numpy()
    e_min, delta = st._chain_envelope(L)
    oracle_pool = ThreadPoolExecutor(1)
    oracle = oracle_pool.submit(
        flip_oracle_step, psi0, ising_diagonal_np(L, chain_bonds(L), st.J,
                                                  st.H_FIELD),
        st.G, L, cheby_coeffs(delta, dt), delta, e_min, dt)
    cf.reset_launches()
    state = p4.state
    for _ in range(n_steps):
        state = p4.step(state)
    torch.cuda.synchronize()
    counts = dict(cf.LAUNCHES)
    check_launches("dd", counts, "double", n_steps=n_steps * 4)
    p1 = st.build_hypercube_dd(1, L, dt, device=device)
    ref = p1.state
    for _ in range(n_steps):
        ref = p1.step(ref)
    err = float((state.reshape(-1) - ref.reshape(-1)).abs().max())
    if not err <= 1e-12:
        raise AssertionError(f"14a hypercube-dd 4 slots vs 1: {err}")
    del p4, p1, state, ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 14a scaling_torch hypercube-dd L={L} 4 slots {n_steps} "
        f"steps: max|d| vs 1 slot={err:.3e} (<= 1e-12), flip launches "
        f"{sum(counts.values())} ok")

    for name, future in zip(names, examples):
        out, seconds = future.result()
        values = _example_numbers(name, out)
        if not _example_ok(name, values):
            raise AssertionError(f"examples/{name}_torch.py: {values}")
        log(f"phase 14c examples/{name}_torch.py: {values} ({seconds:.1f} s, "
            f"{EXAMPLE_WORKERS} at a time, beside 14a) [{card}]")
    pool.shutdown()

    # -- (b) the scaling command lines, each alone on the card -------------
    expected = scaling_py_lines(os.path.join(root, "scaling.py"))
    for args in SCALING_RUNS:
        cmd = " ".join((*args, *SCALING_SIZES))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            st.main([*args, *SCALING_SIZES])
        seconds = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        check_scaling_line(line, expected, card)
        if "regime" in line and not all(
                sorted(t) == ["1", "2", "4"] for t in line["tables"].values()):
            raise AssertionError(f"scaling tables {line['tables']}")
        log(f"phase 14b scaling_torch.py {cmd}: {json.dumps(line)} "
            f"({seconds:.1f} s) [{card}]")
        for regime, table in (line["tables"].items()
                              if "regime" in line else ()):
            log(f"phase 14b {regime} total retention at 4 slots "
                f"{table['4']['total_retention']:.3f} with graphed steps "
                f"(eager steps: {EAGER_RETENTION[regime]}) [{card}]")

    t0 = time.perf_counter()
    err_o = float(np.abs(one - oracle.result()).max())
    oracle_pool.shutdown()
    if not err_o <= 1e-13:
        raise AssertionError(f"14a hypercube-dd 4 slots vs f64 oracle: "
                             f"{err_o}")
    log(f"phase 14a hypercube-dd L={L} 4 slots, one step: max|d| vs f64 host "
        f"oracle={err_o:.3e} (<= 1e-13; waited {time.perf_counter() - t0:.1f}"
        f" s for the oracle)")
    log(f"phase 14 wall {time.perf_counter() - t_phase:.1f} s")
    return counts


class ScanRecorder:
    """While active, records the ``(step, carry, xs, length)`` of every
    scan that ``fused.py`` and ``ops/newton_leja.py`` start (and runs
    it), so that phase 15 can run a path's own step both ways."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from quantumpropagators_torch import fused
        from quantumpropagators_torch.ops import newton_leja
        from quantumpropagators_torch.utils import scan as sc

        self.mods = (fused, newton_leja)

        def recorded(step, carry, xs=None, length=None):
            self.calls.append((step, carry, xs, length))
            return sc.scan(step, carry, xs, length)

        for mod in self.mods:
            mod.scan = recorded
        return self

    def __exit__(self, *exc):
        from quantumpropagators_torch.utils import scan as sc

        for mod in self.mods:
            mod.scan = sc.scan


def _launch_counts():
    from quantumpropagators_torch.ops import banded_spmv as bs
    from quantumpropagators_torch.ops import cheby_flip as cf

    return {**cf.LAUNCHES, **bs.LAUNCHES}


def _reset_launches():
    from quantumpropagators_torch.ops import banded_spmv as bs
    from quantumpropagators_torch.ops import cheby_flip as cf

    cf.reset_launches()
    bs.reset_launches()


def _max_diff(a, b):
    """max|a − b| over the tensors of two scan results (carry, ys)."""
    from quantumpropagators_torch.utils.scan import _leaves

    la, lb = _leaves(a), _leaves(b)
    if [t.shape for t in la] != [t.shape for t in lb]:
        raise AssertionError(f"graph and eager shapes differ: "
                             f"{[t.shape for t in la]}, "
                             f"{[t.shape for t in lb]}")
    return max(float((x - y).abs().max()) for x, y in zip(la, lb))


def graph_vs_eager(label, step, carry, xs, n, card, paths, tol=0.0):
    """One routed path both ways: the eager loop of ``step`` and its
    :class:`GraphedScan` (the first call captures after one eager
    interval, as every routed scan does; the second replays all ``n``
    intervals).  Holds both graph results against the eager one (max|Δ|
    ≤ ``tol``) and the launches a step equal; prints steps/s and host µs
    a step both ways (host: until the call returns, before the
    synchronize), the peak reserved GiB over the two graph calls, and
    the carry copies a replay makes, which must be 0
    (every routed step writes its carry into the scan's ``out``, two
    graphs in turn).  Records the first graph call's launches in
    ``paths``; returns ``(graph steps/s, eager steps/s, host µs)``."""
    from quantumpropagators_torch.utils.scan import GraphedScan, _loop

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return out, t_host, time.perf_counter() - t0

    _reset_launches()
    eager, _, _ = timed(lambda: _loop(step, carry, xs, n))
    n_eager = _launch_counts()
    _, host_e, wall_e = timed(lambda: _loop(step, carry, xs, n))
    graphed = GraphedScan(step)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    first, _, wall_c = timed(lambda: graphed(carry, xs, n))
    n_graph = _launch_counts()
    second, host_g, wall_g = timed(lambda: graphed(carry, xs, n))
    peak = torch.cuda.max_memory_reserved() / 2 ** 30
    copies = graphed._graph.carry_copies
    err = max(_max_diff(first, eager), _max_diff(second, eager))
    per_e = {k: v / n for k, v in n_eager.items() if v}
    per_g = {k: v / n for k, v in n_graph.items() if v}
    if not err <= tol or per_e != per_g or copies != 0:
        raise AssertionError(f"phase 15 {label}: graph vs eager max|d| "
                             f"{err} (<= {tol}), launches/step graph "
                             f"{per_g}, eager {per_e}, carry copies a "
                             f"replay {copies} (must be 0)")
    paths[f"phase 15 {label} graph"] = n_graph
    log(f"phase 15 {label} {n} steps: graph vs eager max|d|={err:.3e} "
        f"(<= {tol:g}), launches/step equal {per_g}, carry copies a "
        f"replay {copies} ({len(graphed._graph.graphs)} graphs), peak "
        f"reserved {peak:.3f} GiB over both graph calls; graph "
        f"{n / wall_g:.3f} steps/s (host {1e6 * host_g / n:.1f} us/step, "
        f"first call with the capture {wall_c:.3f} s), eager "
        f"{n / wall_e:.3f} steps/s (host {1e6 * host_e / n:.1f} us/step) "
        f"[{card}]")
    del graphed, first, second, eager
    return n / wall_g, n / wall_e, 1e6 * host_g / n


def hold_graphed(label, step, state, call, n, renew, card):
    """One graphed sharded site (a fresh :class:`Graphed` step) both
    ways over ``n`` calls: ``call(k, prev) -> (args, kwargs)`` builds
    call ``k`` from the output before it (``state`` for the first), and
    ``renew(args, kwargs)`` a call of the same inputs with a new
    operator.  After one warm-up call (the capture), the ``n`` graphed
    calls and the ``n`` calls of ``step.body`` must agree bit for bit
    output by output and issue the same kernel launches; a graphed call
    on the body's first output must equal the body's second; all of it
    leaves one capture, and the renewed call must agree too and add one
    capture.
    Returns the graphed calls' launches, steps/s both ways and host µs a
    call both ways (host: until the last call returns, before the
    synchronize)."""
    from quantumpropagators_torch.utils.scan import _leaves

    def run(fn):
        outs, prev = [], state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(n):
            args, kwargs = call(k, prev)
            prev = fn(*args, **kwargs)
            outs.append(prev)
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return outs, t_host, time.perf_counter() - t0

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))

    captures = step.captures
    args, kwargs = call(0, state)
    step(*args, **kwargs)
    _reset_launches()
    graph, host_g, wall_g = run(step)
    n_graph = _launch_counts()
    _reset_launches()
    eager, host_e, wall_e = run(step.body)
    n_eager = _launch_counts()
    same = all(equal(g, e) for g, e in zip(graph, eager))
    err = max(_max_diff(g, e) for g, e in zip(graph, eager))
    # the body's own output as the next input (a view, as the f32
    # step's planes are) replays the same graph
    args, kwargs = call(1, eager[0])
    same = same and equal(step(*args, **kwargs), eager[1])
    del graph, eager
    once = step.captures - captures
    args, kwargs = renew(*call(0, state))
    same_new = equal(step(*args, **kwargs), step.body(*args, **kwargs))
    again = step.captures - captures
    if not (same and same_new and n_graph == n_eager and once == 1
            and again == 2):
        raise AssertionError(
            f"phase 17 {label}: graph vs eager equal {same} (max|d| {err}), "
            f"new operator equal {same_new}, launches graph {n_graph} eager "
            f"{n_eager}, captures {once} then {again}")
    per_call = {k: v / n for k, v in n_graph.items() if v}
    log(f"phase 17 {label} {n} calls: graphed vs eager max|d|={err:.3e} "
        f"(= 0, bit for bit), launches/call equal {per_call}, 1 capture, "
        f"1 more for a new operator; graphed {n / wall_g:.3f} steps/s "
        f"(host {1e6 * host_g / n:.1f} us/call), eager {n / wall_e:.3f} "
        f"steps/s (host {1e6 * host_e / n:.1f} us/call) [{card}]")
    return {"launches": n_graph, "graph": n / wall_g, "eager": n / wall_e,
            "host_graph_us": 1e6 * host_g / n,
            "host_eager_us": 1e6 * host_e / n}


class _CountedReplays:
    """Counts ``torch.cuda.CUDAGraph.replay`` calls and the calls of a
    :class:`Graphed` step's body (its own and its autograd key's) while
    it is entered."""

    def __init__(self, step):
        self.step, self.replays, self.bodies = step, 0, 0
        self.holders = [h for h in (step, step._grad) if h is not None]

    def __enter__(self):
        self._replay, body = torch.cuda.CUDAGraph.replay, self.step.body
        replay = self._replay

        def counted_replay(graph):
            self.replays += 1
            return replay(graph)

        def counted_body(*args, **kwargs):
            self.bodies += 1
            return body(*args, **kwargs)

        torch.cuda.CUDAGraph.replay = counted_replay
        for holder in self.holders:
            holder.body = counted_body
        self._body = body
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.replay = self._replay
        for holder in self.holders:
            holder.body = self._body


def hold_graphed_grad(label, step, inputs, call, n, card, tols=None,
                      reps=3):
    """One differentiable graphed sharded site (a fresh :class:`Graphed`
    step) under autograd, against its body: ``inputs`` the tensors to
    differentiate (the state first), ``call(fn, state, ins)`` one call
    of ``fn`` (the step or its body); the loss is ``Σ w |out|²`` (seeded
    weights) of ``n`` chained calls and one backward.  The body's loop
    runs first, timed ``reps`` times (forward + backward); then the
    graphed calls: the first (eager, then the forward's and the VJP's
    captures: 2), and ``reps`` steady runs, each of which must capture
    nothing, replay 2 graphs a call (F and B), run the body never, and
    give each gradient equal to the loop's (``tols[i]`` > 0: within
    that relative error).  Prints seconds a steady run both ways, the
    captures, the kernel launches and graph replays a call, peak
    reserved (and allocated) GiB both ways and of the first graphed run,
    each measured from an emptied cache, and max|Δ| of the gradients;
    returns them."""
    tols = tols or [0.0] * len(inputs)
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    g = torch.Generator(device=ins[0].device)
    g.manual_seed(SEED + 230)
    w = torch.rand(ins[0].shape, generator=g, device=ins[0].device,
                   dtype=torch.float64) + 0.5

    def run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ins[0]
        for _ in range(n):
            out = call(fn, out, ins)
        loss = (w * (out.real ** 2 + out.imag ** 2)).sum()
        grads = torch.autograd.grad(loss, ins)
        torch.cuda.synchronize()
        return grads, time.perf_counter() - t0

    def peak_of(fn, runs=reps):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        got, times = [], []
        for _ in range(runs):
            grads, t = fn()
            got.append(grads)
            times.append(t)
        return got, times, (torch.cuda.max_memory_reserved() / 2 ** 30,
                            torch.cuda.max_memory_allocated() / 2 ** 30)

    (*_, eager), t_eager, peak_e = peak_of(lambda: run(step.body))
    _reset_launches()
    captures = step.captures
    (first,), (t_first,), peak_first = peak_of(lambda: run(step), 1)
    n_first = step.captures - captures
    _reset_launches()
    with _CountedReplays(step) as counted:
        (*_, graph), t_graph, peak_g = peak_of(lambda: run(step))
    n_graph = _launch_counts()

    def agree(got):
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, eager)]
        return errs, all(torch.equal(a, b) if tol == 0 else err <= tol
                         for a, b, tol, err in zip(got, eager, tols, errs))

    errs_first, same_first = agree(first)
    errs, same = agree(graph)
    steady = step.captures - captures - n_first
    per_call = {k: v / (reps * n) for k, v in n_graph.items() if v}
    replays = counted.replays / (reps * n)
    if not (same and same_first and n_first == 2 and steady == 0
            and replays == 2 and counted.bodies == 0):
        raise AssertionError(
            f"phase 17 grad {label}: gradients equal {same} (relative "
            f"errors {errs}, tolerances {tols}), first call equal "
            f"{same_first} ({errs_first}), captures {n_first} then "
            f"{steady}, replays a call {replays}, body calls "
            f"{counted.bodies}")
    te, tg = min(t_eager), min(t_graph)
    log(f"phase 17 grad {label}, {n} chained calls + 1 backward: graphed "
        f"{tg:.4f} s against eager {te:.4f} s ({te / tg:.2f}x; first "
        f"graphed run with its 2 captures {t_first:.3f} s), gradients "
        f"max relative |d| {max(errs):.3e} (tolerances {tols}), 2 "
        f"captures then 0, {replays:g} graph replays and launches "
        f"{per_call} a call, body never called, peak reserved "
        f"(allocated) {peak_g[0]:.3f} ({peak_g[1]:.3f}) GiB graphed, first "
        f"run {peak_first[0]:.3f} ({peak_first[1]:.3f}), eager "
        f"{peak_e[0]:.3f} ({peak_e[1]:.3f}) [{card}]")
    return {"graph_s": tg, "eager_s": te, "peak_graph": peak_g,
            "peak_first": peak_first, "peak_eager": peak_e,
            "err": max(errs), "launches": n_graph}


GRAD_SITES = ("chain step", "BSR step", "BSR dd step", "BSR halo apply",
              "BSR all-gather apply", "CSR all-gather apply",
              "CSR halo apply")


def grad_tols(name, n):
    """:func:`hold_graphed_grad`'s tolerances of a site's gradients over
    ``n`` chained calls: 0 (bit for bit) but for the CSR applies (the
    backward of their gather adds with atomics, in an order that varies)
    and, over chained calls, the chain's amplitude (each call's sum,
    then the sum over calls, where the loop keeps one running sum)."""
    if name.startswith("CSR"):
        return [1e-14]
    if name == "chain step":
        return [0.0, 0.0, 1e-12 if n > 1 else 0.0]
    return None


def grad_sites(mesh, device, L, A, *, banded=None, names=GRAD_SITES):
    """The differentiable graphed sites of ``parallel/`` for
    :func:`hold_graphed_grad`: name -> ``(step, inputs, call)``.  The
    chain step over ``sharded_apply`` on the L-site TFIM chain
    (gradients with respect to the state, a tensor of Chebyshev
    coefficients and the operator's amplitude, a 1-entry tensor read in
    place); the BSR complex and dd steps (state, coefficients) and the
    BSR and CSR applies (state) on the real banded matrix ``A`` (scipy,
    blocks of 64) or, for the steps, on ``banded = (partition, delta,
    e_min, dt)``."""
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.ops.cheby import cheby_coeffs
    from quantumpropagators_torch.parallel import sharded_bsr as sbsr
    from quantumpropagators_torch.parallel import sharded_chain as sch
    from quantumpropagators_torch.parallel import sharded_csr as scsr

    n = mesh.n_devices
    sites = {}
    if "chain step" in names:
        H_diag, H_x = qt.transverse_field_ising(
            L, J=J, g=G_FIELD, h=H_FIELD, dtype=torch.float64,
            device=device)
        amp = torch.ones(1, dtype=torch.float64, device=device)
        op = sch.prepare_sharded_operator(qt.Operator([H_diag, H_x], amp), n)
        bound = (L - 1) * J + L * (G_FIELD + H_FIELD)
        step = sch.make_sharded_cheby_step(mesh, op, delta=2 * bound,
                                           e_min=-bound, dt=DT)
        cc = torch.as_tensor(cheby_coeffs(2 * bound, DT), device=device)
        sites["chain step"] = (
            step, [random_state(L, torch.complex128, device, SEED + 240), cc,
                   amp],
            lambda fn, v, ins, op=op: fn(qt.Operator(op.ops, ins[2]), v,
                                         ins[1]))
    def state(N):
        return random_state(N.bit_length() - 1, torch.complex128, device,
                            SEED + 250)

    if {"BSR step", "BSR dd step"} & set(names):
        if banded is None:
            bound = float(np.abs(A).sum(axis=1).max())
            banded = (sbsr.partition_bsr(A, n, block_size=64,
                                         device=device),
                      2 * bound, -bound, DT)
        part, delta, e_min, dt = banded
        cb = torch.as_tensor(cheby_coeffs(delta, dt),
                             device=device)
        kw = dict(delta=delta, e_min=e_min, dt=dt)
    for name, make in (("BSR step", sbsr.make_sharded_bsr_cheby_step),
                       ("BSR dd step", sbsr.make_sharded_bsr_cheby_step_dd)):
        if name in names:
            sites[name] = (make(mesh, part, **kw), [state(part.shape[0]), cb],
                           lambda fn, v, ins, part=part: fn(part, v, ins[1]))
    for name, partition, make in (
            ("BSR halo apply", lambda: sbsr.partition_bsr(
                A, n, block_size=64, device=device),
             sbsr.make_banded_bsr_apply),
            ("BSR all-gather apply", lambda: sbsr.partition_bsr(
                A, n, block_size=64, mode="allgather", device=device),
             sbsr.make_allgather_bsr_apply),
            ("CSR all-gather apply", lambda: scsr.partition_csr_rows(
                A, n, device=device), scsr.make_allgather_csr_apply),
            ("CSR halo apply", lambda: scsr.partition_csr_banded(
                A, n, device=device), scsr.make_banded_csr_apply)):
        if name in names:
            q = partition()
            sites[name] = (make(mesh, q), [state(A.shape[0])],
                           lambda fn, v, ins, q=q: fn(q, v))
    return sites


def _renew_first(args, kwargs):
    """The same call with a copy of its first argument (the operator
    tensor): a new address, so a new capture."""
    return (args[0].clone(),) + tuple(args[1:]), kwargs


def _renew_field(field):
    """The same call with the first argument (a partition) holding a copy
    of its tensor ``field``."""
    from dataclasses import replace

    def renew(args, kwargs):
        part = args[0]
        new = replace(part, **{field: getattr(part, field).clone()})
        return (new,) + tuple(args[1:]), kwargs

    return renew


def sharded_graph_phase(device, card, chain, ctx, group):
    """Phase 17: every sharded step of ``parallel/`` as one replayed CUDA
    graph a call (``utils/scan.graphed``), on 4 slots of this card over
    phase 10's world-size-1 NCCL group, each held against its own body
    run eagerly (:func:`hold_graphed`): the L = 24 chain in both tiers
    with a per-bit (dd) or 0-d (f32) tensor flip scale and with a Python
    float, changing every call; banded20 through
    ``make_sharded_dd_cheby_step``; the BSR complex (tensor coefficients
    on the card) and dd steps on banded20's partition; the chain step
    over ``sharded_apply`` at L = 24 (tensor coefficients); the BSR and
    CSR applies at phase 10's small sizes.  Then traces of 3 dd chain
    steps graphed and eager.  Under autograd (:func:`hold_graphed_grad`,
    the forward graph and the graph of its VJP against the body's loop
    and its backward): the dd chain step raises naming its kernel; the
    BSR complex and dd steps on banded20's partition (every
    coefficient) and the L = 24 chain step,
    ``GRAD_CALLS`` chained calls; every differentiable site at 2^14
    slots-in-all, ``GRAD_CALLS_SMALL``.  Returns the graphed runs'
    launches by path."""
    import scipy.sparse as sp

    import quantumpropagators_torch as qt
    from quantumpropagators_torch.models.generators import (
        coeff_table, coeff_table_np)
    from quantumpropagators_torch.ops.cheby import cheby_coeffs
    from quantumpropagators_torch.ops.fused_cheby_dd import f32_tail_orders
    from quantumpropagators_torch.ops.operators import DiagonalOperator
    from quantumpropagators_torch.parallel import sharded_banded as sbd
    from quantumpropagators_torch.parallel import sharded_bsr as sbsr
    from quantumpropagators_torch.parallel import sharded_chain as sch
    from quantumpropagators_torch.parallel import sharded_csr as scsr
    from quantumpropagators_torch.parallel import sharded_fused as sf
    from quantumpropagators_torch.parallel.mesh import (chain_mesh,
                                                        replicate,
                                                        shard_vector)

    t_phase = time.perf_counter()
    mesh = chain_mesh(4, group=group, device=device)
    paths, rates, grads = {}, {}, {}

    def hold(label, step, state, call, renew, n=N_STEPS):
        rates[label] = r = hold_graphed(label, step, state, call, n, renew,
                                        card)
        paths[f"phase 17 {label} graph"] = r["launches"]

    # -- the L = 24 chain, both tiers ---------------------------------------
    psi0, H, wrk = chain
    L = L_MAIN
    tlist = np.linspace(0.0, N_STEPS * DT, N_STEPS + 1)
    diag = H.ops[0].diag.real.to(torch.float64)
    beta = wrk.delta / 2.0 + wrk.e_min
    c64 = np.asarray(wrk.coeffs, dtype=np.float64)
    tail = f32_tail_orders(c64)
    drive = np.asarray(coeff_table_np(H, tlist))[:, 0]
    Gbits = torch.as_tensor(np.outer(drive, np.full(L, G_FIELD)),
                            device=device)
    kw = dict(delta=wrk.delta, e_min=wrk.e_min, dt=wrk.dt)
    dmb = shard_vector(mesh, diag - beta)
    psi_sh = shard_vector(mesh, psi0)
    step_dd = sf.make_sharded_fused_cheby_step_dd(mesh, L, 1.0,
                                                  f32_tail=tail, **kw)
    hold(f"sharded dd L={L} per-bit tensor flip_scale", step_dd, psi_sh,
         lambda k, st: ((dmb, st, c64), {"flip_scale": Gbits[k]}),
         _renew_first)
    # under autograd a kernel-bodied site raises naming its kernel (it
    # has no backward, as jax.grad has no transpose of a pallas_call)
    leaf = psi_sh.clone().requires_grad_(True)
    try:
        step_dd(dmb, leaf, c64, flip_scale=Gbits[0])
    except RuntimeError as exc:
        if "cheby_flip" not in str(exc) or "no backward" not in str(exc):
            raise
        log(f"phase 17 sharded dd L={L} under autograd raises: {exc}")
    else:
        raise AssertionError("phase 17: the dd step under autograd returned "
                             "a result cut from the autograd graph")
    del leaf
    step_f = sf.make_sharded_fused_cheby_step_dd(mesh, L, G_FIELD,
                                                 f32_tail=tail, **kw)
    scales = [float(x) for x in drive]
    hold(f"sharded dd L={L} Python float flip_scale", step_f, psi_sh,
         lambda k, st: ((dmb, st, c64), {"flip_scale": scales[k]}),
         _renew_first)
    del step_f
    table = coeff_table(H, tlist)
    table = (table.real if table.is_complex() else table).to(
        device, torch.float32)[:, 0]
    d32 = shard_vector(mesh, diag)
    p32 = psi0.to(torch.complex64)
    ri = (shard_vector(mesh, p32.real.contiguous()),
          shard_vector(mesh, p32.imag.contiguous()))
    for how, scale in (("0-d tensor", lambda k: table[k]),
                       ("Python float", lambda k: float(drive[k]))):
        hold(f"sharded f32 L={L} {how} flip_scale",
             sf.make_sharded_fused_cheby_step(mesh, L, G_FIELD, **kw), ri,
             lambda k, st: ((d32, *st, c64), {"flip_scale": scale(k)}),
             _renew_first)
    del d32, p32, ri

    # traces: 3 steps of the 4-slot dd chain, graphed and eager
    busy = {}
    for how, fn in (("graphed", step_dd), ("eager", step_dd.body)):
        def run(fn=fn):
            st = psi_sh
            for k in range(3):
                st = fn(dmb, st, c64, flip_scale=Gbits[k])
            return st

        *_, busy[how] = trace_steps(run, f"phase 17 trace {how} sharded dd "
                                    f"L={L} 4 slots", 3, card, top=6)
    del step_dd, dmb, psi_sh
    gc.collect()
    torch.cuda.empty_cache()

    # -- banded20: the banded step, the BSR complex and dd steps -----------
    bw = ctx["wrk"]
    bkw = dict(delta=bw.delta, e_min=bw.e_min, dt=bw.dt)
    cb = np.asarray(bw.coeffs, dtype=np.float64)
    x20 = shard_vector(mesh, ctx["psi0"])
    pb, step_b, kind = sbd.make_sharded_dd_cheby_step(
        mesh, ctx["banded"], 4, tile_rows=8, **bkw)
    if kind != "banded_pallas":
        raise AssertionError(f"phase 17 banded20 kind {kind}")
    hold(f"sharded banded20 2^{N_BANDED.bit_length() - 1}", step_b, x20,
         lambda k, st: ((pb, st, cb), {}), _renew_field("edge_left"))
    del pb, step_b
    gc.collect()
    torch.cuda.empty_cache()
    pbsr = sbsr.partition_bsr(ctx["op"], 4, mode="banded", device=device)
    cb_card = replicate(mesh, torch.as_tensor(cb))
    hold("sharded BSR complex banded20 (coefficients on the card)",
         sbsr.make_sharded_bsr_cheby_step(mesh, pbsr, **bkw), x20,
         lambda k, st: ((pbsr, st, cb_card), {}), _renew_field("cols"))
    hold("sharded BSR dd banded20 (host coefficients)",
         sbsr.make_sharded_bsr_cheby_step_dd(mesh, pbsr, **bkw), x20,
         lambda k, st: ((pbsr, st, cb), {}), _renew_field("cols"))
    del x20
    # under autograd, every coefficient
    for name, (step, inputs, call) in grad_sites(
            mesh, device, L, None, banded=(pbsr, bw.delta, bw.e_min, bw.dt),
            names=("BSR step", "BSR dd step")).items():
        grads[name] = hold_graphed_grad(
            f"sharded {name} banded20 ({len(cb)} coefficients)", step,
            inputs, call, GRAD_CALLS, card,
            grad_tols(name, GRAD_CALLS))
    del pbsr, step, inputs, call
    gc.collect()
    torch.cuda.empty_cache()

    # -- the chain step over sharded_apply at L = 24 -----------------------
    H_diag, H_x = qt.transverse_field_ising(L, J=J, g=G_FIELD, h=H_FIELD,
                                            dtype=torch.float64,
                                            device=device)
    op = sch.prepare_sharded_operator(qt.Operator([H_diag, H_x], [1.0]), 4)
    bound = (L - 1) * J + L * (G_FIELD + H_FIELD)
    cc = replicate(mesh, torch.as_tensor(cheby_coeffs(2 * bound, DT)))

    def renew_op(args, kwargs):
        o = args[0]
        new = qt.Operator([DiagonalOperator(o.ops[0].diag.clone()),
                           *o.ops[1:]], o.coeffs)
        return (new,) + tuple(args[1:]), kwargs

    hold(f"sharded chain step L={L} (coefficients on the card)",
         sch.make_sharded_cheby_step(mesh, op, delta=2 * bound,
                                     e_min=-bound, dt=DT), psi0,
         lambda k, st: ((op, st, cc), {}), renew_op)
    del op, H_diag, H_x
    gc.collect()
    torch.cuda.empty_cache()
    (step, inputs, call), = grad_sites(mesh, device, L, None,
                                       names=("chain step",)).values()
    grads["chain step"] = hold_graphed_grad(
        f"sharded chain step L={L} (amplitude read in place)", step, inputs,
        call, GRAD_CALLS, card, grad_tols("chain step", GRAD_CALLS))
    del step, inputs, call
    gc.collect()
    torch.cuda.empty_cache()

    # -- the BSR and CSR applies at phase 10's small sizes ------------------
    rng = np.random.default_rng(SEED + 91)
    N, w = 2 ** 14, 24
    A = sp.diags([rng.standard_normal(N - abs(k)) for k in range(-w, w + 1)],
                 list(range(-w, w + 1))).tocsr()
    A = (0.5 * (A + A.T)).tocsr()
    xs = [random_state(14, torch.complex128, device, SEED + 170 + k)
          for k in range(N_STEPS)]
    for label, part, make, field in (
            ("BSR halo apply", sbsr.partition_bsr(A, 4, block_size=64,
                                                  device=device),
             sbsr.make_banded_bsr_apply, "cols"),
            ("BSR all-gather apply",
             sbsr.partition_bsr(A, 4, block_size=64, mode="allgather",
                                device=device),
             sbsr.make_allgather_bsr_apply, "cols"),
            ("CSR all-gather apply",
             scsr.partition_csr_rows(A, 4, device=device),
             scsr.make_allgather_csr_apply, "data"),
            ("CSR halo apply", scsr.partition_csr_banded(A, 4, device=device),
             scsr.make_banded_csr_apply, "data")):
        hold(f"sharded {label} 2^14", make(mesh, part), xs[0],
             lambda k, _, part=part: ((part, xs[k]), {}), _renew_field(field))
    del xs
    gc.collect()
    torch.cuda.empty_cache()

    # -- every differentiable site under autograd at 2^14 slots-in-all ------
    for name, (step, inputs, call) in grad_sites(mesh, device, 14,
                                                 A).items():
        grads[name, 14] = hold_graphed_grad(
            f"sharded {name} 2^14", step, inputs, call, GRAD_CALLS_SMALL,
            card, grad_tols(name, GRAD_CALLS_SMALL))
    del step, inputs, call
    for name, r in grads.items():
        label = name if isinstance(name, str) else f"{name[0]} 2^14"
        log(f"phase 17 grad summary {label}: graphed {r['graph_s']:.4f} s "
            f"/ eager {r['eager_s']:.4f} s = "
            f"{r['graph_s'] / r['eager_s']:.3f}, peak reserved "
            f"{r['peak_graph'][0]:.3f} (first run {r['peak_first'][0]:.3f}) "
            f"/ {r['peak_eager'][0]:.3f} GiB, allocated "
            f"{r['peak_graph'][1]:.3f} ({r['peak_first'][1]:.3f}) / "
            f"{r['peak_eager'][1]:.3f} GiB [{card}]")

    g, e = (rates[f"sharded dd L={L} per-bit tensor flip_scale"][k]
            for k in ("graph", "eager"))
    log(f"phase 17 4-slot dd chain L={L}: graphed {g:.3f} against eager "
        f"{e:.3f} steps/s ({100 * (g / e - 1):+.2f} %), device busy "
        f"{100 * busy['graphed']:.2f} % graphed against "
        f"{100 * busy['eager']:.2f} % eager [{card}]")
    log(f"phase 17 wall {time.perf_counter() - t_phase:.1f} s")
    return paths


def graph_phase(device, card, chain, ctx):
    """Phase 15: the fused layer's one-program scan.  Each routed path's
    own step (recorded from its entry point) runs as the eager loop and
    as its two replayed CUDA graphs, with no carry copy
    (:func:`graph_vs_eager`): the L = 24 dd and f32 main path (20 steps,
    with observables), ``bench_torch.py``'s 2^20 dd chain, the 2^20
    chain through the flip kernel in complex128 (``kernel="pallas"``)
    and the generic path (``kernel="xla"``), multiamp at 2^20, banded20
    dd, a static 2^14 operator with couplings at 17 block distances
    (the blocked-ELL product) and fixed-Leja Newton on banded20; then
    ``torch.profiler`` traces of 5 dd steps at 2^20 and 2^24 both ways
    (busy share), ``make_fused_cheby_propagator`` on three tables
    against the eager loop with its capture count, and an observable
    that reads the host, which must raise at capture.  Returns the graph
    runs' launches by path and the summary numbers."""
    import scipy.sparse as sp

    import bench_torch
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.fused import (cheby_propagate_fused,
                                                make_fused_cheby_propagator)
    from quantumpropagators_torch.ops.cheby import ChebyWorkspace
    from quantumpropagators_torch.utils.scan import (GraphedScan, _length,
                                                     _loop)

    t_phase = time.perf_counter()
    paths, summary = {}, {}
    psi0, H, wrk = chain
    tlist = np.linspace(0.0, N_STEPS * DT, N_STEPS + 1)
    obs = (sz0(L_MAIN, device), lambda psi: torch.linalg.vector_norm(psi))
    _, H20 = tfim_generator(L_CHECK, device)
    bound20 = J * (L_CHECK - 1) + H_FIELD * L_CHECK + G_FIELD * L_CHECK
    env20 = dict(specrange_method="manual", E_min=-bound20, E_max=bound20)
    psi_c = random_state(L_CHECK, torch.complex128, device, SEED + 150)
    # couplings at 17 block distances (more than the band planes' 9): the
    # static path's blocked-ELL product, 9 blocks in the widest row
    rng = np.random.default_rng(SEED + 155)
    n_ell = 2 ** 14
    A = sp.diags([rng.standard_normal(n_ell - abs(k)) for k in (-2, -1, 0,
                                                                1, 2)],
                 [-2, -1, 0, 1, 2]).tolil()
    for d in (2, 5, 9, 17, 33, 65, 100):
        A[0, 128 * d] = A[128 * d, 0] = 0.01 * d
    A = A.tocsr()
    A = (0.5 * (A + A.T)).tocsr()
    bound_ell = float(abs(A).sum(axis=1).max())
    ell = qt.bsr_from_scipy(A, block_size=128, device=device)
    recorded = {}
    with ScanRecorder() as rec:
        qt.propagate(psi0, H, tlist, method="cheby", fused=True, kernel="dd",
                     workspace=wrk, observables=obs, storage=True)
        recorded[f"L={L_MAIN} dd"] = rec.calls[-1]
        qt.propagate(psi0.to(torch.complex64), H, tlist, method="cheby",
                     fused=True, kernel="pallas", workspace=wrk)
        recorded[f"L={L_MAIN} f32"] = rec.calls[-1]
        cheby_propagate_fused(psi_c, H20, tlist, kernel="pallas", **env20)
        recorded[f"2^{L_CHECK} flip complex128"] = rec.calls[-1]
        cheby_propagate_fused(psi_c, H20, tlist, kernel="xla", **env20)
        recorded[f"2^{L_CHECK} generic"] = rec.calls[-1]
        gen, psi_m, kw = bench_torch.multiamp_problem(device, L_CHECK)
        cheby_propagate_fused(psi_m, gen, tlist, kernel="dd", **kw)
        recorded[f"multiamp 2^{L_CHECK}"] = rec.calls[-1]
        cheby_propagate_fused(ctx["psi0"], ctx["op"], ctx["tlist"],
                              workspace=ctx["wrk"], kernel="dd")
        recorded["banded20 dd"] = rec.calls[-1]
        cheby_propagate_fused(
            random_state(14, torch.complex128, device, SEED + 156), ell,
            tlist, kernel="dd", workspace=ChebyWorkspace.create(
                2.0 * bound_ell, -bound_ell, DT))
        recorded["static 2^14 blocked-ELL"] = rec.calls[-1]
        env = ctx["env"]
        qt.propagate(ctx["psi0"], ctx["op"], ctx["tlist"],
                     method="newton_leja", fused=True, e_min=env.e_min,
                     e_max=env.e_min + env.delta,
                     dd_operator_terms=(ctx["banded"],))
        recorded["banded20 newton_leja"] = rec.calls[-1]
    p20 = bench_torch.tfim_problem(device, L_CHECK)
    dd20, psi20, _ = bench_torch.dd_stepper(p20, device)

    def step20(psi, _, out=None):
        return dd20(psi, out=out), None

    recorded[f"bench_torch 2^{L_CHECK} dd"] = (step20, psi20, None, N_STEPS)
    torch.cuda.synchronize()
    for label, (step, carry, xs, length) in recorded.items():
        summary[label] = graph_vs_eager(label, step, carry, xs,
                                        _length(xs, length), card, paths)

    # traces: 5 dd steps at 2^20 and 2^24, graph and eager
    step24, carry24, xs24, _ = recorded[f"L={L_MAIN} dd"]
    xs24 = xs24[:5] if not isinstance(xs24, tuple) \
        else tuple(t[:5] for t in xs24)
    for label, step, carry, xs in ((f"2^{L_CHECK}", step20, psi20, None),
                                   (f"2^{L_MAIN}", step24, carry24, xs24)):
        g5 = GraphedScan(step)
        for how, run in (("graph", lambda: g5(carry, xs, 5)),
                         ("eager", lambda: _loop(step, carry, xs, 5))):
            *_, busy = trace_steps(run, f"phase 15 trace {how} dd {label}",
                                   5, card, top=4)
            summary[f"busy {how} {label}"] = busy
        del g5

    # make_fused_cheby_propagator: the captures for three tables
    short = tlist[:6]
    fn = make_fused_cheby_propagator(
        psi_c, H20, short, specrange_method="manual", E_min=-bound20,
        E_max=bound20, observable_fn=lambda p: torch.vdot(p, p).real)
    rng = np.random.default_rng(SEED + 160)
    errs = []
    with counted_graphs() as made:
        for _ in range(3):
            table = torch.as_tensor(rng.uniform(0.5, 1.5, (5, 1)),
                                    device=device)
            with torch.no_grad():
                got = fn(psi_c, table)
            with loop_scans():
                want = fn(psi_c, table.clone().requires_grad_(True))
            # under autograd: the tape's forward and backward graphs
            taped = fn(psi_c, table.clone().requires_grad_(True))
            want = tuple(t.detach() for t in want)
            errs.append(max(_max_diff(got, want), _max_diff(
                tuple(t.detach() for t in taped), want)))
    if len(made) != 4 or max(errs) != 0.0:
        raise AssertionError(f"phase 15 make_fused_cheby_propagator: "
                             f"{len(made)} captures, max|d| {errs}")
    summary["captures for 3 tables"] = len(made)
    log(f"phase 15 make_fused_cheby_propagator L={L_CHECK} 5 intervals, 3 "
        f"tables: {len(made)} captures (the two graphs without autograd, "
        f"the tape's forward and backward under it), graphs vs eager loop "
        f"max|d| {max(errs):.3e} (= 0) ok")

    # a step that reads the host raises at capture, and the card goes on
    try:
        cheby_propagate_fused(psi20, H20, tlist[:3], kernel="dd",
                              specrange_method="manual", E_min=-bound20,
                              E_max=bound20,
                              observable_fn=lambda p: torch.tensor(
                                  p.abs().max().item(), device=p.device))
    except RuntimeError as exc:
        if "cannot be captured" not in str(exc):
            raise
        log(f"phase 15 an observable calling .item() raises at capture: "
            f"{str(exc).splitlines()[0][:160]}")
    else:
        raise AssertionError("phase 15: a host read inside the scan did "
                             "not raise")
    again, _ = cheby_propagate_fused(
        psi20, H20, tlist[:3], kernel="dd", specrange_method="manual",
        E_min=-bound20, E_max=bound20)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(torch.view_as_real(again)).all()):
        raise AssertionError("phase 15: the card failed after a refused "
                             "capture")
    del again, fn, recorded
    log(f"phase 15 wall {time.perf_counter() - t_phase:.1f} s")
    return paths, summary

# phase 16: the TPU probes of docs/profiling/, ported as
# quantumpropagators_torch/profiling/ on csrc/probes.cu.  Each module's
# command line at 5 repetitions a measurement (chain and scatter probes at
# their JAX sizes, stream and flip probes also at planes of 2^26).
PROBE_SOURCE = "quantumpropagators_torch/csrc/probes.cu"
PROBE_N = 1 << 26    # phase 16's large planes: 256 MB, a 2^24 complex128 state
PROBE_MAINS = (
    ("roofline", ["--reps", "5"]),
    ("scatter", ["--flops", "0", "400", "--reps", "5"]),
    ("scatter", ["--manual", "--flops", "0", "400", "--reps", "5"]),
    ("flips", ["--reps", "5"]),
    ("dd_stages", ["--L", str(L_MAIN), "--reps", "5"]),
    ("exactness", []),
)
# rows of phase 16a's ragged tile products: not a multiple of the TF32
# kernel's 64-row tile nor of the FP64 kernel's 32
PROBE_RAGGED_ROWS = {"tf32": 1040, "3xtf32": 1040, "f64": 1032}
# phase 16a's ragged stream planes: a multiple of 4 elements, not of the
# stream kernel's chunks (256 float4s a block)
PROBE_STREAM_RAGGED = (1 << 20) + 1028
# name: (op, planes, chain, mul, scale, tolerance relative to max|plain|;
# 0 = bit for bit: the kernel adds in the plain version's order)
PROBE_STREAM_CHECKS = {
    "copy": ("sum", 1, 0, 1.0, 1.0, 0),
    "copy*1.0000001": ("sum", 1, 0, 1.0, 1.0000001, 0),
    "add": ("sum", 2, 0, 1.0, 1.0, 0),
    "sum7": ("sum", 7, 0, 1.0, 1.0, 0),
    "triad": ("triad", 3, 0, 1.0, 1.0, 2e-6),     # x + y*z contracted
    "fma16": ("chain", 2, 16, 1.0000001, 1.0, 1e-5),
    "fma64": ("chain", 2, 64, 1.0000001, 1.0, 1e-5),
}


def _hold(errs, key, got, want, rel, what):
    """Holds ``got`` against ``want`` for kernel ``key``: bit for bit
    (``rel = 0``) or within ``rel·max|want|``; records the max abs
    difference in ``errs[key]``.  Tuples and lists are held element by
    element."""
    if isinstance(got, (tuple, list)):
        for g, w in zip(got, want, strict=True):
            _hold(errs, key, g, w, rel, what)
        return
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    if not (torch.equal(got, want) if rel == 0 else err <= rel * scale):
        raise AssertionError(f"phase 16 {key} {what}: max|d| {err:.3e} "
                             f"against {rel} x {scale:.3e}")
    errs[key] = max(errs.get(key, 0.0), err)


def _hold_orders(errs, inputs):
    """Every ``probe_flip_order`` case on ``inputs`` (``dd_stages``'s
    ``order_inputs``) against its plain version (float64 within 1e-14 on
    unit-norm states), and ``full/xor`` bit for bit against the
    production pass ``cheby_flip_iter_low``."""
    from quantumpropagators_torch.ops import cheby_flip as cf
    from quantumpropagators_torch.ops import probes
    from quantumpropagators_torch.profiling.dd_stages import AK, S2

    v0, v1, phi, dmb, G = inputs
    L = v0.numel().bit_length() - 1
    tile_bits, h = cf.flip_split(L, torch.complex128)
    w = cf.cheby_flip_high(v1, G, h)
    for body in probes.ORDER_BODIES:
        for nb in probes.ORDER_NBS:
            k0, kphi, p0, pphi = v0.clone(), phi.clone(), v0.clone(), \
                phi.clone()
            args = (dmb, G, S2, AK, tile_bits, L - h, body, nb, w)
            probes.probe_flip_order(k0, v1, kphi, *args)
            probes.probe_flip_order_plain(p0, v1, pphi, *args)
            key = f"probe_flip_order<double,{body},{nb}>"
            for got, want in ((k0, p0), (kphi, pphi)):
                err = float((got - want).abs().max())
                if err > 1e-14:
                    raise AssertionError(f"phase 16 {key} L={L}: max|d| "
                                         f"{err:.3e}")
                errs[key] = max(errs.get(key, 0.0), err)
            if (body, nb) == ("full", "xor"):  # the production pass's copy
                b0, bphi = v0.clone(), phi.clone()
                cf.cheby_flip_iter_low(b0, v1, bphi, dmb, G, S2, AK, L - h, w)
                if not (torch.equal(k0, b0) and torch.equal(kphi, bphi)):
                    raise AssertionError(f"phase 16 probe_flip_order full/xor "
                                         f"L={L} differs from "
                                         f"cheby_flip_iter_low")


def _hold_fma(errs, a, b):
    """The FMA residual kernel in each variant: ``p`` bit for bit against
    the plain version; ``r`` bit for bit against the exact residual where
    the reading is ``FUSED`` and against 0 where it is ``separate`` (which
    the ``separate`` variant must read)."""
    from quantumpropagators_torch.ops import probes

    ctype = "float" if a.dtype == torch.float32 else "double"
    key = f"probe_fma_residual<{ctype}>"
    for variant in probes.FMA_VARIANTS:
        p, r = probes.probe_fma_residual(a, b, variant)
        outcome = probes.fma_outcome(a, b, p, r)
        if outcome not in ("FUSED", "separate") or (
                variant == "separate" and outcome != "separate"):
            raise AssertionError(f"phase 16 {key} {variant}: {outcome}")
        _hold(errs, key, p, probes.probe_fma_residual_plain(a, b, variant)[0],
              0, f"{variant} p")
        want = probes.exact_product_residual(a, b) if outcome == "FUSED" \
            else torch.zeros_like(r)
        _hold(errs, key, r, want, 0, f"{variant} r ({outcome})")


def probe_checks(device, big, s16):
    """Phase 16a: every probe kernel against its plain version on the
    card, at the probe modules' own sizes: the stream bodies on ``big``
    (planes of 2^26) and ``s16`` (the scatter probe's 16 planes of 2^22),
    the scatter maps and the pipelined sum on ``s16`` with tiles of 1024
    rows, the flip sums at 2^20, 2^22 and 2^26, the flip order at L_CHECK
    (phase 16b holds it at L_MAIN).  Returns the max abs difference per
    kernel."""
    from quantumpropagators_torch.ops import probes
    from quantumpropagators_torch.profiling import exactness, scatter
    from quantumpropagators_torch.profiling.dd_stages import order_inputs
    from quantumpropagators_torch.profiling.flips import VARIANTS
    from quantumpropagators_torch.profiling.roofline import smem_limit

    errs = {}
    # whole chunks of the stream kernel's blocks, and a length that is not
    ragged = [x[:PROBE_STREAM_RAGGED] for x in s16]
    for xs in (s16, big, ragged):
        n = xs[0].numel()
        for name, (op, n_in, chain, mul, scale, rel) in \
                PROBE_STREAM_CHECKS.items():
            kw = dict(chain=chain, mul=mul, scale=scale)
            _hold(errs, f"probe_stream<{op}>",
                  probes.probe_stream(xs[:n_in], op, **kw),
                  probes.probe_stream_plain(xs[:n_in], op, **kw), rel,
                  f"{name} {n} elements")
    n = s16[0].numel()
    tile_bits = 17  # tiles of 1024 rows, as probe_scatter_r4.py
    for mode in scatter.MODES:
        for flops in (0, 400):
            kw = dict(maps=scatter.maps(mode, n >> tile_bits),
                      tile_bits=tile_bits, chain=scatter.chain_of(flops),
                      mul=0.9999, n_out=2)
            got = probes.probe_stream(s16, "sum", **kw)
            want = probes.probe_stream_plain(s16, "sum", **kw)
            what = f"scatter {mode} flops={flops} 2^{n.bit_length() - 1}"
            _hold(errs, "probe_stream<sum>", got[0], want[0],
                  1e-5 if flops else 0, what)
            _hold(errs, "probe_stream<sum>", got[1], want[1], 0, what)
    for flops in (0, 400):
        kw = dict(chain=scatter.chain_of(flops), mul=0.9999)
        _hold(errs, "probe_stream_pipelined",
              probes.probe_stream_pipelined(s16, **kw),
              probes.probe_stream_pipelined_plain(s16, **kw),
              1e-5 if flops else 0, f"flops={flops}")
    for x in (s16[0][:1 << 20], s16[0], big[0]):
        for variant, tb in VARIANTS.items():
            for lo, hi in ((0, 9), (0, 12), (7, 17)):
                # the mma variant sums bits 0-6 on the tensor cores
                if variant == "mma" and lo:
                    continue
                _hold(errs, f"probe_flipsum<{variant}>",
                      probes.probe_flipsum(x, lo, hi, variant, tb),
                      probes.probe_flipsum_plain(x, lo, hi, variant, tb),
                      2e-6 if variant == "mma" else 0,
                      f"bits [{lo}, {hi}) 2^{x.numel().bit_length() - 1}")
    for mode in probes.MMA_MODES:
        dtype = torch.float64 if mode == "f64" else torch.float32
        x = s16[0][:512 * 128].view(512, 128).to(dtype)
        # on a TF32 rounding tie: truncating in place of rounding would show
        ties = torch.from_numpy(exactness.tf32_ties((512, 128), SEED)).to(
            device, dtype)
        key = f"probe_tile_mma<{mode}>"
        for bit in range(7):  # every fragment position, bit for bit
            P = torch.from_numpy(exactness.permutation(bit)).to(device, dtype)
            _hold(errs, key, probes.probe_tile_mma(x, P, mode),
                  probes.probe_tile_mma_plain(x, P, mode), 0,
                  f"flip of lane bit {bit}")
            _hold(errs, key, probes.probe_tile_mma(ties, P, mode),
                  probes.probe_tile_mma_plain(ties, P, mode), 0,
                  f"TF32 ties, flip of lane bit {bit}")
        rows = PROBE_RAGGED_ROWS[mode]  # not a multiple of the tile's rows
        xr = s16[1][:rows * 128].view(rows, 128).to(dtype)
        Mr = s16[2][:128 * 128].view(128, 128).to(dtype)
        _hold(errs, key, probes.probe_tile_mma(xr, Mr, mode),
              probes.probe_tile_mma_plain(xr, Mr, mode),
              1e-14 if mode == "f64" else 2e-6, f"random ({rows}, 128)")
    smem = smem_limit(device)  # each launch's output held bit for bit
    if not smem[227] or smem[228]:
        raise AssertionError(f"phase 16 probe_smem: {smem} (227 KB must "
                             f"launch, 228 KB be refused)")
    errs["probe_smem"] = 0.0
    _hold_orders(errs, order_inputs(L_CHECK, device, SEED))
    for dtype in (torch.float32, torch.float64):
        a, b = (x[:1 << 20].to(dtype) for x in s16[:2])
        _hold_fma(errs, a, b)
    x = s16[2][:1024].view(8, 128) * torch.exp(s16[3][:1024].view(8, 128))
    _hold(errs, "probe_extract", probes.probe_extract(x),
          probes.probe_extract_plain(x), 0, "(8, 128)")
    for variant, bits in (("shfl", range(5)), ("smem", range(12))):
        for bit in bits:
            _hold(errs, f"probe_xor_permute<{variant}>",
                  probes.probe_xor_permute(s16[4], bit, variant),
                  probes.probe_xor_permute_plain(s16[4], bit, variant), 0,
                  f"bit {bit}")
    missing = set(probes.LAUNCHES) - set(errs)
    if missing:
        raise AssertionError(f"phase 16: no check of {sorted(missing)}")
    inexact = ", ".join(f"{k} {v:.2e}" for k, v in errs.items() if v)
    log(f"phase 16a every probe kernel against its plain version: "
        f"{len(errs)} kernels, max|d| {inexact or 'none'}, the rest bit for "
        f"bit; 227 KB of shared memory launches, 228 KB is refused ok")
    return errs


def probe_times(device, card, big, s16, errs):
    """Phase 16b: each probe kernel at its probe's size (stream and flip
    bodies on the planes of 2^26 in ``big``, the pipelined sum on the
    scatter probe's 16 planes of 2^22, the flip order at L_MAIN, the
    exactness bodies at theirs), its plain version, the one PyTorch call
    that computes the same function where there is one, and the bound.
    Each kernel's output on the timed inputs is held against the plain
    version's first, at phase 16a's tolerances; kernel and library are
    read twice in turn and the lower reading kept.  Returns
    ``{kernel: (ms, plain_ms, bound_ms, bound_by, library_ms)}``."""
    from quantumpropagators_torch.ops import cheby_flip as cf
    from quantumpropagators_torch.ops import probes
    from quantumpropagators_torch.profiling import time_ms as graph_ms
    from quantumpropagators_torch.profiling.dd_stages import AK, S2, \
        order_inputs
    from quantumpropagators_torch.profiling.flips import VARIANTS

    xs = big[:3]
    n = xs[0].numel()
    out = torch.empty_like(xs[0])
    x2, M2 = xs[0].view(-1, 128), xs[1][:128 * 128].view(128, 128)
    x64, M64 = x2[: n // 256].double(), M2.double()
    out64 = torch.empty_like(x64)
    tiny = xs[2][:1024].view(8, 128)
    r32 = xs[2][:32 * 128].view(32, 128)
    small = tiny.double()

    def matmul(a, b, o, tf32):
        def run():
            saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                torch.matmul(a, b, out=o)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = saved
        return run

    P, K = probes, {}
    # key: (kernel, plain, library or None, bytes, operations, peak, what,
    # tolerance of the hold, or None: the order and the FMA residual are
    # held by their own checks)
    K["probe_stream<sum>"] = (
        lambda: P.probe_stream(xs[:1]), lambda: P.probe_stream_plain(xs[:1]),
        lambda: out.copy_(xs[0]), 8 * n, 0, "float",
        f"copy 2^{n.bit_length() - 1}", 0)
    K["probe_stream<triad>"] = (
        lambda: P.probe_stream(xs, "triad"),
        lambda: P.probe_stream_plain(xs, "triad"),
        lambda: torch.addcmul(xs[0], xs[1], xs[2], out=out), 16 * n, 2 * n,
        "float", f"triad 2^{n.bit_length() - 1}", 2e-6)
    chain = dict(chain=64, mul=1.0000001)
    K["probe_stream<chain>"] = (
        lambda: P.probe_stream(xs[:2], "chain", **chain),
        lambda: P.probe_stream_plain(xs[:2], "chain", **chain), None,
        12 * n, 128 * n, "float", f"fma64 2^{n.bit_length() - 1}", 1e-5)
    K["probe_stream_pipelined"] = (
        lambda: P.probe_stream_pipelined(s16),
        lambda: P.probe_stream_pipelined_plain(s16), None,
        17 * 4 << 22, 15 << 22, "float", "16 planes of 2^22, flops=0", 0)
    for variant, tb in VARIANTS.items():
        K[f"probe_flipsum<{variant}>"] = (
            lambda v=variant, t=tb: P.probe_flipsum(xs[0], 0, 9, v, t),
            lambda v=variant, t=tb: P.probe_flipsum_plain(xs[0], 0, 9, v, t),
            None, 8 * n, 9 * n, "float",
            f"9-bit flip sum 2^{n.bit_length() - 1}",
            2e-6 if variant == "mma" else 0)
    K["probe_tile_mma<tf32>"] = (
        lambda: P.probe_tile_mma(x2, M2, "tf32"),
        lambda: P.probe_tile_mma_plain(x2, M2, "tf32"),
        matmul(x2, M2, out.view(-1, 128), True), 8 * n, 256 * n, "tf32",
        f"({x2.shape[0]}, 128) x (128, 128), library TF32", 2e-6)
    K["probe_tile_mma<3xtf32>"] = (
        lambda: P.probe_tile_mma(x2, M2, "3xtf32"),
        lambda: P.probe_tile_mma_plain(x2, M2, "3xtf32"),
        matmul(x2, M2, out.view(-1, 128), False), 8 * n, 3 * 256 * n,
        "tf32", f"({x2.shape[0]}, 128) x (128, 128), library full f32", 2e-6)
    K["probe_tile_mma<f64>"] = (
        lambda: P.probe_tile_mma(x64, M64, "f64"),
        lambda: P.probe_tile_mma_plain(x64, M64, "f64"),
        matmul(x64, M64, out64, False), 16 * x64.numel(),
        256 * x64.numel(), "fp64 mma", f"({x64.shape[0]}, 128) f64", 1e-14)
    K["probe_smem"] = (
        lambda: P.probe_smem(tiny, 227 * 1024),
        lambda: P.probe_smem_plain(tiny, 227 * 1024), None, 8 * 1024, 0,
        "float", "(8, 128) through 227 KB", 0)
    v0, v1, phi, dmb, G = order_inputs(L_MAIN, device, SEED)
    tile_bits, h = cf.flip_split(L_MAIN, torch.complex128)
    w = cf.cheby_flip_high(v1, G, h)
    N = 1 << L_MAIN
    for body in P.ORDER_BODIES:
        for nb in P.ORDER_NBS:
            args = (v0, v1, phi, dmb, G, S2, AK, tile_bits, L_MAIN - h, body,
                    nb, w)
            K[f"probe_flip_order<double,{body},{nb}>"] = (
                lambda a=args: P.probe_flip_order(*a),
                lambda a=args: P.probe_flip_order_plain(*a), None,
                104 * N, (4 * (L_MAIN - h) + 12) * N, "double",
                f"L={L_MAIN} bits < {L_MAIN - h}", None)
    for ctype, a in (("float", tiny), ("double", small)):
        K[f"probe_fma_residual<{ctype}>"] = (
            lambda a=a: P.probe_fma_residual(a, a),
            lambda a=a: P.probe_fma_residual_plain(a, a), None,
            4 * a.numel() * a.element_size(), 3 * a.numel(), ctype,
            "(8, 128)", None)
    K["probe_extract"] = (lambda: P.probe_extract(tiny),
                          lambda: P.probe_extract_plain(tiny), None,
                          12 * 1024, 4 * 1024, "float", "(8, 128)", 0)
    for variant, bit in (("shfl", 2), ("smem", 8)):
        K[f"probe_xor_permute<{variant}>"] = (
            lambda v=variant, b=bit: P.probe_xor_permute(r32, b, v),
            lambda v=variant, b=bit: P.probe_xor_permute_plain(r32, b, v),
            None, 8 * r32.numel(), 0, "float", f"(32, 128), bit {bit}", 0)
    _hold_orders(errs, (v0, v1, phi, dmb, G))
    _hold_fma(errs, tiny, tiny)
    _hold_fma(errs, small, small)
    times = {}
    for key, (kernel, plain, library, n_bytes, ops, peak, what, rel) in \
            K.items():
        if rel is not None:
            _hold(errs, key, kernel(), plain(), rel, f"{what} (timed inputs)")
        # kernel and library call as the probe modules time them (a CUDA
        # graph of the launches: no host cost), twice in turn, the lower
        # reading kept (a first reading after the host's work ran up to 3 %
        # slow); the plain version, which copies its scalars to the card,
        # eagerly
        reads = [(graph_ms(kernel, 10),
                  None if library is None else graph_ms(library, 10))
                 for _ in range(2)]
        ms = min(k for k, _ in reads)
        plain_ms = time_ms(plain, 3)
        lib_ms = None if library is None else min(lib for _, lib in reads)
        bound_ms, bound_by = bound(n_bytes, ops, peak)
        times[key] = (ms, plain_ms, bound_ms, bound_by, lib_ms)
        lib = "" if lib_ms is None else (
            f", library {lib_ms:.4f} ms ({ms / lib_ms:.3f} x the library's "
            f"time)")
        if key.startswith("probe_tile_mma<"):
            lib += f", {P.MMA_INSTRUCTIONS[key[len('probe_tile_mma<'):-1]]}"
        log(f"phase 16b time {key} {what}: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
            f"{100 * bound_ms / ms:.1f} % of it reached){lib} [{card}]")
    return times


def probe_floor_times(device, card, big, times):
    """Phase 16b, the one-tile probes (``probe_smem``, ``probe_extract``,
    ``probe_fma_residual``, ``probe_xor_permute``) against the launch
    floor: ``zero_`` of one float, a kernel that does nothing else,
    timed as the probes are (a replayed CUDA graph of 10 launches).  The
    grid kernels also on planes of 2^26 elements against their byte
    bounds (held against their plain versions first); ``probe_extract``
    (one block: σ over the whole input) and ``probe_smem`` (a proof that
    the size allocates) keep their own shapes, where the floor is their
    bound."""
    from quantumpropagators_torch.ops import probes as P
    from quantumpropagators_torch.profiling import time_ms as graph_ms

    one = torch.empty(1, device=device)
    floor = min(graph_ms(lambda: one.zero_(), 10) for _ in range(2))
    log(f"phase 16b launch floor: zero_ of one float, a replayed CUDA graph "
        f"of 10 launches, {floor:.4f} ms a launch [{card}]")
    own = ", ".join(f"{key} {times[key][0]:.4f} ms "
                    f"({times[key][0] / floor:.2f} x the floor)" for key in (
                        "probe_smem", "probe_extract",
                        "probe_fma_residual<float>",
                        "probe_fma_residual<double>",
                        "probe_xor_permute<shfl>", "probe_xor_permute<smem>"))
    log(f"phase 16b one-tile probes at their own shapes: {own} [{card}]")
    x32 = big[3]
    n = x32.numel()
    held = {}
    grid = {}
    # two distinct operands: four streams of n elements to move
    for a, b in ((x32, big[4]), (big[5].double(), big[6].double())):
        _hold_fma(held, a, b)
        ctype = "float" if a.dtype == torch.float32 else "double"
        grid[f"probe_fma_residual<{ctype}>"] = (
            lambda a=a, b=b: P.probe_fma_residual(a, b),
            4 * n * a.element_size(), 3 * n, ctype)
    for variant, bit in (("shfl", 2), ("smem", 8)):
        key = f"probe_xor_permute<{variant}>"
        _hold(held, key, P.probe_xor_permute(x32, bit, variant),
              P.probe_xor_permute_plain(x32, bit, variant), 0,
              f"2^{n.bit_length() - 1}, bit {bit}")
        grid[key] = (lambda v=variant, b=bit: P.probe_xor_permute(x32, b, v),
                     8 * n, 0, "float")
    for key, (kernel, n_bytes, ops, peak) in grid.items():
        ms = min(graph_ms(kernel, 10) for _ in range(2))
        bound_ms, bound_by = bound(n_bytes, ops, peak)
        log(f"phase 16b time {key} 2^{n.bit_length() - 1} elements: "
            f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
            f"{100 * bound_ms / ms:.1f} % of it reached; {ms / floor:.1f} x "
            f"the launch floor) [{card}]")


def probe_phase(device, card):
    """Phase 16: the TPU probes of ``docs/profiling/`` on the card.
    (a) every kernel of ``csrc/probes.cu`` against its plain version;
    (b) each timed beside its plain version, bound and library call;
    (c) the launch counts set to 0, each probe module's command line
    (``PROBE_MAINS``) run in this process, the counts read: every probe
    kernel must have launched, and the exactness probe must read one of
    its named outcomes.  Returns the kernels line's probe entries and the
    flip kernels' launches of (c) (``dd_stages`` times the high pass and
    the production order)."""
    import importlib

    from quantumpropagators_torch.ops import cheby_flip as cf
    from quantumpropagators_torch.ops import probes
    from quantumpropagators_torch.profiling import planes, scatter

    t_phase = time.perf_counter()
    big = planes(PROBE_N, 7, device, SEED)
    s16 = planes(1 << 22, scatter.N_IN, device, SEED)
    errs = probe_checks(device, big, s16)
    times = probe_times(device, card, big, s16, errs)
    probe_floor_times(device, card, big, times)
    del big, s16
    gc.collect()
    torch.cuda.empty_cache()
    probes.reset_launches()
    cf.reset_launches()
    runs = {}
    for module, argv in PROBE_MAINS:
        log(f"phase 16c python -m quantumpropagators_torch.profiling.{module} "
            f"{' '.join(argv)}:")
        runs.setdefault(module, []).append(importlib.import_module(
            f"quantumpropagators_torch.profiling.{module}").main(argv))
    counts, flip_counts = dict(probes.LAUNCHES), dict(cf.LAUNCHES)
    idle = [k for k, v in counts.items() if not v]
    if idle or not flip_counts["cheby_flip_high<double>"]:
        raise AssertionError(f"phase 16: not launched by the probes' "
                             f"command lines: {idle}")
    ex = runs["exactness"][0]
    fma = {c: {v: ex["fma"][c][v] for v in probes.FMA_VARIANTS}
           for c in ("float", "double")}
    log(f"phase 16 exactness: FMA contraction of a·b − p (p loaded) float "
        f"{ex['fma']['float']['loaded']}, double "
        f"{ex['fma']['double']['loaded']}; every variant {fma}; σ-extraction "
        f"{ex['sigma']['extract']}; permutation exact "
        f"{ {m: r['perm_exact'] for m, r in ex['permutation'].items()} }; "
        f"mantissa bits exact "
        f"{ {m: [k for k, r in ex['grid'].items() if r[m] == 0.0] for m in ('tf32', '3xtf32', 'f64')} } "
        f"[{card}]")
    entries = []
    for key, launched in counts.items():
        ms, plain_ms, bound_ms, bound_by, lib_ms = times[key]
        entries.append({
            "name": key, "route": "cuda", "source": PROBE_SOURCE,
            "replaces": probes.REPLACES[key], "launches": launched,
            "launches_by_path": {"phase 16 profiling": launched},
            "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
    log(f"phase 16 wall {time.perf_counter() - t_phase:.1f} s")
    return entries, flip_counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; refusing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist

    from quantumpropagators_torch.ops import _cuda
    from quantumpropagators_torch.parallel.distributed import \
        initialize_multihost

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
    launches, rates, matvecs, chain, finals, p_xla = main_path(device, card)
    round_trip(device)
    times = time_kernels(device, card)
    for tier, (steps_s, gnnz) in rates.items():
        log(f"phase 6 main path {tier} L={L_MAIN}: {steps_s:.3f} steps/s, "
            f"{gnnz:.3f} Gnnz/s ({matvecs} matvecs/step, nnz=(L+1)*2^L; "
            f"median of 3 timed runs of {N_STEPS} steps) [{card}]")
    gc.collect()
    torch.cuda.empty_cache()  # the 2^24 buffers go before the banded phase
    banded, ctx = banded_phase(device, card)
    trace_phase(*chain, card)
    # phase 9 reads each Krylov path's banded launches; phase 7's count
    # stays its own
    banded["launches_by_path"] = {"phase 7 cheby dd": banded["launches"]}
    krylov_launches, rates9 = krylov_phase(device, card, ctx)
    for path, n in krylov_launches.items():
        banded["launches_by_path"][path] = n
        banded["launches"] += n
    gc.collect()
    torch.cuda.empty_cache()
    sparse = small_configs(device, card)
    step_banded, step_flips = step_graph_phase(device, card, ctx, sparse)
    for path, n in step_banded.items():
        banded["launches_by_path"][path] = n
        banded["launches"] += n
    gc.collect()
    torch.cuda.empty_cache()
    ode_flips = ode_phase(device, card, sparse)
    gc.collect()
    torch.cuda.empty_cache()
    scan_paths, _ = graph_phase(device, card, chain, ctx)
    gc.collect()
    torch.cuda.empty_cache()
    probe_kernels, probe_flips = probe_phase(device, card)
    gc.collect()
    torch.cuda.empty_cache()
    # phases 10 and 11 share one world-size-1 NCCL group
    group = initialize_multihost(f"localhost:{free_port()}", 1, 0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        flip_paths, n, err_b = sharded_phase(device, card, chain, finals,
                                             ctx, rates, group)
        gc.collect()
        torch.cuda.empty_cache()
        for path, counts in sharded_graph_phase(device, card, chain, ctx,
                                                group).items():
            scan_paths[path] = counts
        gc.collect()
        torch.cuda.empty_cache()
        sharded_krylov_phase(device, card, ctx, group, rates9, sparse)
    finally:
        dist.destroy_process_group()
    flip_paths["phase 16 profiling dd_stages"] = probe_flips
    flip_paths["phase 19b cheby dd references"] = ode_flips
    flip_paths.update(step_flips)
    banded["launches_by_path"]["phase 10 sharded banded20"] = n
    banded["launches"] += n
    for path, counts in scan_paths.items():
        if counts[BANDED]:
            banded["launches_by_path"][path] = counts[BANDED]
            banded["launches"] += counts[BANDED]
        elif any(counts.values()):
            flip_paths[path] = counts
    banded["max_abs_err"] = max(banded["max_abs_err"], err_b)
    del finals, ctx
    gc.collect()
    torch.cuda.empty_cache()  # phase 11's buffers go before phase 12
    flip_paths.update(final_slice_phase(device, card, chain, p_xla,
                                        rates["pallas"][0]))
    del chain, p_xla
    gc.collect()
    torch.cuda.empty_cache()  # phase 12's buffers go before phase 13
    bench_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    flip_paths["phase 14 scaling hypercube-dd"] = entry_points_phase(device,
                                                                     card)

    kernels = []
    for name in REPLACES:
        ms, plain_ms, bound_ms, bound_by = times[name]
        by_path = {"phase 3 dd": launches["dd"][name],
                   "phase 4 pallas": launches["pallas"][name],
                   **{path: counts[name]
                      for path, counts in flip_paths.items()}}
        entry = {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call sums site flips
        }
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        kernels.append(entry)
    kernels.append({"name": BANDED, "route": "cuda", "source": BANDED_SOURCE,
                    "replaces": BANDED_REPLACES, **banded})
    kernels.extend(probe_kernels)
    log(f"total {time.perf_counter() - T_START:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
