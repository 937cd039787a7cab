"""Whole-grid propagation on the device: PyTorch port of
:mod:`quantumpropagators.fused`.

The generic :func:`~quantumpropagators_torch.propagate` entry point steps
the time grid from the host (needed for arbitrary callbacks).  For long
time grids, optimal-control inner loops and benchmarking the whole
propagation is instead ONE device program: a scan over the per-interval
coefficient table (:func:`.utils.scan.scan`, the port's ``lax.scan``),
with observables evaluated in-scan into a preallocated output array (the
device-side realization of the reference's ``propagate`` + ``Storage``
pipeline, ``src/propagate.jl:322-337``).  On the card the scan is one
CUDA graph of a step, captured once and replayed per interval, with no
host work per interval beyond the replay call; on the CPU it is a loop
of the same step.  Every step here therefore reads nothing from the
host: per-interval values (table rows, folded diagonals, flip weights)
are device tensors, and only values fixed for the whole propagation
(Chebyshev coefficients, the phase ``exp(-iβdt)``, the f32 tail length)
are Python constants.  Every step takes the scan's ``out`` and writes
its new state there, so that the card's replays alternate between two
state buffers and copy no state.  On the card ``observable_fn(psi)``
must return a device tensor without reading the host, as the JAX one
must be traceable.  :func:`make_fused_cheby_propagator` keeps its
graph, so an optimal-control loop replays one capture with new tables.

``kernel`` selects the step:

- ``"xla"``: the generic operator algebra (:func:`.ops.cheby.cheby_apply`
  in plain PyTorch) — the name is the JAX package's;
- ``"pallas"``: the hand-written flip kernel in the state's precision
  (complex64 → ``float``, complex128 → ``double``); needs
  diagonal-plus-site-flip structure;
- ``"dd"``: the reference-accuracy tier in complex128: the flip kernel
  with an f32 tail for diagonal-plus-site-flip generators, the banded
  SpMV kernel for static block-banded operators;
- ``"auto"``: the flip kernel when the structure matches and the state
  is on a CUDA device, else ``"xla"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .models.generators import Generator, Operator, coeff_table, coeff_table_np
from .ops.cheby import ChebyWorkspace, cheby_apply
from .ops.fused_cheby import flip_cheby_step, flip_structure, make_flip_plan
from .ops.operators import (
    BSROperator,
    as_tensor,
    bsr_from_scipy,
    host_np,
    to_scipy_sparse,
)
from .utils.scan import GraphedScan, scan

__all__ = ["cheby_propagate_fused", "make_fused_cheby_propagator"]


def _with_outputs(step, observable_fn, store_states, view=None):
    """The scan step of ``step(psi, x, out=None) -> psi``: the new state
    and its output, ``observable_fn`` of it, the state itself with
    ``store_states``, or ``None`` (``view`` picks what both see).  It
    takes the scan's ``out`` and hands it to ``step``."""

    def scan_step(psi, x, out=None):
        psi = step(psi, x) if out is None else step(psi, x, out=out)
        seen = psi if view is None else view(psi)
        if observable_fn is not None:
            return psi, torch.as_tensor(observable_fn(seen))
        return psi, (seen if store_states else None)

    return scan_step


def _scan(step, psi, xs, n_steps, observable_fn, store_states, view=None):
    """:func:`.utils.scan.scan` of ``step(psi, x) -> psi`` over ``xs``
    (or ``n_steps`` intervals); returns the final state and the stacked
    per-step outputs (or ``None``)."""
    return scan(_with_outputs(step, observable_fn, store_states, view), psi,
                xs, None if xs is not None else n_steps)


def _generic_step(ops, cheby_coeffs, delta, e_min, dt, forward, apply_fn):
    """One :func:`cheby_apply` over ``Operator(ops, row)`` for the row of
    the coefficient table."""

    def step(psi, row, out=None):
        return cheby_apply(Operator(ops, row), psi, cheby_coeffs, delta,
                           e_min, dt, forward=forward, apply_fn=apply_fn,
                           out=out)

    return step


def _fused_scan(ops, coeffs_table, psi0, cheby_coeffs, delta, e_min, dt,
                forward, observable_fn, store_states, apply_fn):
    """The generic path behind ``kernel="xla"``: one
    :func:`cheby_apply` per row of the coefficient table."""
    step = _generic_step(ops, cheby_coeffs, delta, e_min, dt, forward,
                         apply_fn)
    return _scan(step, psi0, coeffs_table, None, observable_fn,
                 store_states)


def _fused_scan_flip(plan, diag, diag_col, flip_col, coeffs_table, psi0,
                     cheby_coeffs, delta, e_min, dt, forward, observable_fn,
                     store_states):
    """``kernel="pallas"``: the flip kernel in the state's precision,
    with the diagonal and/or flip amplitude read from the coefficient
    table per interval."""
    rdtype = psi0.dtype.to_real()
    beta = float(delta) / 2.0 + float(e_min)
    gs = torch.as_tensor(plan.gs, dtype=rdtype, device=psi0.device)
    diag = diag.to(rdtype)
    static_dmb = (diag - beta).contiguous() if diag_col is None else None

    def step(psi, row, out=None):
        dmb = static_dmb if diag_col is None \
            else (row[diag_col] * diag - beta).contiguous()
        G = gs if flip_col is None else gs * row[flip_col]
        return flip_cheby_step(psi, dmb, G, cheby_coeffs, delta, e_min, dt,
                               forward=forward, out=out)

    return _scan(step, psi0.reshape(-1).contiguous(), coeffs_table, None,
                 observable_fn, store_states)


def _dd_path(fsm, generator, ops, psi0, tlist, workspace, backward,
             observable_fn, store_states, f32_tail="auto"):
    """``kernel="dd"``: the complex128 loop for every
    diagonal-plus-site-flip generator, single or multi amplitude.

    The driven diagonals' amplitudes ``c_l(t_k)`` and the per-bit flip
    table ``G_j(t_k) = Σ_l c_l(t_k)·g_{l,j}`` are made once, on the host
    in float64, as the scan's ``xs``; per interval the step folds, on the
    device, ``dmb(t_k) = Σ_static diag − β + Σ_l c_l(t_k)·diag_l`` and
    runs
    :func:`~.ops.fused_cheby_dd.cheby_step_fused_dd` with ``G`` as its
    per-bit ``flip_scale`` (the JAX package's ``_fused_scan_pallas_dd``
    and ``_fused_scan_pallas_dd_multi`` in one)."""
    from .ops.fused_cheby_dd import cheby_step_fused_dd, f32_tail_orders

    L, diag_terms, flip_terms = fsm
    device = psi0.device
    n_steps = len(tlist) - 1
    n_ops = len(ops)
    if isinstance(generator, Operator):
        cst = np.asarray(torch.as_tensor(generator.coeffs).cpu(),
                         dtype=np.float64)
        offc = n_ops - len(cst)

        def series(pos):
            v = 1.0 if pos < offc else float(cst[pos - offc])
            return np.full(n_steps, v, dtype=np.float64)

        static_pos = set(range(n_ops))
    else:
        # full-precision host table: the controls must not pass through
        # a lower-precision tensor on their way to the complex128 step
        table64 = np.asarray(coeff_table_np(generator, tlist),
                             dtype=np.float64)
        if backward:
            table64 = table64[::-1]
        off = n_ops - table64.shape[1]

        def series(pos):
            if pos < off:
                return np.ones(n_steps, dtype=np.float64)
            return table64[:, pos - off]

        static_pos = set(range(off))

    beta = float(workspace.delta) / 2.0 + float(workspace.e_min)
    dt = workspace.dt if not backward else -workspace.dt

    dmb_static = torch.full((2 ** L,), -beta, dtype=torch.float64,
                            device=device)
    dyn_diags, dyn_cols = [], []
    for pos, diag64 in diag_terms:
        if pos in static_pos:
            dmb_static = dmb_static + float(series(pos)[0]) * diag64.to(device)
        else:
            dyn_diags.append(diag64.to(device))
            dyn_cols.append(series(pos))

    Gbits = np.zeros((n_steps, L), dtype=np.float64)
    for pos, gs_bits in flip_terms:
        Gbits = Gbits + np.outer(series(pos), gs_bits)
    dyn = np.stack(dyn_cols, axis=1) if dyn_cols \
        else np.zeros((n_steps, 0), dtype=np.float64)
    xs = (torch.as_tensor(dyn, device=device),
          torch.as_tensor(Gbits, device=device))

    plan = make_flip_plan(L, 1.0)
    c64 = np.asarray(workspace.coeffs, dtype=np.float64)
    dd_tail = f32_tail_orders(c64) if f32_tail == "auto" else int(f32_tail)

    def step(psi, x, out=None):
        amps, G = x
        dmb = dmb_static
        for j, diag64 in enumerate(dyn_diags):
            dmb = dmb + amps[j] * diag64
        return cheby_step_fused_dd(
            plan, dmb, psi, c64, workspace.delta, workspace.e_min, dt,
            forward=not backward, flip_scale=G, f32_tail=dd_tail, out=out,
        )

    psi = psi0.reshape(-1).to(torch.complex128).contiguous()
    return _scan(step, psi, xs, None, observable_fn, store_states)


_REAL_ONLY = ("kernel='dd' supports real operator entries; propagate "
              "complex generators via the Liouvillian embedding")


def _real_matrix(generator):
    """The static generator folded into a host float64 scipy CSR
    matrix; raises for complex entries."""
    import scipy.sparse as sp

    if isinstance(generator, Operator):
        mats = [to_scipy_sparse(o) for o in generator.ops]
        c = np.asarray(host_np(generator.coeffs))
        off = len(mats) - len(c)
        A = sum(mats[:off], sp.csr_matrix(mats[0].shape))
        for i, ci in enumerate(c):
            A = A + complex(ci) * mats[off + i]
    else:
        A = to_scipy_sparse(generator)
    A = sp.csr_matrix(A)
    if np.iscomplexobj(A.data) and np.abs(A.data.imag).max() > 0:
        raise ValueError(_REAL_ONLY)
    return sp.csr_matrix(A.real.astype(np.float64))


def _static_dd_path(generator, psi0, tlist, workspace, backward,
                    observable_fn, store_states):
    """``kernel="dd"`` for static operators without diagonal-plus-flip
    structure, in complex128.

    A block-banded operator goes through the banded SpMV kernel
    (:mod:`.ops.banded_spmv`) at block size 128 on the card, 8 on the
    CPU (the JAX package's choice; small blocks keep the CPU tests
    cheap).  A :class:`BSROperator` of that block size is turned into
    band planes on its own device (:func:`.ops.bsr_dd.banded_dd_from_bsr`);
    every other operator is folded through a host scipy matrix.  Other
    sparsity falls back to :meth:`BSROperator.apply` in plain PyTorch.
    Real operator entries only."""
    from .ops.bsr_dd import (
        banded_dd_from_bsr,
        banded_dd_from_scipy,
        cheby_apply_dd_banded,
    )

    if isinstance(generator, Generator):
        raise ValueError(
            "kernel='dd' with a time-dependent generator requires "
            "diagonal-plus-site-flip structure (DiagonalOperator / "
            "X-type SiteOperatorSum terms); for static generators any "
            "real banded/BSR operator is supported"
        )
    device = psi0.device
    on_card = device.type == "cuda"
    block = 128 if on_card else 8
    n_logical = int(psi0.shape[-1])
    n_steps = len(tlist) - 1
    dt = workspace.dt if not backward else -workspace.dt
    c64 = np.asarray(workspace.coeffs, dtype=np.float64)

    banded = A = None
    if isinstance(generator, BSROperator) and generator.block_size == block:
        try:  # complex entries or too many bands: decided below
            banded = banded_dd_from_bsr(generator)
        except ValueError:
            pass
    else:
        A = _real_matrix(generator)
        try:
            banded = banded_dd_from_scipy(A, block=block, device=device)
        except ValueError:
            pass

    if banded is not None:
        banded = dataclasses.replace(banded, planes=banded.planes.to(device))
        psi = torch.zeros(banded.shape[0], dtype=torch.complex128,
                          device=device)
        psi[:n_logical] = psi0.reshape(-1)

        def step(psi, _, out=None):
            # the carry and out are the whole padded state
            return cheby_apply_dd_banded(banded, psi, c64, workspace.delta,
                                         workspace.e_min, dt, out=out)

        # observables and stored states see the unpadded state
        psi, outputs = _scan(step, psi, None, n_steps, observable_fn,
                             store_states, view=lambda s: s[:n_logical])
        return psi[:n_logical], outputs

    if A is None:
        A = _real_matrix(generator)  # raises for complex entries
    op = bsr_from_scipy(A, block_size=None if on_card else 8, device=device)

    def step(psi, _, out=None):
        return cheby_apply(op, psi, c64, workspace.delta, workspace.e_min, dt,
                           forward=not backward, out=out)

    psi = psi0.reshape(-1).to(torch.complex128)
    return _scan(step, psi, None, n_steps, observable_fn, store_states)


def cheby_propagate_fused(
    psi0,
    generator,
    tlist,
    *,
    workspace: Optional[ChebyWorkspace] = None,
    coeffs_table=None,
    observable_fn: Optional[Callable] = None,
    store_states: bool = False,
    backward: bool = False,
    apply_fn=None,
    kernel: str = "auto",
    f32_tail="auto",
    **cheby_kwargs,
):
    """Propagate ``psi0`` over all of ``tlist``.

    ``observable_fn(psi)`` is evaluated after every step; with
    ``store_states=True`` the full trajectory ``(nt-1, N)`` is returned
    instead.  Returns ``(psi_final, outputs)`` where ``outputs`` is
    stacked over steps (or ``None``).

    ``workspace`` defaults to a :class:`ChebyPropagator`-style workspace
    from spectral-range estimation; pass one to skip that.

    ``kernel`` is ``"auto"``, ``"xla"``, ``"pallas"`` or ``"dd"`` (see
    the module docstring).  ``f32_tail`` (``kernel="dd"`` only): the
    last orders of each step in complex64; ``"auto"`` picks the largest
    count whose error bound stays under 3e-14 per step
    (:func:`~.ops.fused_cheby_dd.f32_tail_orders`), ``0`` disables it.
    """
    tlist = np.asarray(tlist, dtype=np.float64)
    psi0 = as_tensor(psi0)
    if isinstance(generator, tuple):
        from .models.generators import hamiltonian

        generator = hamiltonian(*generator, check=False)
    if workspace is None:
        from .propagators.cheby import ChebyPropagator

        prop = ChebyPropagator(psi0, generator, tlist, **cheby_kwargs)
        workspace = prop.wrk
    if coeffs_table is None:
        coeffs_table = coeff_table(generator, tlist)
    if backward:
        coeffs_table = torch.as_tensor(coeffs_table).flip(0)
    if isinstance(generator, Generator):
        ops = generator.ops
    elif isinstance(generator, Operator):
        ops = generator.ops
        coeffs_table = torch.as_tensor(generator.coeffs)[None, :].expand(
            len(tlist) - 1, len(generator.coeffs))
    else:
        ops = [generator]
        coeffs_table = torch.zeros((len(tlist) - 1, 0))
    # keep the loop dtype-stable: tables in the state's real dtype (an
    # f64 control table must not promote a complex64 state)
    rdtype = psi0.dtype.to_real()
    coeffs_table = torch.as_tensor(coeffs_table)
    if coeffs_table.is_complex():
        coeffs_table = coeffs_table.real
    coeffs_table = coeffs_table.to(dtype=rdtype, device=psi0.device)
    cheby_coeff_arr = np.asarray(workspace.coeffs, dtype=np.float64)
    dt = workspace.dt if not backward else -workspace.dt
    if kernel not in ("auto", "xla", "pallas", "dd"):
        raise ValueError(f"unknown kernel={kernel!r}")
    if kernel == "dd":
        from .ops.fused_cheby import flip_structure_multi

        fsm = flip_structure_multi(list(ops))
        if fsm is None:
            # static operators without flip structure: the banded SpMV
            # kernel, or the blocked-ELL product for other sparsity
            psi_final, outputs = _static_dd_path(
                generator, psi0, tlist, workspace, backward, observable_fn,
                store_states,
            )
            return psi_final.reshape(psi0.shape), outputs
        return _dd_path(
            fsm, generator, ops, psi0, tlist, workspace, backward,
            observable_fn, store_states, f32_tail=f32_tail,
        )
    if kernel in ("auto", "pallas") and apply_fn is None:
        fs = flip_structure(list(ops))
        if fs is not None and (kernel == "pallas" or psi0.is_cuda):
            plan, diag, diag_pos, flip_pos = fs
            off = len(ops) - int(coeffs_table.shape[1])
            diag_col = diag_pos - off if diag_pos >= off else None
            flip_col = flip_pos - off if flip_pos >= off else None
            psi_final, outputs = _fused_scan_flip(
                plan, diag, diag_col, flip_col, coeffs_table, psi0,
                cheby_coeff_arr, workspace.delta, workspace.e_min, dt,
                not backward, observable_fn, store_states,
            )
            return psi_final.reshape(psi0.shape), outputs
        if kernel == "pallas":
            raise ValueError(
                "kernel='pallas' requires diagonal-plus-site-flip "
                "structure (one DiagonalOperator + one X-type "
                "SiteOperatorSum term)"
            )
    return _fused_scan(
        list(ops), coeffs_table, psi0, cheby_coeff_arr, workspace.delta,
        workspace.e_min, dt, not backward, observable_fn, store_states,
        apply_fn,
    )


def make_fused_cheby_propagator(
    psi0,
    generator,
    tlist,
    *,
    observable_fn: Optional[Callable] = None,
    store_states: bool = False,
    **cheby_kwargs,
):
    """Build a reusable propagation function for optimal control:
    ``fn(psi0, coeffs_table) -> (psi_final, outputs)`` over the generic
    path, with the workspace fixed once.

    On the card the first call captures the scan's graph and every later
    call with a table of the same shape copies the table into its static
    buffer and replays: one capture for every control update
    (:class:`.utils.scan.GraphedScan`).  While autograd records
    (gradients, GRAPE), the scan is one autograd node whose forward and
    backward are two more captured graphs, kept the same way: a GRAPE
    iteration is ``n`` forward and ``n`` backward replays, its residuals
    stacked per interval as ``jax.lax.scan`` stacks them."""
    tlist = np.asarray(tlist, dtype=np.float64)
    if isinstance(generator, tuple):
        from .models.generators import hamiltonian

        generator = hamiltonian(*generator, check=False)
    from .propagators.cheby import ChebyPropagator

    prop = ChebyPropagator(psi0, generator, tlist, **cheby_kwargs)
    ws = prop.wrk
    if isinstance(generator, (Generator, Operator)):
        ops = list(generator.ops)
    else:
        ops = [generator]

    run = GraphedScan(_with_outputs(
        _generic_step(ops, np.asarray(ws.coeffs), ws.delta, ws.e_min, ws.dt,
                      True, None),
        observable_fn, store_states))

    def fn(psi0, coeffs_table):
        psi0 = as_tensor(psi0)
        return run(psi0, torch.as_tensor(coeffs_table).to(psi0.device))

    return fn
