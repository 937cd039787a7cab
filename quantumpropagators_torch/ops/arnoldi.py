"""Arnoldi iteration and Hessenberg utilities (PyTorch port of
:mod:`quantumpropagators.ops.arnoldi`).

Builds the Krylov factorization of ``H·dt`` from a starting state
(reference ``src/arnoldi.jl``), with classical Gram-Schmidt and one
reorthogonalization (CGS2): each orthogonalization is two matrix-vector
products against the basis built so far.  As the JAX ``_arnoldi_impl``
(``jax.jit`` of a ``fori_loop``), the loop always runs ``m``
iterations: Krylov breakdown is masked on the device (``done``,
``m_eff`` and ``Hess`` are device tensors) and the host reads ``Hess``
and ``m_eff`` once, after the call.

The call runs through a graphed site (:func:`~..utils.scan.graphed`,
keyed on the operator's terms, ``m`` and ``extended``; the state, the
operator's amplitudes, ``dt`` and ``norm_min`` are per-call data), so
that on the card each call replays one CUDA graph.  A site holds a
basis in its own memory pool, so it lives no longer than its owner: an
:class:`ArnoldiSites` entered with :func:`arnoldi_sites` by a
propagator for its steps, by the spectral envelope for its two
``specrange`` calls, or by one ``newton_apply`` call for its restarts.
A site lends its basis: the basis a call returns is the graph's own,
valid until the site's next call, and a key's first call runs eagerly,
its capture waiting for the second, so that a site never holds two
bases.  A scope has a site for each ``m`` it is called with (one,
unless a restart after a Krylov breakdown or ``expv``'s doubling asks
for a smaller or larger basis), so that alternating dimensions replay
their graphs instead of capturing anew.  The same scope holds the sites
that read a lent basis in place (Newton's restart tail, ``expv``'s
combine).  A host matrix among the terms is copied onto the state's
device once a scope (:class:`~.operators.DeviceCopies`).  A call
outside every scope runs the body once, as there is nothing to
replay.

The state may be sharded: with an operator that carries a shard-slot
mesh (:func:`~.operators.op_mesh`), ``psi`` is this rank's
``(n_local, N/n)`` slots, the basis keeps that layout, and the
projections and norms sum per-slot partial sums over every slot with
the mesh's ``psum`` (the reductions XLA inserts for a GSPMD-sharded
state in the JAX package), so ``Hess`` is the same on every rank.  A
mesh whose group spans more than one rank runs the body eagerly (no
cross-rank capture).
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

from .operators import (DeviceCopies, apply, device_scalar, host_np, op_mesh,
                        sharded_dim, sharded_norm)

__all__ = ["arnoldi", "diagonalize_hessenberg_matrix", "ArnoldiSites",
           "arnoldi_sites"]


def _project(basis, w, mesh):
    """``Σₖ conj(basis[i, k])·w[k]`` for each row ``i`` of the flat basis
    (over every slot when there is a mesh)."""
    if mesh is None:
        return (basis @ w.conj()).conj()
    rows = basis.shape[0]
    part = torch.einsum("isk,sk->si",
                        basis.reshape(rows, mesh.n_local, -1).conj(),
                        w.reshape(mesh.n_local, -1))
    return mesh.psum(part)


def _cgs2(basis, w, mesh):
    """Classical Gram-Schmidt of ``w`` against the rows of the flat
    ``basis``, twice: returns ``w`` orthogonalized and its coordinates
    (the Hessenberg column)."""
    hcol = torch.zeros(basis.shape[0], dtype=w.dtype, device=w.device)
    for _ in range(2):
        proj = _project(basis, w, mesh)
        w = w - proj @ basis
        hcol = hcol + proj
    return w, hcol


def _split(op):
    """``(terms, amplitudes)``: an :class:`~..models.generators.Operator`
    as its term operators (read in place by a graph) and its
    coefficients (data that changes from call to call); any other
    operator as itself and ``None``."""
    from ..models.generators import Operator

    if isinstance(op, Operator):
        return ("operator", tuple(op.ops)), op.coeffs
    return ("op", op), None


def _join(terms, amps):
    """The operator :func:`_split` took apart."""
    from ..models.generators import Operator

    kind, part = terms
    return Operator(list(part), amps) if kind == "operator" else part


def _arnoldi_impl(op, amps, psi, m: int, dt, norm_min, extended: bool,
                  basis: bool, join=_join):
    """The body of every Arnoldi call: ``m`` CGS2 iterations of
    ``join(op, amps)`` from ``psi``, breakdown masked on the device.
    Returns the device tensors ``(Hess, q, m_eff)`` (``(Hess, m_eff)``
    without ``basis``); ``Hess`` is ``(m+1, m+1)`` in the state's complex
    dtype, ``m_eff`` a 0-d int64."""
    op = join(op, amps)
    _N, mesh = sharded_dim(op, psi)
    cdtype = torch.promote_types(psi.dtype, torch.complex64)
    rdtype = torch.float64 if cdtype == torch.complex128 else torch.float32
    dev = psi.device
    shape = tuple(psi.shape)
    dt = device_scalar(dt, dev, rdtype)
    norm_min = device_scalar(norm_min, dev, rdtype)
    q = torch.zeros((m + 1, psi.numel()), dtype=cdtype, device=dev)
    q[0] = psi.reshape(-1)
    Hess = torch.zeros((m + 1, m + 1), dtype=cdtype, device=dev)
    m_eff = torch.full((), m, dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    inf = torch.full((), float("inf"), dtype=rdtype, device=dev)
    for j in range(m):
        w = apply(op, q[j].view(shape)).to(cdtype).reshape(-1)
        w, hcol = _cgs2(q[: j + 1], w, mesh)
        h = sharded_norm(w, mesh)
        breakdown = h < norm_min
        # column j: dt·hcol and the subdiagonal dt·h, unless done
        # (a breakdown before j, when q[j] is zero)
        col = torch.cat([dt * hcol, (dt * h).to(cdtype).reshape(1)])
        Hess[: j + 2, j] = torch.where(done, Hess[: j + 2, j], col)
        # q[j+1] = w/h, or stays zero from breakdown on (w/inf)
        stop = done | breakdown | (h <= 0)
        torch.div(w, torch.where(stop, inf, h), out=q[j + 1])
        m_eff = torch.where(done | ~breakdown, m_eff, j + 1)
        done = done | breakdown
    if not extended and m >= 1:
        Hess[m, m - 1].zero_()
    if basis:
        return Hess, q.view((m + 1,) + shape), m_eff
    return Hess, m_eff


class ArnoldiSites:
    """The graphed Krylov sites of one owner (a propagator, one spectral
    envelope, one ``newton_apply``): the Arnoldi calls, Newton's restart
    tail, ``expv``'s combine and the standalone dd Chebyshev applies,
    each a :func:`~..utils.scan.graphed` site capturing into a pool of
    its own, so that dropping the owner frees its bases and graphs, and
    the owner's copies of host terms on the device (:attr:`copies`).

    A site holds one graph, and a call with another key captures anew,
    so a body gets a site for each ``part`` it is called with (the
    Krylov dimension: a restart after a breakdown, ``expv``'s doubled
    ``m``), and each captures once however the parts alternate."""

    def __init__(self):
        self._sites = {}
        self.copies = DeviceCopies()

    def site(self, body, part=None, **how):
        """The graphed site of ``body`` for ``part`` (made at its first
        use with :func:`~..utils.scan.graphed`'s keywords ``how``; by
        default a lending site reading ``op`` in place)."""
        if (body, part) not in self._sites:
            from ..utils.scan import graphed

            how = {"operators": ("op",), "own_pool": True, "lend": True,
                   **how}
            self._sites[body, part] = graphed(body, **how)
        return self._sites[body, part]

    @property
    def captures(self) -> int:
        """The captures of all its sites."""
        return sum(s.captures for s in self._sites.values())

    def captures_of(self, *bodies) -> int:
        """The captures of the sites of ``bodies``, over all parts."""
        return sum(s.captures for (body, _), s in self._sites.items()
                   if body in bodies)

    def parts(self, body) -> list:
        """The parts ``body`` has a site for."""
        return [part for b, part in self._sites if b is body]


#: the :class:`ArnoldiSites` of the innermost :func:`arnoldi_sites` block
_SCOPE = contextvars.ContextVar("arnoldi_sites", default=None)


@contextlib.contextmanager
def arnoldi_sites(sites=None):
    """Run the Arnoldi calls inside through ``sites`` (an
    :class:`ArnoldiSites`).  Without ``sites``: the enclosing scope's,
    or a new one that lives until the block ends."""
    active = _SCOPE.get()
    if sites is None and active is not None:
        yield active
        return
    sites = ArnoldiSites() if sites is None else sites
    token = _SCOPE.set(sites)
    try:
        yield sites
    finally:
        _SCOPE.reset(token)


def graphed_call(body, how, mesh, *args, part=None):
    """``body(*args)`` through the active scope's graphed site of
    ``body`` for ``part`` (:meth:`ArnoldiSites.site`; ``how`` names its
    controls), or run once: outside every scope, and on a ``mesh`` whose
    group spans more than one rank."""
    sites = _SCOPE.get()
    if sites is None or (mesh is not None and mesh.world_size > 1):
        return body(*args)
    return sites.site(body, part, **how)(*args)


def _combine(x, q, k: int):
    """``Σᵢ xᵢ qᵢ`` over the first ``k`` rows of the basis ``q`` for the
    complex coordinates ``x`` (a host array, or a site's buffer on the
    basis's device)."""
    c = torch.as_tensor(x).to(q.device, q.dtype)
    return torch.tensordot(c, q[:k], dims=1)


def _read(Hess, m_eff):
    """``Hess`` as a host complex128 array and ``m_eff`` as an int, in
    one read from the device."""
    flat = torch.cat([Hess.reshape(-1), m_eff.to(Hess.dtype).reshape(1)])
    flat = host_np(flat).astype(np.complex128)
    return flat[:-1].reshape(Hess.shape), int(flat[-1].real)


def _arnoldi(op, psi, m: int, dt: float = 1.0, *, extended: bool = True,
             norm_min: float = 1e-15, basis: bool = True):
    terms, amps = _split(op)
    sites = _SCOPE.get()
    if sites is not None:
        kind, part = terms
        terms = (kind, tuple(sites.copies(t, psi.device) for t in part)
                 if kind == "operator" else sites.copies(part, psi.device))
    out = graphed_call(_arnoldi_impl, {"controls": ("amps", "dt",
                                                    "norm_min")},
                       op_mesh(op), terms, amps, psi, int(m), float(dt),
                       float(norm_min), bool(extended), bool(basis),
                       part=int(m))
    Hess, m_eff = _read(out[0], out[-1])
    return Hess, (out[1] if basis else None), m_eff


def arnoldi(op, psi, m: int, dt: float = 1.0, *, extended: bool = True,
            norm_min: float = 1e-15):
    """Compute the (extended) Arnoldi factorization of ``H·dt`` from
    ``psi`` (which must be normalized).

    Returns ``(Hess, q, m_eff)``: the ``(m+1, m+1)`` Hessenberg matrix
    of ``H·dt`` as a host complex128 array (the extended bottom row
    populated iff ``extended``), the ``(m+1, N)`` orthonormal Krylov
    basis on ``psi``'s device (``(m+1,) + psi.shape`` for a sharded
    state; rows past ``m_eff`` are zero), and the effective Krylov
    dimension ``m_eff ≤ m`` (reference ``src/arnoldi.jl:60-100``).
    Inside an :func:`arnoldi_sites` scope ``q`` may be the site's own
    buffer, valid until the scope's next Arnoldi call.
    """
    return _arnoldi(op, psi, m, dt, extended=extended, norm_min=norm_min)


def diagonalize_hessenberg_matrix(Hess, m: int, *, accumulate: bool = False):
    """Eigenvalues of the leading ``m×m`` block of ``Hess`` (host-side).

    With ``accumulate=True``, concatenates the eigenvalues of all
    leading sub-blocks of size 1..m (reference
    ``src/arnoldi.jl:143-170``).
    """
    H = host_np(Hess)[:m, :m]
    js = range(1, m + 1) if accumulate else [m]
    out = []
    for j in js:
        if j == 1:
            out.append(np.array([H[0, 0]]))
        elif j == 2:
            a, b = H[0, 0], H[0, 1]
            c, d = H[1, 0], H[1, 1]
            s = np.sqrt(a ** 2 + 4 * b * c - 2 * a * d + d ** 2 + 0j)
            out.append(np.array([0.5 * (a + d - s), 0.5 * (a + d + s)]))
        else:
            out.append(np.linalg.eigvals(H[:j, :j]))
    return np.concatenate(out).astype(np.complex128)
