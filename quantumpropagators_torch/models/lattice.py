"""Structured lattice / spin-chain operators (PyTorch port of
:mod:`quantumpropagators.models.lattice`).

- Pauli-Z strings are diagonal: the whole ZZ+Z part of a spin-chain
  Hamiltonian collapses into ONE diagonal vector.
- A single-site operator ``Mᵢ`` acts on axis ``i`` of the state viewed
  as ``(2^i, 2, 2^(L-1-i))``: two strided elementwise passes, no
  gathers.

Site ``i`` is the MOST significant bit of the state index
(``kron(M_0, M_1, ...)`` convention), i.e. index bit ``L-1-i``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..ops.operators import DiagonalOperator, as_tensor, host_np, resolve_device

__all__ = [
    "SiteOperatorSum",
    "GroupedSiteSum",
    "zz_chain_diagonal",
    "z_chain_diagonal",
    "zz_bonds_diagonal",
    "ising_diagonal_np",
    "chain_bonds",
    "lattice2d_bonds",
    "transverse_field_ising",
    "transverse_field_ising_2d",
    "PAULI",
]

PAULI = {
    "I": np.eye(2, dtype=np.complex128),
    "X": np.array([[0, 1], [1, 0]], dtype=np.complex128),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
    "Z": np.array([[1, 0], [0, -1]], dtype=np.complex128),
}


def _group_dims(L: int, group_bits: int = 10) -> tuple:
    """Split an ``L``-bit chain into contiguous groups of ≤ ``group_bits``
    bits, as evenly as possible."""
    if L <= group_bits:
        return (L,)
    d = -(-L // group_bits)  # ceil
    base, rem = divmod(L, d)
    return tuple([base + 1] * rem + [base] * (d - rem))


@dataclass(frozen=True)
class SiteOperatorSum:
    """``Σᵢ (𝟙 ⊗ … ⊗ Mᵢ ⊗ … ⊗ 𝟙)`` over an ``L``-site qubit chain.

    ``site_mats`` has shape ``(L, 2, 2)`` (per-site operator, already
    scaled by any per-site coefficient); sites marked inactive in
    ``active`` are skipped.  ``group_bits`` is kept for
    :meth:`grouped`.
    """

    site_mats: Any  # (L, 2, 2) tensor
    L: int = 0
    active: tuple = ()  # static tuple of bools; () means all active
    group_bits: int = 10

    @property
    def shape(self):
        return (2 ** self.L, 2 ** self.L)

    def apply(self, psi):
        L = self.L
        lead = psi.shape[:-1]
        active = self.active if self.active else (True,) * L
        dtype = torch.promote_types(psi.dtype, self.site_mats.dtype)
        psi = psi.to(dtype)
        mats = self.site_mats.to(dtype)
        # zeros_like keeps a vmap batch dimension of psi, so the sums
        # below may write batched values into it
        out = torch.zeros_like(psi, memory_format=torch.contiguous_format)
        for i in range(L):
            if not active[i]:
                continue
            M = mats[i]
            v = psi.reshape(lead + (2 ** i, 2, 2 ** (L - 1 - i)))
            x0, x1 = v[..., 0, :], v[..., 1, :]
            o = out.view(lead + (2 ** i, 2, 2 ** (L - 1 - i)))
            o[..., 0, :] += M[0, 0] * x0 + M[0, 1] * x1
            o[..., 1, :] += M[1, 0] * x0 + M[1, 1] * x1
        return out

    def to_dense(self):
        L = self.L
        mats = host_np(self.site_mats)
        active = self.active if self.active else (True,) * L
        H = np.zeros((2 ** L, 2 ** L), dtype=np.complex128)
        for i in range(L):
            if not active[i]:
                continue
            term = np.array([[1.0]], dtype=np.complex128)
            for j in range(L):
                term = np.kron(term, mats[i] if j == i else np.eye(2))
            H += term
        return torch.as_tensor(H, device=self.site_mats.device)

    def grouped(self, group_bits: int = None) -> "GroupedSiteSum":
        """Host-side conversion to :class:`GroupedSiteSum` (precomputed
        group operators)."""
        if group_bits is None:
            group_bits = self.group_bits
        L = self.L
        active = self.active if self.active else (True,) * L
        mats = host_np(self.site_mats)
        group_mats = []
        dims = []
        start = 0
        for nbits in _group_dims(L, group_bits):
            F = 2 ** nbits
            A = np.zeros((F, F), dtype=mats.dtype)
            for i_loc in range(nbits):
                i = start + i_loc
                if not active[i]:
                    continue
                A += np.kron(
                    np.kron(np.eye(2 ** i_loc, dtype=mats.dtype), mats[i]),
                    np.eye(2 ** (nbits - 1 - i_loc), dtype=mats.dtype),
                )
            group_mats.append(torch.as_tensor(A, device=self.site_mats.device))
            dims.append(F)
            start += nbits
        return GroupedSiteSum(group_mats=tuple(group_mats), dims=tuple(dims))


@dataclass(frozen=True)
class GroupedSiteSum:
    """Matricized sum of single-site terms: per contiguous site group
    ``g``, a precomputed dense ``(F_g, F_g)`` operator
    ``A_g = Σ_{i∈g} 𝟙⊗Mᵢ⊗𝟙``, applied as one matmul over that axis of
    the state.  Real group operators applied to complex states contract
    the real and imaginary parts separately."""

    group_mats: tuple  # one (F_g, F_g) tensor per group
    dims: tuple = ()  # (F_0, ..., F_{d-1}); prod = N

    @property
    def shape(self):
        N = int(np.prod(self.dims))
        return (N, N)

    def apply(self, psi):
        N = int(np.prod(self.dims))
        lead = psi.shape[:-1]
        out = None
        pre = 1
        for g, A in enumerate(self.group_mats):
            F = self.dims[g]
            post = N // (pre * F)
            resh = psi.reshape(lead + (pre, F, post))
            if not A.is_complex() and psi.is_complex():
                A = A.to(psi.dtype.to_real())
                term = torch.complex(
                    torch.einsum("ab,...xbz->...xaz", A, resh.real),
                    torch.einsum("ab,...xbz->...xaz", A, resh.imag),
                )
            else:
                dtype = torch.promote_types(A.dtype, psi.dtype)
                term = torch.einsum("ab,...xbz->...xaz", A.to(dtype),
                                    resh.to(dtype))
            term = term.reshape(lead + (N,))
            out = term if out is None else out + term
            pre *= F
        if out is None:
            out = torch.zeros_like(psi)
        return out

    def to_dense(self):
        N = int(np.prod(self.dims))
        H = np.zeros((N, N), dtype=np.complex128)
        pre = 1
        for g, A in enumerate(self.group_mats):
            F = self.dims[g]
            post = N // (pre * F)
            H += np.kron(
                np.kron(np.eye(pre), host_np(A).astype(np.complex128)),
                np.eye(post),
            )
            pre *= F
        return torch.as_tensor(H, device=self.group_mats[0].device)


def _spin(L: int, site: int, dtype=torch.float32, device=None):
    """±1 value of ``σᶻ`` at ``site`` on each of the 2^L basis states
    (site 0 = most significant bit)."""
    idx = torch.arange(2 ** L, dtype=torch.int64, device=device)
    bit = (idx >> (L - 1 - site)) & 1
    return (1 - 2 * bit).to(dtype)


def zz_chain_diagonal(L: int, J=1.0, *, periodic: bool = False,
                      dtype=torch.float32, device=None):
    """Diagonal of ``J Σᵢ σᶻᵢ σᶻᵢ₊₁`` as a length-2^L vector."""
    bonds = [(i, i + 1) for i in range(L - 1)]
    if periodic:
        bonds.append((L - 1, 0))
    return zz_bonds_diagonal(L, bonds, J, dtype=dtype, device=device)


def z_chain_diagonal(L: int, h=1.0, *, dtype=torch.float32, device=None):
    """Diagonal of ``Σᵢ hᵢ σᶻᵢ`` as a length-2^L vector."""
    h = np.broadcast_to(np.asarray(h, dtype=np.float64), (L,))
    device = resolve_device(device)
    diag = torch.zeros(2 ** L, dtype=dtype, device=device)
    for i in range(L):
        diag += float(h[i]) * _spin(L, i, dtype, device)
    return diag


def zz_bonds_diagonal(L: int, bonds, J=1.0, *, dtype=torch.float32,
                      device=None):
    """Diagonal of ``Σ_b J_b σᶻ_{i_b} σᶻ_{j_b}`` for an arbitrary bond
    list, built bond by bond (O(2^L) peak memory)."""
    J = np.broadcast_to(np.asarray(J, dtype=np.float64), (len(bonds),))
    device = resolve_device(device)
    diag = torch.zeros(2 ** L, dtype=dtype, device=device)
    for (i, j), Jb in zip(bonds, J):
        diag += float(Jb) * _spin(L, i, dtype, device) * _spin(L, j, dtype,
                                                                device)
    return diag


def ising_diagonal_np(L: int, bonds, J=1.0, h=0.0) -> np.ndarray:
    """Host-side float64 diagonal ``Σ_b J_b σᶻᵢσᶻⱼ + Σᵢ hᵢ σᶻᵢ``
    (site ``i`` is the MSB-first position).  Each term is one
    broadcast add of its ±value table over the sites' index bits (no
    index array), in the JAX function's order, so the sums are the
    same."""
    J = np.broadcast_to(np.asarray(J, dtype=np.float64), (len(bonds),))
    h = np.broadcast_to(np.asarray(h, dtype=np.float64), (L,))
    diag = np.zeros((2,) * L, dtype=np.float64)
    s = np.array([1.0, -1.0])

    def axis(i):  # σᶻ of site i along its index bit, broadcastable
        return s.reshape((2,) + (1,) * (L - 1 - i))

    for (i, j), Jb in zip(bonds, J):
        diag += Jb * (axis(i) * axis(j))
    for i in range(L):
        if h[i] != 0.0:
            diag += h[i] * axis(i)
    return diag.reshape(-1)


def chain_bonds(L: int, periodic: bool = False):
    """Nearest-neighbor bond list of a 1D chain."""
    bonds = [(i, i + 1) for i in range(L - 1)]
    if periodic and L > 2:
        bonds.append((L - 1, 0))
    return bonds


def lattice2d_bonds(Lx: int, Ly: int, periodic: bool = False):
    """Nearest-neighbor bond list of an ``Lx × Ly`` lattice (site
    ``(x, y)`` at chain position ``x·Ly + y``)."""
    bonds = []
    for x in range(Lx):
        for y in range(Ly):
            s = x * Ly + y
            if x + 1 < Lx:
                bonds.append((s, (x + 1) * Ly + y))
            elif periodic and Lx > 2:
                bonds.append((s, y))
            if y + 1 < Ly:
                bonds.append((s, x * Ly + y + 1))
            elif periodic and Ly > 2:
                bonds.append((s, x * Ly))
    return bonds


def _tfim_terms(L, bonds, J, g, h, dtype, device):
    device = resolve_device(device)
    rdtype = dtype.to_real()
    diag = zz_bonds_diagonal(L, bonds, J, dtype=rdtype, device=device)
    if h != 0.0:
        diag = diag + z_chain_diagonal(L, h, dtype=rdtype, device=device)
    H_diag = DiagonalOperator(diag.to(dtype))
    sx = np.asarray(PAULI["X"].real)
    site_mats = as_tensor(np.stack([g * sx for _ in range(L)]), dtype=dtype,
                          device=device)
    return H_diag, SiteOperatorSum(site_mats, L=L)


def transverse_field_ising_2d(
    Lx: int,
    Ly: int,
    *,
    J: float = 1.0,
    g: float = 1.0,
    h: float = 0.0,
    periodic: bool = False,
    dtype=torch.complex64,
    device=None,
):
    """2D transverse-field Ising on an ``Lx × Ly`` lattice
    (``H = J Σ_<ij> σᶻᵢσᶻⱼ + h Σ σᶻᵢ + g Σ σˣᵢ``), site ``(x,y)`` at
    chain position ``x·Ly + y``.  Returns ``(H_diag, H_x)``."""
    L = Lx * Ly
    bonds = lattice2d_bonds(Lx, Ly, periodic=periodic)
    return _tfim_terms(L, bonds, J, g, h, dtype, device)


def transverse_field_ising(
    L: int,
    *,
    J: float = 1.0,
    g: float = 1.0,
    h: float = 0.0,
    periodic: bool = False,
    dtype=torch.complex64,
    device=None,
):
    """Transverse-field Ising Hamiltonian
    ``H = J Σ σᶻᵢσᶻᵢ₊₁ + h Σ σᶻᵢ + g Σ σˣᵢ`` on ``L`` qubits.

    Returns ``(H_diag, H_x)``: a :class:`DiagonalOperator` holding the
    ZZ+Z part and a :class:`SiteOperatorSum` holding the transverse part.
    Combine as ``hamiltonian(H_diag, (H_x, drive))`` for a driven chain.
    """
    bonds = [(i, i + 1) for i in range(L - 1)]
    if periodic:
        bonds.append((L - 1, 0))
    return _tfim_terms(L, bonds, J, g, h, dtype, device)
