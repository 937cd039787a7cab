"""Generator / Operator algebra (PyTorch port of
:mod:`quantumpropagators.models.generators`).

A :class:`Generator` represents ``Ĥ(t) = Ĥ₀ + Σₗ aₗ(t) Ĥₗ`` as static
operator terms plus amplitudes (reference ``src/generators.jl:44-61``).
Evaluating it at a point in time yields an :class:`Operator` — a lazy
sum ``Σₗ cₗ Ĥₗ`` of the (immutable) terms with a coefficient vector.
For whole propagations the amplitudes are evaluated once into an
``(nt-1, n_amplitudes)`` coefficient table (:func:`coeff_table`).
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from ..ops import operators as _ops
from ..ops.operators import add_operators, apply, is_operator, to_dense
from ..utils.iddict import IdDict
from .controls import evaluate, get_controls, substitute

__all__ = [
    "Generator",
    "Operator",
    "ScaledOperator",
    "hamiltonian",
    "liouvillian",
    "coeff_table",
    "coeff_table_np",
]


def _scalar(c):
    """A coefficient as something that multiplies a tensor without
    leaving its device: 0-d tensors stay, numpy scalars become Python
    numbers."""
    if isinstance(c, torch.Tensor):
        return c
    c = complex(c)
    return c.real if c.imag == 0 else c


class Operator:
    """Lazy static operator ``Σₗ cₗ Ĥₗ``.

    If ``len(coeffs) < len(ops)``, the first ``len(ops) - len(coeffs)``
    operators are drift terms with an implicit coefficient of 1
    (reference ``src/generators.jl:100-125``).
    """

    def __init__(self, ops: Sequence, coeffs):
        ops = list(ops)
        if not isinstance(coeffs, (torch.Tensor, np.ndarray)):
            coeffs = np.asarray(coeffs)
        if len(coeffs) > len(ops):
            raise ValueError(
                "The number of coefficients cannot exceed the number of "
                "operators in an Operator"
            )
        self.ops = ops
        self.coeffs = coeffs

    @property
    def drift_offset(self) -> int:
        return len(self.ops) - len(self.coeffs)

    @property
    def shape(self):
        return _ops.op_shape(self.ops[0])

    def apply(self, psi):
        off = self.drift_offset
        out = None
        for i, op in enumerate(self.ops):
            term = apply(op, psi)
            if i >= off:
                term = _scalar(self.coeffs[i - off]) * term
            out = term if out is None else out + term
        return out

    def to_dense(self):
        off = self.drift_offset
        acc = None
        for i, op in enumerate(self.ops):
            A = to_dense(op)
            if i >= off:
                A = _scalar(self.coeffs[i - off]) * A
            if acc is None:
                acc = A
            else:
                acc, A = _ops._promote(acc, A)
                acc = acc + A
        return acc

    def _get_controls(self):
        return ()

    def _evaluate(self, *args, vals_dict=None):
        return self

    def _substitute(self, replacements):
        ops = [substitute(op, replacements) for op in self.ops]
        return Operator(ops, self.coeffs)

    def __getitem__(self, idx):
        """Matrix-interface read access ``O[i, j]``: the lazily-summed
        entry."""
        return self.to_dense()[idx]

    def ishermitian(self, tol: float = 1e-12) -> bool:
        """Best-effort hermiticity check (densifies)."""
        A = _ops.host_np(self.to_dense())
        return bool(np.allclose(A, A.conj().T, atol=tol))

    def __repr__(self):
        return f"Operator({len(self.ops)} ops, coeffs={self.coeffs!r})"


class ScaledOperator:
    """Lazy ``α · Ĥ`` (reference ``src/generators.jl:238-249``)."""

    def __init__(self, coeff, operator):
        if isinstance(operator, ScaledOperator):
            coeff = coeff * operator.coeff
            operator = operator.operator
        self.coeff = coeff
        self.operator = operator

    @property
    def shape(self):
        return _ops.op_shape(self.operator)

    def apply(self, psi):
        return _scalar(self.coeff) * apply(self.operator, psi)

    def to_dense(self):
        return _scalar(self.coeff) * to_dense(self.operator)

    def _get_controls(self):
        return ()

    def _evaluate(self, *args, vals_dict=None):
        return self

    def _substitute(self, replacements):
        return ScaledOperator(self.coeff, substitute(self.operator, replacements))

    def __repr__(self):
        return f"ScaledOperator({self.coeff!r}, {self.operator!r})"


class Generator:
    """Time-dependent generator ``Ĥ(t) = Σ (drift) + Σₗ aₗ(t) Ĥₗ``.

    ``ops`` contains first the drift terms (no amplitude), then one term
    per amplitude; ``amplitudes`` are controls (callables / midpoint
    arrays / amplitude objects).  Host-side only.
    """

    def __init__(self, ops: Sequence, amplitudes: Sequence):
        ops = list(ops)
        amplitudes = list(amplitudes)
        if len(amplitudes) > len(ops):
            raise ValueError("A Generator requires at least as many operators as amplitudes")
        if len(amplitudes) == 0:
            raise ValueError(
                "A Generator requires at least one amplitude; use a plain "
                "operator for static dynamics"
            )
        shapes = {tuple(_ops.op_shape(op)) for op in ops}
        if len(shapes) > 1:
            raise ValueError(f"All operators must have the same shape, got {shapes}")
        self.ops = ops
        self.amplitudes = amplitudes

    @property
    def drift_offset(self) -> int:
        return len(self.ops) - len(self.amplitudes)

    @property
    def shape(self):
        return _ops.op_shape(self.ops[0])

    def _get_controls(self):
        controls = []
        for ampl in self.amplitudes:
            for c in get_controls(ampl):
                if not any(c is k for k in controls):
                    controls.append(c)
        return tuple(controls)

    def _evaluate(self, *args, vals_dict=None) -> Operator:
        """Evaluate to a static :class:`Operator` at a point in time
        (reference ``src/generators.jl:740-753``)."""
        if vals_dict is None:
            vals_dict = IdDict()
        coeffs = []
        for i, ampl in enumerate(self.amplitudes):
            c = evaluate(ampl, *args, vals_dict=vals_dict)
            if not isinstance(c, (int, float, complex, np.number)) and not (
                hasattr(c, "ndim") and np.ndim(c) == 0
            ):
                raise TypeError(
                    f"amplitude {i} evaluates to {type(c)}, not a number"
                )
            coeffs.append(c)
        return Operator(self.ops, np.asarray(coeffs))

    def _substitute(self, replacements):
        ops = [substitute(op, replacements) for op in self.ops]
        amplitudes = [substitute(a, replacements) for a in self.amplitudes]
        return Generator(ops, amplitudes)

    def __repr__(self):
        return (
            f"Generator({len(self.ops)} ops, {len(self.amplitudes)} amplitudes)"
        )


def hamiltonian(*terms, check: bool = True):
    """Construct a time-dependent Hamiltonian from operator terms.

    Each term is either a static operator (drift) or a 2-tuple
    ``(op, amplitude)``.  Terms with identical amplitudes (by equality
    for numbers, identity otherwise) are merged; drift terms are summed.
    Returns a plain operator if there are no amplitudes, an
    :class:`Operator` if all amplitudes are static numbers, or a
    :class:`Generator` (reference ``src/generators.jl:388-469``).
    """
    ops: list = []
    amplitudes: list = []
    drift: list = []
    for term in terms:
        if isinstance(term, (tuple, list)):
            if len(term) != 2:
                raise ValueError("time-dependent term must be a 2-tuple (op, ampl)")
            op, ampl = term
            if check and is_operator(ampl) and not is_operator(op):
                warnings.warn("It looks like (op, ampl) in term are reversed")
            idx = None
            for i, a in enumerate(amplitudes):
                same = (a is ampl) or (
                    isinstance(a, (int, float, complex))
                    and isinstance(ampl, (int, float, complex))
                    and a == ampl
                )
                if same:
                    idx = i
                    break
            if idx is None:
                ops.append(op)
                amplitudes.append(ampl)
            else:
                ops[idx] = add_operators(ops[idx], op)
        else:
            if len(drift) == 0:
                drift.append(term)
            else:
                drift[0] = add_operators(drift[0], term)
    all_ops = drift + ops
    if len(amplitudes) == 0:
        if len(drift) == 0:
            raise ValueError("Generator has no terms")
        return drift[0]
    if all(isinstance(a, (int, float, complex, np.number)) for a in amplitudes):
        return Operator(all_ops, np.asarray(amplitudes))
    return Generator(all_ops, amplitudes)


# --------------------------------------------------------------------------
# Liouvillian (vectorized Lindblad master equation)
# --------------------------------------------------------------------------

def _ham_to_superop(H, convention: str):
    """``vec(Hρ - ρH)`` generator: ``L = 𝟙⊗H − Hᵀ⊗𝟙`` (column-stacking
    convention, reference ``src/generators.jl:473-490``)."""
    import scipy.sparse as sp

    H = _ops.to_scipy_sparse(H).tocsr().astype(np.complex128)
    Id = sp.identity(H.shape[0], dtype=np.complex128, format="csr")
    L = sp.kron(Id, H) - sp.kron(H.T, Id)
    if convention == "TDSE":
        return L.tocsr()
    if convention == "LvN":
        return (1j * L).tocsr()
    raise ValueError("convention must be 'TDSE' or 'LvN'")


def _lindblad_to_superop(A, convention: str):
    """Dissipator superoperator for a single Lindblad operator
    (reference ``src/generators.jl:493-513``)."""
    import scipy.sparse as sp

    A = _ops.to_scipy_sparse(A).tocsr().astype(np.complex128)
    Ad = A.conj().T.tocsr()
    AdA = (Ad @ A).tocsr()
    Id = sp.identity(A.shape[0], dtype=np.complex128, format="csr")
    D = sp.kron(Ad.T, A) - 0.5 * sp.kron(Id, AdA) - 0.5 * sp.kron(AdA.T, Id)
    if convention == "TDSE":
        return (1j * D).tocsr()
    if convention == "LvN":
        return D.tocsr()
    raise ValueError("convention must be 'TDSE' or 'LvN'")


def liouvillian(H=None, c_ops=(), *, convention: str):
    """Build the Liouvillian superoperator for a (time-dependent)
    Hamiltonian and collapse operators (reference
    ``src/generators.jl:571-631``).  With ``convention='TDSE'``,
    ``i ∂ₜ ρ⃗ = L ρ⃗``; with ``'LvN'``, ``∂ₜ ρ⃗ = L ρ⃗``.  States are
    column-stacked ``vec(ρ)``."""
    from ..ops.operators import csr_from_scipy

    if isinstance(H, tuple):
        H = hamiltonian(*H, check=False)
    device = _ops.op_device(H) if H is not None else None
    terms = []
    if isinstance(H, Generator):
        off = H.drift_offset
        drift_sup = None
        for i, op in enumerate(H.ops):
            L = _ham_to_superop(op, convention)
            if i < off:
                drift_sup = L if drift_sup is None else drift_sup + L
            else:
                terms.append((csr_from_scipy(L, device=device),
                              H.amplitudes[i - off]))
        if c_ops:
            D = None
            for A in c_ops:
                DA = _lindblad_to_superop(A, convention)
                D = DA if D is None else D + DA
            drift_sup = D if drift_sup is None else drift_sup + D
        if drift_sup is not None:
            terms.insert(0, csr_from_scipy(drift_sup, device=device))
        return hamiltonian(*terms, check=False)
    L = None
    if H is not None:
        L = _ham_to_superop(H, convention)
    for A in c_ops:
        DA = _lindblad_to_superop(A, convention)
        L = DA if L is None else L + DA
    if L is None:
        raise ValueError("liouvillian requires a Hamiltonian and/or collapse operators")
    return csr_from_scipy(L.tocsr(), device=device)


# --------------------------------------------------------------------------
# Coefficient tables
# --------------------------------------------------------------------------

def coeff_table_np(generator, tlist, *, vals_dict=None):
    """Host-side float64 (complex128 if any amplitude is complex)
    coefficient table, ``(nt-1, n_amplitudes)``."""
    if isinstance(generator, Operator):
        nt = len(np.asarray(tlist))
        return np.broadcast_to(
            np.asarray(_ops.host_np(generator.coeffs), dtype=np.float64),
            (nt - 1, len(generator.coeffs)),
        )
    if not isinstance(generator, Generator):
        nt = len(np.asarray(tlist))
        return np.zeros((nt - 1, 0))
    tlist = np.asarray(tlist, dtype=np.float64)
    nt = len(tlist)
    n_ampl = len(generator.amplitudes)
    C = np.zeros((nt - 1, n_ampl), dtype=np.complex128)
    for l, ampl in enumerate(generator.amplitudes):
        for n in range(nt - 1):
            C[n, l] = evaluate(ampl, tlist, n, vals_dict=vals_dict)
    if np.all(C.imag == 0):
        C = C.real
    return C


def coeff_table(generator, tlist, *, vals_dict=None, dtype=None):
    """Pre-evaluate all amplitudes of ``generator`` on the midpoints of
    ``tlist``: an ``(nt-1, n_amplitudes)`` tensor ``C`` with
    ``C[n, l] = aₗ(t_mid(tlist, n))`` (reference
    ``src/pwc_utils.jl:29-45``)."""
    if isinstance(generator, Operator):
        C = np.broadcast_to(_ops.host_np(generator.coeffs),
                            (len(np.asarray(tlist)) - 1,
                             len(generator.coeffs)))
    else:
        C = coeff_table_np(generator, tlist, vals_dict=vals_dict)
    C = np.array(C)
    if dtype is not None:
        return torch.as_tensor(C, dtype=dtype)
    return torch.as_tensor(C)
