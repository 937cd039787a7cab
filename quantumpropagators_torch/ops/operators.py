"""Operator containers and the ``apply`` protocol (PyTorch port of
:mod:`quantumpropagators.ops.operators`).

Every propagation kernel is generic over any operator that implements
``apply(op, psi) -> psi'`` (the analogue of the reference's 3-arg
``mul!``).  Operators hold torch tensors; the device of an operator is
the device of its tensors, and ``apply`` runs wherever the state and the
operator live.

Operator types:

- 2D ``torch.Tensor`` / ``numpy`` arrays (dense)
- :class:`DiagonalOperator` — elementwise multiply
- :class:`CSROperator` — gather + ``index_add`` SpMV (sorted rows)
- :class:`StackedCSROperator` — several terms sharing one sparsity
  pattern, contracted into one SpMV
- :class:`DIAOperator` — row-aligned diagonals, shifted multiplies
- :class:`BSROperator` — dense ``(b, b)`` blocks in blocked-ELL layout
- :class:`~..models.generators.Operator` — lazy sum Σ cₗ Ĥₗ

States are tensors with the Hilbert dimension on the *last* axis;
leading axes are batch dimensions.  A *sharded* state is the exception:
this rank's ``(n_local, N/n)`` slots of a shard-slot mesh
(:mod:`..parallel.mesh`).  Only an operator that carries the mesh
(:func:`op_mesh`) takes one, and reductions over it go through
:func:`sharded_vdot` / :func:`sharded_norm`, which sum per-slot partial
sums with the mesh's ``psum``.

Tensors built from host data go to the package's default device
(:func:`default_device`, initially ``cuda``) unless the caller names
one; :func:`set_default_device` changes it (``"cpu"`` for CPU use).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

__all__ = [
    "DiagonalOperator",
    "CSROperator",
    "StackedCSROperator",
    "DIAOperator",
    "dia_from_scipy",
    "BSROperator",
    "bsr_from_scipy",
    "bsr_from_dense",
    "choose_block_size",
    "apply",
    "op_dot",
    "to_dense",
    "to_scipy_sparse",
    "op_shape",
    "op_device",
    "csr_from_scipy",
    "csr_from_dense",
    "add_operators",
    "scale_operator",
    "is_operator",
    "as_tensor",
    "host_np",
    "vdot",
    "op_mesh",
    "sharded_dim",
    "sharded_vdot",
    "sharded_norm",
    "default_device",
    "set_default_device",
    "resolve_device",
]

_DEFAULT_DEVICE = torch.device("cuda")


def default_device() -> torch.device:
    """The device that builders use when the caller names none."""
    return _DEFAULT_DEVICE


def set_default_device(device) -> None:
    """Set the device that builders use when the caller names none."""
    global _DEFAULT_DEVICE
    _DEFAULT_DEVICE = torch.device(device)


def resolve_device(device=None) -> torch.device:
    """``device``, or the package default when it is ``None``.  Raises
    when the result is a CUDA device and none is present: there is no
    silent CPU fallback."""
    device = _DEFAULT_DEVICE if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' or call "
            "quantumpropagators_torch.set_default_device('cpu')"
        )
    return device


def as_tensor(x, *, device=None, dtype=None) -> torch.Tensor:
    """``x`` (tensor, numpy array, or anything array-like) as a torch
    tensor; tensors are moved/cast only when asked, other input is
    copied to ``device`` (default: :func:`default_device`)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=dtype if dtype is not None else x.dtype)
    arr = np.array(x)
    return torch.as_tensor(arr, dtype=dtype, device=resolve_device(device))


def host_np(x) -> np.ndarray:
    """Host numpy copy of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def device_scalar(x, device, dtype=torch.float64) -> torch.Tensor:
    """``x`` as a 0-d ``dtype`` tensor on ``device``: a tensor is cast
    where it is needed, a number written there by a fill, so that
    neither reads nor copies host memory and a CUDA graph captures
    either (the number as the fill's constant)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


class DeviceCopies:
    """Dense operator terms on another device than the state (a numpy
    matrix, a tensor on the host) copied onto the state's device once,
    and kept as long as this object: :func:`apply` would copy such a
    term at every matvec, a host-to-device copy that a CUDA graph cannot
    capture.  Any other operator is returned as it is."""

    def __init__(self):
        self._copies = {}

    def __call__(self, term, device):
        device = torch.device(device)
        if not _is_dense(term) or (isinstance(term, torch.Tensor)
                                   and term.device == device):
            return term
        key = (id(term), device)
        if key not in self._copies:
            # the term itself is kept too, so that its id is not reused
            self._copies[key] = (term, as_tensor(term, device=device))
        return self._copies[key][1]


def _promote(a: torch.Tensor, b: torch.Tensor):
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype), b.to(dtype)


def vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``Σ conj(x)·y`` over all elements (``jnp.vdot`` semantics)."""
    x, y = _promote(x, y)
    return torch.sum(x.conj().reshape(-1) * y.reshape(-1))


def op_mesh(op):
    """The shard-slot mesh ``op`` carries, or ``None``.

    A mesh is any object with ``psum`` (:class:`~..parallel.mesh.Mesh`;
    ``ops`` does not import ``parallel``).  An operator carries one as
    its ``mesh`` attribute (:class:`~..parallel.sharded_bsr.DistributedBSR`,
    :class:`~..parallel.sharded_chain.ShardedChainOperator`); a composite
    operator carries the one mesh of its parts: the ``ops`` of an
    ``Operator`` or ``Generator``, the ``operator`` of a
    ``ScaledOperator``, the ``terms`` of a ``TermsDDOp``.  Raises
    ``ValueError`` when the parts carry two different meshes."""
    mesh = getattr(op, "mesh", None)
    if mesh is not None or isinstance(op, (torch.Tensor, np.ndarray)):
        return mesh
    parts = list(getattr(op, "ops", None) or getattr(op, "terms", None) or ())
    for name in ("operator", "op"):
        part = getattr(op, name, None)
        if part is not None:
            parts.append(part)
    found = None
    for part in parts:
        mesh = op_mesh(part)
        if mesh is not None:
            if found is not None and mesh is not found:
                raise ValueError("the operator's terms carry two different "
                                 "meshes")
            found = mesh
    return found


def sharded_dim(op, psi):
    """``(N, mesh)``: the global dimension of the state ``psi`` under
    ``op`` and the mesh ``op`` carries (``None`` for a plain operator).

    A plain operator of shape ``(N, N)`` takes a ``(N,)`` state; an
    operator with a mesh takes this rank's ``(n_local, N/n)`` slots (with
    one rank, any tensor of all ``N`` entries).  Anything else raises a
    ``ValueError``, so a sharded state never meets an operator that would
    apply to its slots as if they were a batch.  An operator without a
    shape (a callable) is taken at the state's length."""
    mesh = op_mesh(op)
    shape = getattr(op, "shape", None)
    N = int(shape[1]) if shape is not None and len(shape) == 2 else None
    if mesh is None:
        if N is not None and tuple(psi.shape) != (N,):
            raise ValueError(
                f"a state of shape {tuple(psi.shape)} for an operator of "
                f"shape {tuple(shape)}: a sharded (n_local, N/n) state "
                "needs an operator that carries its mesh "
                "(parallel.sharded_bsr.DistributedBSR, "
                "parallel.sharded_chain.ShardedChainOperator)")
        return (psi.shape[-1] if N is None else N), None
    if N is None or N % mesh.n_devices \
            or psi.numel() != mesh.n_local * (N // mesh.n_devices):
        raise ValueError(
            f"a state of shape {tuple(psi.shape)} is not this rank's "
            f"({mesh.n_local}, N/{mesh.n_devices}) slots of the operator's "
            f"mesh (operator shape {shape})")
    return N, mesh


def sharded_vdot(x: torch.Tensor, y: torch.Tensor, mesh=None) -> torch.Tensor:
    """:func:`vdot` over a whole state; with a ``mesh``, ``x`` and ``y``
    are this rank's slots and the per-slot partial sums are summed over
    every slot by ``mesh.psum`` (one ``all_reduce`` when the mesh has a
    group), the same on every rank."""
    if mesh is None:
        return vdot(x, y)
    x, y = _promote(x, y)
    return mesh.psum((x.conj() * y).reshape(mesh.n_local, -1).sum(-1))


def sharded_norm(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The 2-norm of a whole state (see :func:`sharded_vdot`)."""
    if mesh is None:
        return torch.linalg.vector_norm(x)
    sq = (x.conj() * x).real if x.is_complex() else x * x
    return torch.sqrt(mesh.psum(sq.reshape(mesh.n_local, -1).sum(-1)))


@dataclass(frozen=True)
class DiagonalOperator:
    """A diagonal operator; ``apply`` is an elementwise product."""

    diag: Any  # (N,) tensor

    @property
    def shape(self):
        return (self.diag.shape[-1], self.diag.shape[-1])

    def apply(self, psi):
        return self.diag * psi

    def to_dense(self):
        return torch.diag(self.diag)


@dataclass(frozen=True)
class CSROperator:
    """Sparse operator in CSR layout with explicit per-entry row ids.

    ``data[k]`` is the entry at ``(row[k], col[k])``, sorted by row.
    ``indptr`` is carried for host-side conversions.
    """

    data: Any  # (nnz,)
    col: Any  # (nnz,) int64
    row: Any  # (nnz,) int64
    indptr: Any  # (N+1,) int64
    shape: tuple = ()

    @property
    def nnz(self):
        return self.col.shape[-1]

    def apply(self, psi):
        data, psi = _promote(self.data, psi)
        prod = data * psi[..., self.col]
        out = torch.zeros(psi.shape[:-1] + (self.shape[0],),
                          dtype=prod.dtype, device=prod.device)
        # out of place: under vmap ``prod`` may carry a batch dimension
        # that ``out`` lacks
        return out.index_add(-1, self.row, prod)

    def to_dense(self):
        A = torch.zeros(self.shape, dtype=self.data.dtype,
                        device=self.data.device)
        return A.index_put_((self.row, self.col), self.data, accumulate=True)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (host_np(self.data), host_np(self.col), host_np(self.indptr)),
            shape=self.shape,
        )


@dataclass(frozen=True)
class StackedCSROperator:
    """``n_terms`` sparse operators sharing one sparsity pattern.

    ``data`` has shape ``(n_terms, nnz)``.  Applying with a coefficient
    vector contracts the coefficients into a single data vector first,
    so the whole sum costs ONE SpMV per matvec.
    """

    data: Any  # (n_terms, nnz)
    col: Any
    row: Any
    indptr: Any
    shape: tuple = ()

    @property
    def n_terms(self):
        return self.data.shape[0]

    def combine(self, coeffs):
        """Contract term coefficients: returns a :class:`CSROperator`."""
        coeffs = torch.as_tensor(coeffs, device=self.data.device)
        coeffs, data = _promote(coeffs, self.data)
        merged = torch.tensordot(coeffs, data, dims=([0], [0]))
        return CSROperator(merged, self.col, self.row, self.indptr, self.shape)

    def _ones(self):
        return torch.ones((self.n_terms,), dtype=self.data.dtype,
                          device=self.data.device)

    def apply(self, psi, coeffs=None):
        return self.combine(self._ones() if coeffs is None else coeffs).apply(psi)

    def to_dense(self, coeffs=None):
        return self.combine(self._ones() if coeffs is None else coeffs).to_dense()


@dataclass(frozen=True)
class DIAOperator:
    """Sparse operator in DIAgonal storage: ``data[k, i]`` multiplies
    ``psi[i + offsets[k]]`` into row ``i`` (row-aligned; out-of-range
    tail entries must be zero, as :func:`dia_from_scipy` makes them).
    The matvec is a sum of shifted elementwise products."""

    data: Any  # (n_diags, N)
    offsets: tuple = ()  # static ints
    shape: tuple = ()

    def apply(self, psi):
        out = None
        for k, off in enumerate(self.offsets):
            row = self.data[k]
            pad = psi.new_zeros(psi.shape[:-1] + (abs(off),))
            if off >= 0:  # row i reads psi[i + off]: shift left, zero tail
                shifted = torch.cat([psi[..., off:], pad], dim=-1)
            else:
                shifted = torch.cat([pad, psi[..., :off]], dim=-1)
            row, shifted = _promote(row, shifted)
            term = row * shifted
            out = term if out is None else out + term
        if out is None:
            out = torch.zeros_like(psi)
        return out

    def to_dense(self):
        N = self.shape[0]
        data = host_np(self.data)
        A = np.zeros(self.shape, dtype=np.complex128)
        for k, off in enumerate(self.offsets):
            for i in range(max(0, -off), min(N, N - off)):
                A[i, i + off] = data[k, i]
        return torch.as_tensor(A, device=self.data.device)


def dia_from_scipy(A, dtype=None, device=None) -> DIAOperator:
    """Build a :class:`DIAOperator` from any scipy sparse matrix (for
    banded matrices: the number of stored diagonals should be small)."""
    import scipy.sparse as sp

    D = sp.dia_matrix(A)
    N = D.shape[0]
    offsets = tuple(int(o) for o in D.offsets)
    # scipy dia data is column-aligned: data[k, j] is A[j - off, j].
    # Re-align to rows: row_data[k, i] = A[i, i + off] = scipy[k, i + off]
    data = np.zeros((len(offsets), N), dtype=np.asarray(D.data).dtype)
    for k, off in enumerate(offsets):
        col_aligned = D.data[k]
        if off >= 0:
            data[k, : N - off] = col_aligned[off:N]
        else:
            data[k, -off:] = col_aligned[: N + off]
    if dtype is None and data.dtype.kind == "c":
        data = data.astype(np.complex128)
    return DIAOperator(data=as_tensor(data, dtype=dtype, device=device),
                       offsets=offsets, shape=tuple(D.shape))


@dataclass(frozen=True)
class BSROperator:
    """Block-sparse operator: dense ``(b, b)`` blocks in a padded
    blocked-ELL layout.

    ``blocks[r, j]`` is the dense block in block-row ``r`` at
    block-column ``cols[r, j]``; rows are padded to the maximum
    block-degree ``k`` with all-zero blocks pointing at block-column 0.
    ``shape`` is the logical ``(N, N)``; ``R·b`` may exceed ``N`` by the
    zero padding :func:`bsr_from_scipy` adds.  ``apply`` gathers ``k``
    contiguous length-``b`` slices of the state per block-row and
    contracts them with the blocks in one batched product.
    """

    blocks: Any  # (R, k, b, b)
    cols: Any  # (R, k) int64 block-column ids
    shape: tuple = ()  # (N, N) logical shape (pre-padding)
    block_size: int = 0  # static b

    @property
    def nnzb(self):
        return self.blocks.shape[0] * self.blocks.shape[1]

    @property
    def nnz(self):
        # dense-block entry count (the unit the Gnnz/s metric uses)
        return self.nnzb * self.block_size * self.block_size

    def apply(self, psi):
        b = self.block_size
        R = self.blocks.shape[0]
        N = self.shape[0]
        lead = psi.shape[:-1]
        v = psi.reshape(-1, N)
        if R * b != N:
            v = torch.cat([v, v.new_zeros((v.shape[0], R * b - N))], dim=-1)
        xg = v.reshape(-1, R, b)[:, self.cols]  # (n, R, k, b) block gathers
        # y[n, r, o] = Σ_{j, i} blocks[r, j, o, i] · xg[n, r, j, i]
        if xg.is_complex() and not self.blocks.is_complex():
            # real blocks: contract re and im together, never promoting
            # the (large) blocks to complex
            rdtype = torch.promote_types(xg.dtype.to_real(), self.blocks.dtype)
            xr = torch.view_as_real(xg.to(rdtype.to_complex()))
            y = torch.einsum("rjoi,nrjix->nrox", self.blocks.to(rdtype), xr)
            y = torch.view_as_complex(y.contiguous())
        else:
            blocks, xg = _promote(self.blocks, xg)
            y = torch.einsum("rjoi,nrji->nro", blocks, xg)
        return y.reshape(lead + (R * b,))[..., :N]

    def to_scipy(self):
        import scipy.sparse as sp

        R, k, b, _ = self.blocks.shape
        blocks = host_np(self.blocks).reshape(R * k, b, b)
        cols = host_np(self.cols).reshape(-1)
        rows = np.repeat(np.arange(R, dtype=np.int64), k)
        keep = np.abs(blocks).max(axis=(1, 2)) > 0
        A = sp.bsr_matrix(
            (blocks[keep], cols[keep], np.concatenate([[0], np.cumsum(
                np.bincount(rows[keep], minlength=R))]).astype(np.int64)),
            shape=(R * b, R * b),
        ).tocsr()
        return A[: self.shape[0], : self.shape[1]].tocsr()

    def to_dense(self):
        return torch.as_tensor(self.to_scipy().toarray(),
                               device=self.blocks.device)


def choose_block_size(N: int, max_b: int = 64) -> int:
    """Largest power-of-two divisor of ``N`` up to ``max_b``."""
    b = 1
    while b * 2 <= max_b and N % (b * 2) == 0:
        b *= 2
    return b


def bsr_from_scipy(A, block_size: int = None, dtype=None,
                   device=None) -> BSROperator:
    """Build a :class:`BSROperator` from any scipy sparse matrix.

    The matrix is zero-padded up to a multiple of ``block_size`` when
    needed; block-rows are padded to the maximum block-degree with zero
    blocks (blocked-ELL).
    """
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    N, M = A.shape
    if N != M:
        raise ValueError("BSROperator requires a square matrix")
    if block_size is None:
        block_size = choose_block_size(N)
    b = int(block_size)
    n_pad = -(-N // b) * b
    if n_pad != N:
        A = sp.bmat(
            [[A, sp.csr_matrix((N, n_pad - N))],
             [sp.csr_matrix((n_pad - N, N)), sp.csr_matrix((n_pad - N, n_pad - N))]],
            format="csr",
        )
    B = A.tobsr(blocksize=(b, b))
    B.sort_indices()
    R = n_pad // b
    degrees = np.diff(B.indptr)
    k = max(1, int(degrees.max()))
    blocks = np.zeros((R, k, b, b), dtype=np.asarray(B.data).dtype)
    cols = np.zeros((R, k), dtype=np.int64)
    for r in range(R):
        lo, hi = B.indptr[r], B.indptr[r + 1]
        d = hi - lo
        blocks[r, :d] = B.data[lo:hi]
        cols[r, :d] = B.indices[lo:hi]
    if dtype is None and blocks.dtype.kind == "c":
        blocks = blocks.astype(np.complex128)
    return BSROperator(
        blocks=as_tensor(blocks, dtype=dtype, device=device),
        cols=as_tensor(cols, device=device),
        shape=(N, M),
        block_size=b,
    )


def bsr_from_dense(A, block_size: int = None, tol: float = 0.0,
                   device=None) -> BSROperator:
    """Build a :class:`BSROperator` from a dense matrix, dropping entries
    with ``|a_ij| <= tol``."""
    import scipy.sparse as sp

    if device is None and isinstance(A, torch.Tensor):
        device = A.device
    A = host_np(A)
    if tol > 0:
        A = np.where(np.abs(A) > tol, A, 0)
    return bsr_from_scipy(sp.csr_matrix(A), block_size=block_size,
                          device=device)


# --------------------------------------------------------------------------
# Generic functional interface
# --------------------------------------------------------------------------

def _is_dense(obj) -> bool:
    return isinstance(obj, (torch.Tensor, np.ndarray))


def is_operator(obj) -> bool:
    """True if ``obj`` can act as a static operator on a state."""
    if _is_dense(obj) and np.ndim(obj) == 2:
        return True
    return hasattr(obj, "apply") and hasattr(obj, "shape")


def apply(op, psi):
    """Apply a static operator to a state: ``psi' = op @ psi``."""
    if _is_dense(op):
        if op.ndim != 2:
            raise ValueError(f"dense operator must be 2D, got shape {op.shape}")
        A, psi = _promote(as_tensor(op, device=psi.device), psi)
        return torch.einsum("ij,...j->...i", A, psi)
    applier = getattr(op, "apply", None)
    if applier is not None:
        return applier(psi)
    raise TypeError(f"object of type {type(op)} does not implement `apply`")


def op_dot(x, op, y):
    """Expectation-style inner product ``⟨x| op |y⟩``."""
    return vdot(x, apply(op, y))


def to_dense(op):
    """Materialize any operator as a dense torch matrix."""
    if _is_dense(op):
        return as_tensor(op)
    fn = getattr(op, "to_dense", None)
    if fn is not None:
        return fn()
    raise TypeError(f"cannot densify operator of type {type(op)}")


def op_shape(op) -> tuple:
    return tuple(op.shape)


def op_device(op) -> torch.device:
    """The device an operator's tensors live on (CPU for numpy
    operators)."""
    if isinstance(op, torch.Tensor):
        return op.device
    if isinstance(op, np.ndarray):
        return torch.device("cpu")
    mesh = getattr(op, "mesh", None)
    if mesh is not None:
        return mesh.device
    for name in ("diag", "data", "site_mats", "blocks", "planes"):
        t = getattr(op, name, None)
        if isinstance(t, torch.Tensor):
            return t.device
    mats = getattr(op, "group_mats", None)
    if mats:
        return op_device(mats[0])
    inner = getattr(op, "ops", None)
    if inner:
        return op_device(inner[0])
    inner = getattr(op, "operator", None)
    if inner is not None:
        return op_device(inner)
    return torch.device("cpu")


def to_scipy_sparse(op):
    """Convert any operator to a host ``scipy.sparse.csr_matrix``
    without a dense ``(N, N)`` intermediate for sparse inputs."""
    import scipy.sparse as sp

    if sp.issparse(op):
        return sp.csr_matrix(op)
    if isinstance(op, (CSROperator, BSROperator)):
        return op.to_scipy()
    if isinstance(op, DiagonalOperator):
        return sp.diags(host_np(op.diag)).tocsr()
    if isinstance(op, DIAOperator):
        N = op.shape[0]
        data = host_np(op.data)
        # row-aligned data[k, i] sits at (i, i + off); sp.diags takes the
        # diagonal's own entries, which start at row max(0, -off)
        mats = []
        for k, off in enumerate(op.offsets):
            d = data[k]
            diag = d[: N - off] if off >= 0 else d[-off:]
            mats.append(sp.diags(diag, off, shape=op.shape))
        return sum(mats[1:], mats[0].tocsr()) if mats else sp.csr_matrix(op.shape)
    if isinstance(op, StackedCSROperator):
        return sp.csr_matrix(
            (host_np(op.data).sum(axis=0), host_np(op.col), host_np(op.indptr)),
            shape=op.shape,
        )
    if _is_dense(op):
        return sp.csr_matrix(host_np(op))
    # ScaledOperator / other lazy operators
    scale = getattr(op, "coeff", None)
    inner = getattr(op, "operator", None)
    if scale is not None and inner is not None:
        return (complex(scale) * to_scipy_sparse(inner)).tocsr()
    return sp.csr_matrix(host_np(to_dense(op)))


# --------------------------------------------------------------------------
# Construction helpers (host-side)
# --------------------------------------------------------------------------

def csr_from_scipy(A, dtype=None, device=None) -> CSROperator:
    """Build a :class:`CSROperator` from any scipy sparse matrix."""
    A = A.tocsr()
    A.sum_duplicates()
    data = np.asarray(A.data)
    if dtype is None:
        data = data.astype(np.complex128 if A.dtype.kind == "c" else A.dtype)
    indptr = np.asarray(A.indptr, dtype=np.int64)
    row = np.repeat(np.arange(A.shape[0], dtype=np.int64), np.diff(indptr))
    return CSROperator(
        data=as_tensor(data, dtype=dtype, device=device),
        col=as_tensor(np.asarray(A.indices, dtype=np.int64), device=device),
        row=as_tensor(row, device=device),
        indptr=as_tensor(indptr, device=device),
        shape=tuple(A.shape),
    )


def csr_from_dense(A, tol: float = 0.0) -> CSROperator:
    """Build a :class:`CSROperator` from a dense matrix, dropping entries
    with ``|a_ij| <= tol``."""
    import scipy.sparse as sp

    device = A.device if isinstance(A, torch.Tensor) else None
    A = host_np(A)
    if tol > 0:
        A = np.where(np.abs(A) > tol, A, 0)
    return csr_from_scipy(sp.csr_matrix(A), device=device)


def add_operators(a, b):
    """Host-side structural sum of two static operators (used by the
    ``hamiltonian`` constructor when merging terms with identical
    amplitudes)."""
    if _is_dense(a) and _is_dense(b):
        x, y = _promote(as_tensor(a), as_tensor(b))
        return x + y.to(x.device)
    if isinstance(a, DiagonalOperator) and isinstance(b, DiagonalOperator):
        return DiagonalOperator(a.diag + b.diag)
    if isinstance(a, BSROperator) or isinstance(b, BSROperator):
        bs = a.block_size if isinstance(a, BSROperator) else b.block_size
        return bsr_from_scipy(to_scipy_sparse(a) + to_scipy_sparse(b),
                              block_size=bs, device=op_device(a))
    if isinstance(a, CSROperator) or isinstance(b, CSROperator):
        return csr_from_scipy(to_scipy_sparse(a) + to_scipy_sparse(b),
                              device=op_device(a))
    x, y = _promote(to_dense(a), to_dense(b))
    return x + y


def scale_operator(alpha, op):
    """Host-side structural scaling ``alpha * op``."""
    if _is_dense(op):
        return alpha * as_tensor(op)
    if isinstance(op, DiagonalOperator):
        return DiagonalOperator(alpha * op.diag)
    if isinstance(op, (CSROperator, DIAOperator)):
        return dataclasses.replace(op, data=alpha * op.data)
    if isinstance(op, BSROperator):
        return dataclasses.replace(op, blocks=alpha * op.blocks)
    return alpha * to_dense(op)
