"""ctypes bindings for the host assembly library (PyTorch port of
:mod:`quantumpropagators.native`).

``csrc/host/qprop_native.cpp`` is compiled with ``g++`` at first use
into ``_build/`` beside the package, keyed on a hash of the source and
flags (as the CUDA kernels are, :mod:`.ops._cuda`), and written to a
temporary file that is renamed into place, so that several processes
can build it at once.  Every entry point returns host numpy arrays, and
has the JAX module's scipy/numpy path for a host without a compiler
(:func:`native_available` reports which one runs).  Move a result to
the device with :func:`.ops.operators.csr_from_scipy`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "native_available",
    "tfim_chain_csr",
    "tfim_lattice2d_csr",
    "csr_spmv",
    "band_partition_remap",
]

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host" / "qprop_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_I64 = ctypes.POINTER(ctypes.c_int64)
_F64 = ctypes.POINTER(ctypes.c_double)


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0"
                            + SOURCE.read_bytes())
    return BUILD_DIR / f"qprop_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of this exact source exists;
    returns its path.  Raises ``OSError`` without ``g++`` and
    ``subprocess.CalledProcessError`` when it fails."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=so.parent) as tmpdir:
        tmp = Path(tmpdir) / so.name
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=240)
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half
    return so


def _bind(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    lib.tfim_chain_csr.restype = ctypes.c_int64
    lib.tfim_chain_csr.argtypes = [
        ctypes.c_int32, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, _I64, _I64, _F64, _F64,
    ]
    lib.tfim_lattice2d_csr.restype = ctypes.c_int64
    lib.tfim_lattice2d_csr.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, _I64, _I64, _F64, _F64,
    ]
    lib.csr_spmv_z.restype = None
    lib.csr_spmv_z.argtypes = [ctypes.c_int64, _I64, _I64] + [_F64] * 6
    lib.csr_band_partition_remap.restype = ctypes.c_int64
    lib.csr_band_partition_remap.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _I64, _I64, _I64,
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            _LIB = _bind(build())
        except (OSError, subprocess.SubprocessError):
            return None  # no compiler: the scipy/numpy paths run
        return _LIB


def native_available() -> bool:
    return _load() is not None


def _ptr_i64(a):
    return a.ctypes.data_as(_I64)


def _ptr_f64(a):
    return a.ctypes.data_as(_F64)


def tfim_chain_csr(L: int, J=1.0, g=1.0, h=0.0, periodic=False):
    """CSR arrays ``(indptr, cols, values)`` of the 1D TFIM Hamiltonian
    on ``2^L`` dimensions, assembled natively in O(nnz) (scipy-kron
    path without the library)."""
    lib = _load()
    N = 1 << L
    nnz = (L + 1) * N
    if lib is not None:
        indptr = np.empty(N + 1, dtype=np.int64)
        cols = np.empty(nnz, dtype=np.int64)
        vr = np.empty(nnz, dtype=np.float64)
        vi = np.empty(nnz, dtype=np.float64)
        lib.tfim_chain_csr(
            L, float(J), float(g), float(h), int(bool(periodic)),
            _ptr_i64(indptr), _ptr_i64(cols), _ptr_f64(vr), _ptr_f64(vi),
        )
        return indptr, cols, vr + 1j * vi
    import scipy.sparse as sp

    from .models.lattice import PAULI

    I2 = sp.identity(2, format="csr", dtype=np.complex128)
    X = sp.csr_matrix(PAULI["X"])
    Z = sp.csr_matrix(PAULI["Z"])

    def site(op, i):
        out = sp.identity(1, format="csr", dtype=np.complex128)
        for j in range(L):
            out = sp.kron(out, op if j == i else I2, format="csr")
        return out

    H = sp.csr_matrix((N, N), dtype=np.complex128)
    bonds = [(i, i + 1) for i in range(L - 1)] + (
        [(L - 1, 0)] if periodic else []
    )
    for i, j in bonds:
        H = H + J * (site(Z, i) @ site(Z, j))
    for i in range(L):
        H = H + h * site(Z, i) + g * site(X, i)
    H = H.tocsr()
    H.sum_duplicates()
    return (
        H.indptr.astype(np.int64),
        H.indices.astype(np.int64),
        H.data.astype(np.complex128),
    )


def tfim_lattice2d_csr(Lx: int, Ly: int, J=1.0, g=1.0, h=0.0):
    """CSR arrays of the 2D open-boundary TFIM on ``2^(Lx*Ly)`` dims."""
    lib = _load()
    L = Lx * Ly
    N = 1 << L
    nnz = (L + 1) * N
    if lib is None:
        raise RuntimeError(
            "2D lattice assembly requires the native library (dimensions "
            "are too large for the scipy fallback)"
        )
    indptr = np.empty(N + 1, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int64)
    vr = np.empty(nnz, dtype=np.float64)
    vi = np.empty(nnz, dtype=np.float64)
    lib.tfim_lattice2d_csr(
        Lx, Ly, float(J), float(g), float(h),
        _ptr_i64(indptr), _ptr_i64(cols), _ptr_f64(vr), _ptr_f64(vi),
    )
    return indptr, cols, vr + 1j * vi


def csr_spmv(indptr, cols, values, x):
    """Multithreaded native complex CSR matvec on the host."""
    lib = _load()
    n = len(indptr) - 1
    x = np.ascontiguousarray(x, dtype=np.complex128)
    if lib is None:
        import scipy.sparse as sp

        A = sp.csr_matrix((values, cols, indptr), shape=(n, n))
        return A @ x
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    ar = np.ascontiguousarray(values.real)
    ai = np.ascontiguousarray(values.imag)
    xr = np.ascontiguousarray(x.real)
    xi = np.ascontiguousarray(x.imag)
    yr = np.empty(n, dtype=np.float64)
    yi = np.empty(n, dtype=np.float64)
    lib.csr_spmv_z(
        n, _ptr_i64(indptr), _ptr_i64(cols),
        _ptr_f64(ar), _ptr_f64(ai), _ptr_f64(xr), _ptr_f64(xi),
        _ptr_f64(yr), _ptr_f64(yi),
    )
    return yr + 1j * yi


def _band_partition_remap_np(indptr, cols, n_devices: int):
    """The numpy path of :func:`band_partition_remap`."""
    n = len(indptr) - 1
    n_local = n // n_devices
    row = np.repeat(np.arange(n), np.diff(indptr))
    lo = (row // n_local) * n_local
    w = int(
        max(
            np.maximum(lo - cols, 0).max(initial=0),
            np.maximum(cols - (lo + n_local - 1), 0).max(initial=0),
        )
    )
    if w > n_local:
        return None, None
    return w, cols - (lo - w)


def band_partition_remap(indptr, cols, n_devices: int):
    """Halo width + extended-local column remap for a row-block
    partition (native two-pass; numpy path without the library).
    Returns ``(halo, ext_cols)`` or ``(None, None)`` if the matrix is
    not nearest-neighbor banded for this partition."""
    n = len(indptr) - 1
    lib = _load()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    if lib is not None:
        ext = np.empty_like(cols)
        w = lib.csr_band_partition_remap(
            n, n_devices, _ptr_i64(indptr), _ptr_i64(cols), _ptr_i64(ext)
        )
        if w < 0:
            return None, None
        return int(w), ext
    return _band_partition_remap_np(indptr, cols, n_devices)
