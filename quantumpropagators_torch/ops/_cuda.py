"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into a plain-C shared library and loaded with ``ctypes``.
The build happens at first use, into ``_build/`` beside the package,
keyed on a hash of the source, so a changed source is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs at import time: a
machine without ``nvcc`` or a GPU imports the package and runs the
kernels' plain PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "cheby_flip.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # v0, v1, phi, dmb, G, w, L, n, s, a0, a1, stream
    "cheby_flip_first_f32": [_P] * 6 + [_I, _L] + [ctypes.c_float] * 3 + [_P],
    "cheby_flip_first_f64": [_P] * 6 + [_I, _L] + [ctypes.c_double] * 3 + [_P],
    # v0, v2, v1, phi, dmb, G, w, L, n, s2, ak, stream
    "cheby_flip_iter_f32": [_P] * 7 + [_I, _L] + [ctypes.c_float] * 2 + [_P],
    "cheby_flip_iter_f64": [_P] * 7 + [_I, _L] + [ctypes.c_double] * 2 + [_P],
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"cheby_flip_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless a build of this exact source
    exists; returns its path.  Records the compile time and the ptxas
    report in :data:`build_info`."""
    so = library_path()
    if so.exists():
        build_info.setdefault("seconds", 0.0)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: concurrent builds never see half a file
    build_info["seconds"] = time.perf_counter() - t0
    build_info["ptxas"] = proc.stderr
    return so


def load():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
