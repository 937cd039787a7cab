"""Build and load the package's CUDA kernels.

Every source under ``csrc/`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into an object, all of them at once, and the objects are
linked into one plain-C shared library loaded with ``ctypes``.  The
build happens at first use, into ``_build/`` beside the package, keyed
on a hash of all sources and flags, so a changed source is rebuilt and
an unchanged library is loaded as it is.  Nothing here runs at import
time: a machine without ``nvcc`` or a GPU imports the package and runs
the kernels' plain PyTorch versions on CPU tensors.
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

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # v0, v1, phi, dmb, G, w, L, n, tile_bits, bits, s, a0, a1, a0_ptr,
    # a1_ptr, stream
    "cheby_flip_first_f32": [_P] * 6 + [_I, _L, _I, _I]
                            + [ctypes.c_float] * 3 + [_P] * 3,
    "cheby_flip_first_f64": [_P] * 6 + [_I, _L, _I, _I]
                            + [ctypes.c_double] * 3 + [_P] * 3,
    # v0, v2, v1, phi, dmb, G, w, L, n, tile_bits, bits, s2, ak, ak_ptr,
    # stream
    "cheby_flip_iter_f32": [_P] * 7 + [_I, _L, _I, _I]
                           + [ctypes.c_float] * 2 + [_P] * 2,
    "cheby_flip_iter_f64": [_P] * 7 + [_I, _L, _I, _I]
                           + [ctypes.c_double] * 2 + [_P] * 2,
    # v1, G, w, partners (host array of device pointers), n_partners, out,
    # L, n, h, line_bits, stream
    "cheby_flip_high_f32": [_P] * 3 + [ctypes.POINTER(_P), _I, _P, _I, _L,
                                       _I, _I, _P],
    "cheby_flip_high_f64": [_P] * 3 + [ctypes.POINTER(_P), _I, _P, _I, _L,
                                       _I, _I, _P],
    # planes, x, y, offsets, n_bands, R, b, halo, stream
    "banded_spmv_f64": [_P] * 3 + [ctypes.POINTER(ctypes.c_int), _I, _L, _I,
                                   _I, _P],
    # csrc/probes.cu (ops/probes.py)
    # planes, o1, o2, op, n_in, n, tile_bits, chain, mul, scale, stream
    "probe_stream": [_P] * 3 + [_I, _I, _L, _I, _I] + [ctypes.c_float] * 2
                    + [_P],
    # planes, out, n_in, n, chunk, chain, mul, stream
    "probe_stream_pipelined": [_P, _P, _I, _L, _I, _I, ctypes.c_float, _P],
    # x, out, variant, n, lo, hi, tile_bits, stream
    "probe_flipsum": [_P, _P, _I, _L, _I, _I, _I, _P],
    # x, m, out, mode, rows, stream
    "probe_tile_mma_f32": [_P] * 3 + [_I, _L, _P],
    # x, m, out, rows, stream
    "probe_tile_mma_f64": [_P] * 3 + [_L, _P],
    # x, out, n, bytes, stream
    "probe_smem": [_P, _P, _I, _I, _P],
    # v0, out, v1, phi, dmb, G, w, body, nb, L, n, tile_bits, bits, s2, ak,
    # stream
    "probe_flip_order_f64": [_P] * 7 + [_I, _I, _I, _L, _I, _I]
                            + [ctypes.c_double] * 2 + [_P],
    # a, b, p, r, variant, n, stream
    "probe_fma_residual_f32": [_P] * 4 + [_I, _L, _P],
    "probe_fma_residual_f64": [_P] * 4 + [_I, _L, _P],
    # x, q, r, n, stream
    "probe_extract": [_P] * 3 + [_I, _P],
    # x, out, variant, n, bit, stream
    "probe_xor_permute": [_P, _P, _I, _L, _I, _P],
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless a build of these exact sources
    exists; returns its path.  Records the wall time and the ptxas
    report in :data:`build_info`."""
    so = library_path()
    if so.exists():
        build_info.setdefault("seconds", 0.0)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{src.stem}.o" for src in SOURCES]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                              str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for src, obj in zip(SOURCES, objs)
        ]
        reports = []
        for src, proc in zip(SOURCES, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {src}:\n{err}")
            reports.append(err)
        tmp = Path(tmpdir) / so.name
        proc = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builds never see half a file
    build_info["seconds"] = time.perf_counter() - t0
    build_info["ptxas"] = "".join(reports)
    return so


def launch(fn_name: str, args, device, accept=()) -> int:
    """Call the library's ``fn_name(*args, stream)`` on ``device``'s
    current stream; raises if the launch returned a CUDA error other than
    those in ``accept``, and returns the error (0: launched)."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0 and rc not in accept:
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc}")
    return rc


def refuse_grad(kernel, *inputs) -> None:
    """Raise where ``kernel`` (its name, or a function that gives it)
    would be launched while grad mode is on and one of its ``inputs``
    requires grad: a launch takes no part in autograd, so its result
    would drop out of the graph unnoticed (``jax.grad`` refuses a
    ``pallas_call`` the same way: it has no transpose).  A plain loop,
    the name made only where it raises: it runs at every eager
    launch."""
    if not torch.is_grad_enabled():
        return
    for t in inputs:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            name = kernel() if callable(kernel) else kernel
            raise RuntimeError(
                f"{name}: the CUDA kernel has no backward and an input "
                f"requires grad; call it under torch.no_grad() or on "
                f"detached inputs, or differentiate a path of plain tensor "
                f"operations")


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
