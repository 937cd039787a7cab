"""Banded block SpMV ``y = A·x`` for a real block-banded operator on a
complex128 state: the hand-written CUDA kernel of
``csrc/banded_spmv.cu`` and its plain PyTorch version.

The operator is held band-major as one float64 tensor ``planes`` of
shape ``(n_bands, b, R, b)`` with ``planes[k, i, r, o] =
A[r·b + o, (r + offsets[k])·b + i]`` (see :class:`~.bsr_dd.BandedDD`).
Two window modes:

- clamped (``halo=None``): ``x`` has ``R`` block rows; neighbour rows
  outside ``[0, R)`` contribute zero;
- halo-extended (``halo=TR``): ``x`` has ``R + 2·TR`` block rows and
  output row ``r`` reads rows ``r + TR + offsets[k]``.

:func:`banded_spmv` given CPU tensors runs the plain version; given
CUDA tensors it launches the kernel or raises (also where grad mode is
on and an input requires grad: the kernel has no backward).  :data:`LAUNCHES` counts
kernel launches (the plain version does not count).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

__all__ = [
    "LAUNCHES",
    "MAX_BANDS",
    "reset_launches",
    "banded_spmv",
    "banded_spmv_plain",
    "banded_dd_apply",
    "banded_dd_apply_extended",
]

MAX_BANDS = 16
MAX_BLOCK = 128
LAUNCHES = {"banded_spmv<double>": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(planes, offsets, x, halo) -> None:
    """Validate the arguments of one product."""
    if planes.dtype != torch.float64 or planes.dim() != 4 \
            or not planes.is_contiguous():
        raise ValueError("planes must be a contiguous float64 tensor of "
                         "shape (n_bands, b, R, b)")
    n_bands, b, R, b_out = planes.shape
    if b != b_out or not 1 <= b <= MAX_BLOCK:
        raise ValueError(f"block size must be square and at most "
                         f"{MAX_BLOCK}, got {b}x{b_out}")
    if len(offsets) != n_bands or n_bands > MAX_BANDS:
        raise ValueError(f"need one offset per band (at most {MAX_BANDS}), "
                         f"got {len(offsets)} for {n_bands} bands")
    if x.dtype != torch.complex128 or not x.is_contiguous():
        raise TypeError(f"x must be a contiguous complex128 vector, got "
                        f"{x.dtype}")
    if halo is not None and halo < 0:
        raise ValueError(f"halo must be non-negative, got {halo}")
    rows = R if halo is None else R + 2 * halo
    if x.numel() != rows * b:
        raise ValueError(f"x has {x.numel()} entries, expected {rows}·{b}")
    if x.device != planes.device:
        raise ValueError("planes and x must share a device")
    if halo is not None:
        wb = max((abs(d) for d in offsets), default=0)
        if wb > halo:
            raise ValueError(f"band offset {wb} exceeds tile_rows {halo}")


def banded_spmv_plain(planes, offsets, x, halo=None):
    """Plain PyTorch version of :func:`banded_spmv`: one ``einsum`` per
    band over a shifted window of the zero-padded state."""
    _check(planes, offsets, x, halo)
    _, b, R, _ = planes.shape
    xr = torch.view_as_real(x).reshape(-1, b, 2)
    if halo is None:
        base = max((abs(d) for d in offsets), default=0)
        xp = xr.new_zeros((R + 2 * base, b, 2))
        xp[base:base + R] = xr
    else:
        base, xp = halo, xr
    y = xr.new_zeros((R, b, 2))
    for k, d in enumerate(offsets):
        y += torch.einsum("iro,rix->rox", planes[k],
                          xp[base + d: base + d + R])
    return torch.view_as_complex(y).reshape(-1)


def banded_spmv(planes, offsets, x, halo=None):
    """``y = A·x`` over the band-major ``planes``; ``x`` complex128 of
    ``R·b`` entries (or ``(R + 2·halo)·b`` with ``halo``).  Returns a
    new complex128 vector of ``R·b`` entries."""
    if x.device.type == "cpu":
        return banded_spmv_plain(planes, offsets, x, halo)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    _check(planes, offsets, x, halo)
    _cuda.refuse_grad("banded_spmv<double>", planes, x)
    n_bands, b, R, _ = planes.shape
    y = torch.empty(R * b, dtype=torch.complex128, device=x.device)
    offs = (ctypes.c_int * max(1, n_bands))(*offsets)
    _cuda.launch(
        "banded_spmv_f64",
        (planes.data_ptr(), x.data_ptr(), y.data_ptr(), offs, n_bands, R, b,
         -1 if halo is None else int(halo)),
        x.device,
    )
    LAUNCHES["banded_spmv<double>"] += 1
    return y


def banded_dd_apply(op, x, *, tile_rows: int = 8):
    """``y = A·x`` for a :class:`~.bsr_dd.BandedDD` and a complex128
    state of ``R·b`` entries.  ``tile_rows`` is accepted for parity with
    the JAX package; the clamped mode has no tiles."""
    del tile_rows
    return banded_spmv(op.planes, op.offsets, x)


def banded_dd_apply_extended(op, x_ext, *, tile_rows: int = 8):
    """``y = A·x`` over a halo-extended state window: ``x_ext`` holds
    ``(R + 2·tile_rows)·b`` entries, the local rows with one
    ``tile_rows``-block-row halo on each side (filled by the caller from
    its neighbours).  Returns the local ``R·b`` result rows; ``op.R`` is
    the local block-row count."""
    if op.R % tile_rows:
        raise ValueError(
            f"local block rows {op.R} not divisible by tile_rows "
            f"{tile_rows} (pick a tile_rows dividing the shard)"
        )
    return banded_spmv(op.planes, op.offsets, x_ext, halo=tile_rows)
