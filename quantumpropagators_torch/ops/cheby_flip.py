"""One Chebyshev order on a diagonal-plus-site-flip generator: the
hand-written CUDA kernels of ``csrc/cheby_flip.cu`` and their plain
PyTorch versions.

``H = diag(d) + Σ_j G_j X_j`` with ``X_j`` the flip of index bit ``j``.
With ``dmb = d − β`` and ``c = i·s``:

- :func:`cheby_flip_first`: ``v1 = c·(H−β)v0``, ``Φ = a0·v0 + a1·v1``;
- :func:`cheby_flip_iter`: ``v2 = 2c·(H−β)v1 + v0`` (``s2 = 2s``),
  ``Φ += a_k·v2``, with ``v2`` written into ``out`` (default: ``v0``'s
  buffer) and ``Φ`` updated in place.

Each takes complex128 states with float64 ``dmb``/``G`` (the
reference-accuracy tier) or complex64 with float32 (the f32 tier).  A
wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  :data:`LAUNCHES` counts kernel launches
per instantiation (the plain versions do not count).
"""

from __future__ import annotations

import torch

from . import _cuda

__all__ = [
    "LAUNCHES",
    "MAX_BITS",
    "reset_launches",
    "flip_sum_plain",
    "cheby_flip_first",
    "cheby_flip_first_plain",
    "cheby_flip_iter",
    "cheby_flip_iter_plain",
]

MAX_BITS = 30

_TYPES = {
    torch.complex64: ("float", "f32", torch.float32),
    torch.complex128: ("double", "f64", torch.float64),
}

LAUNCHES = {
    f"{kernel}<{ctype}>": 0
    for kernel in ("cheby_flip_first", "cheby_flip_iter")
    for ctype in ("float", "double")
}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(vectors, dmb, G) -> int:
    """Validate the arguments of one launch; returns ``L``."""
    v = vectors[0]
    if v.dtype not in _TYPES:
        raise TypeError(f"state must be complex64 or complex128, got {v.dtype}")
    rdtype = _TYPES[v.dtype][2]
    n = v.numel()
    L = n.bit_length() - 1
    if n != 1 << L or L < 1:
        raise ValueError(f"state length must be 2^L, got {n}")
    if L > MAX_BITS:
        raise ValueError(f"L = {L} > {MAX_BITS} is not supported")
    for x in vectors:
        if x.dtype != v.dtype or x.numel() != n or x.device != v.device:
            raise ValueError("state vectors must share dtype, length and device")
        if not x.is_contiguous():
            raise ValueError("state vectors must be contiguous")
    if dmb.dtype != rdtype or dmb.numel() != n or dmb.device != v.device \
            or not dmb.is_contiguous():
        raise ValueError(f"dmb must be a contiguous {rdtype} vector of "
                         f"length {n} on {v.device}")
    if G.dtype != rdtype or tuple(G.shape) != (L,) or G.device != v.device \
            or not G.is_contiguous():
        raise ValueError(f"G must be a contiguous {rdtype} vector of shape "
                         f"({L},) on {v.device}")
    return L


def flip_sum_plain(v: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """``Σ_j G_j·v[i ^ 2^j]`` over a flat ``2^L`` vector."""
    out = torch.zeros_like(v)
    for j in range(G.shape[0]):
        out += G[j] * v.view(-1, 2, 1 << j).flip(1).reshape(v.shape)
    return out


def _shifted_h(v, dmb, G, w):
    u = dmb.view(v.shape) * v + flip_sum_plain(v, G)
    return u if w is None else u + w


def cheby_flip_first_plain(v0, dmb, G, s, a0, a1, w=None):
    """Plain PyTorch version of :func:`cheby_flip_first`."""
    _check([v0] + ([w] if w is not None else []), dmb, G)
    v1 = (1j * s) * _shifted_h(v0, dmb, G, w)
    return v1, a0 * v0 + a1 * v1


def cheby_flip_iter_plain(v0, v1, phi, dmb, G, s2, ak, w=None, out=None):
    """Plain PyTorch version of :func:`cheby_flip_iter`."""
    out = v0 if out is None else out
    _check([v0, v1, phi, out] + ([w] if w is not None else []), dmb, G)
    v2 = (1j * s2) * _shifted_h(v1, dmb, G, w) + v0
    out.copy_(v2)
    phi.add_(v2, alpha=ak)
    return out


def _launch(fn_name, ctype, args, device):
    _cuda.launch(fn_name, args, device)
    LAUNCHES[ctype] += 1


def _device_kind(v):
    if v.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {v.device}")
    return v.device.type


def cheby_flip_first(v0, dmb, G, s, a0, a1, w=None):
    """Chebyshev setup ``v1 = i·s·((H−β)v0 + w)``, ``Φ = a0·v0 + a1·v1``;
    returns ``(v1, Φ)``."""
    if _device_kind(v0) == "cpu":
        return cheby_flip_first_plain(v0, dmb, G, s, a0, a1, w)
    L = _check([v0] + ([w] if w is not None else []), dmb, G)
    ctype, suffix, _ = _TYPES[v0.dtype]
    v1 = torch.empty_like(v0)
    phi = torch.empty_like(v0)
    _launch(
        f"cheby_flip_first_{suffix}", f"cheby_flip_first<{ctype}>",
        (v0.data_ptr(), v1.data_ptr(), phi.data_ptr(), dmb.data_ptr(),
         G.data_ptr(), None if w is None else w.data_ptr(), L, v0.numel(),
         float(s), float(a0), float(a1)),
        v0.device,
    )
    return v1, phi


def cheby_flip_iter(v0, v1, phi, dmb, G, s2, ak, w=None, out=None):
    """One order ``v2 = i·s2·((H−β)v1 + w) + v0``, ``Φ += a_k·v2``.
    ``v2`` goes into ``out`` (default: ``v0``, overwritten in place) and
    is returned; ``Φ`` is updated in place."""
    if _device_kind(v0) == "cpu":
        return cheby_flip_iter_plain(v0, v1, phi, dmb, G, s2, ak, w, out)
    out = v0 if out is None else out
    L = _check([v0, v1, phi, out] + ([w] if w is not None else []), dmb, G)
    if v1.data_ptr() in (v0.data_ptr(), out.data_ptr(), phi.data_ptr()):
        raise ValueError("v1 must not share memory with v0, out or phi")
    ctype, suffix, _ = _TYPES[v0.dtype]
    _launch(
        f"cheby_flip_iter_{suffix}", f"cheby_flip_iter<{ctype}>",
        (v0.data_ptr(), out.data_ptr(), v1.data_ptr(), phi.data_ptr(),
         dmb.data_ptr(), G.data_ptr(), None if w is None else w.data_ptr(),
         L, v0.numel(), float(s2), float(ak)),
        v0.device,
    )
    return out
