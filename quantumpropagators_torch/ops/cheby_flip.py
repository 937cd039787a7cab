"""One Chebyshev order on a diagonal-plus-site-flip generator: the
hand-written CUDA kernels of ``csrc/cheby_flip.cu`` and their plain
PyTorch versions.

``H = diag(d) + Σ_j G_j X_j`` with ``X_j`` the flip of index bit ``j``.
With ``dmb = d − β`` and ``c = i·s``:

- :func:`cheby_flip_first`: ``v1 = c·(H−β)v0``, ``Φ = a0·v0 + a1·v1``;
- :func:`cheby_flip_iter`: ``v2 = 2c·(H−β)v1 + v0`` (``s2 = 2s``),
  ``Φ += a_k·v2``, with ``v2`` written into ``out`` (default: ``v0``'s
  buffer) and ``Φ`` updated in place.

The Φ weights ``a0``, ``a1``, ``a_k`` are numbers (kernel arguments) or
0-d tensors of the state's real type on its device, which the kernels
read there: coefficients that are data of a replayed graph.

On the card each of them is two passes (:func:`flip_split` picks the
split from ``L`` and the type): :func:`cheby_flip_high` sums the flips
of the top ``h`` bits of ``v0`` (setup) or ``v1`` (order) into a scratch
vector ``w_hi`` (plus the caller's ``w``), and :func:`cheby_flip_first_low`
or :func:`cheby_flip_iter_low` runs the setup or the order over the
flips of the bits below ``L − h`` with ``w_hi`` as its ``w``.  The top
bits' partners lie too far apart for one sweep to find them in L2.

Every wrapper also takes ``partners``: up to :data:`MAX_PARTNERS` pairs
(one per slot bit of any mesh the kernels address) ``(stack,
slot_xor)`` for flips of bits held outside the state, the slot bits of
a sharded state (:mod:`..parallel.sharded_fused`).  Slot
``s`` of the state reads row ``s ^ slot_xor`` of ``stack`` (the state's
own stack with ``slot_xor = 2^r`` for a slot bit inside this process,
received rows with ``slot_xor = 0``), weighted by ``G[L + r]`` for the
``r``-th partner: ``G`` then holds ``L + len(partners)`` entries.  On
the card the partners are read inside the high pass, which then also
runs where the split has no top bits (``h = 0``: the partners' weighted
sum alone); a high pass without partners launches a kernel that takes no
partner table.

Each takes complex128 states with float64 ``dmb``/``G`` (the
reference-accuracy tier) or complex64 with float32 (the f32 tier).  A
state is a flat ``2^L`` vector or a ``(slots, 2^L)`` stack of
independent ``2^L`` states (the shard slots of one process,
:mod:`..parallel.mesh`); ``dmb`` and ``w`` hold as many entries as the
state, and one ``G`` serves every slot.  On the card a stack is one
launch per slot and pass.  A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel or raises (also
where grad mode is on and an input requires grad: the kernels have no
backward, and a result cut from the autograd graph would pass
unnoticed).
:data:`LAUNCHES` counts kernel launches per instantiation (the plain
versions do not count).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

__all__ = [
    "LAUNCHES",
    "MAX_BITS",
    "MAX_PARTNERS",
    "reset_launches",
    "flip_split",
    "flip_check_sizes",
    "flip_sum_plain",
    "flip_sum_range_plain",
    "cheby_flip_first",
    "cheby_flip_first_plain",
    "cheby_flip_first_low",
    "cheby_flip_first_low_plain",
    "cheby_flip_iter",
    "cheby_flip_iter_plain",
    "cheby_flip_iter_low",
    "cheby_flip_iter_low_plain",
    "cheby_flip_high",
    "cheby_flip_high_plain",
]

MAX_BITS = 30
MAX_PARTNERS = MAX_BITS     # partner rows of one high pass: 2^30 slots
_MAX_HIGH_BITS = 8          # the high pass's cube: at most 2^8 runs
_SMEM_BYTES = 227 * 1024    # shared memory one H100 block may use
_LINE_BYTES = 256           # the high pass's contiguous run per top-bit value
_SUM_LINE_BITS = 10         # a partner pass: 2^10 elements a block
_TILE_BYTES = 16 * 1024     # the iteration's tile of v1 in shared memory
_SETUP_TILE_BITS = 11       # the setup's tile of v0: 2^11 elements
# Bits below which a flip partner stays within L2's reach while the
# iteration sweeps the state; the bits above go to the high pass.  Sizes
# chosen from timings on an H100 (PERF.md §6).
_REACH_BITS = 18

_TYPES = {
    torch.complex64: ("float", "f32", torch.float32),
    torch.complex128: ("double", "f64", torch.float64),
}

LAUNCHES = {
    f"{kernel}<{ctype}>": 0
    for kernel in ("cheby_flip_first", "cheby_flip_iter", "cheby_flip_high")
    for ctype in ("float", "double")
}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def flip_split(L: int, dtype, setup: bool = False) -> tuple[int, int]:
    """``(tile_bits, h)`` of one order (or, with ``setup``, of the setup)
    at ``2^L`` in ``dtype``: the tiled pass stages tiles of
    ``2^tile_bits`` elements in shared memory, and the high pass takes
    the top ``h`` bits (``h = 0``: none)."""
    tile_bits = _SETUP_TILE_BITS if setup else _bits_in(_TILE_BYTES, dtype)
    h = min(max(L - _REACH_BITS, 0), _MAX_HIGH_BITS)
    return min(L, tile_bits), h


def flip_check_sizes(dtype) -> list[int]:
    """The sizes ``L`` at which the card's setup and flip order are held
    against their plain versions: 1, 2, 4, ``T−1``, ``T``, ``T+1`` around
    the tiled passes' tiles of ``2^T`` elements (the order's and the
    setup's), the smallest ``L`` with a high pass, 16, 20, and the
    smallest ``L`` whose high pass takes its most bits."""
    tiles = {flip_split(MAX_BITS, dtype, setup)[0] for setup in (False, True)}
    splits = [(L, flip_split(L, dtype)[1]) for L in range(1, MAX_BITS + 1)]
    first_high = min(L for L, h in splits if h)
    first_cap = min(L for L, h in splits if h == _MAX_HIGH_BITS)
    return sorted({1, 2, 4, first_high, 16, 20, first_cap}
                  | {T + d for T in tiles for d in (-1, 0, 1)})


def _line_bits(L: int, h: int, dtype, partners: bool = False) -> int:
    """The high pass's line: ``2^line_bits`` contiguous elements (at most
    ``_LINE_BYTES``) for each value of the top ``h`` bits; at ``h = 0``
    (partners alone, nothing staged) a block's run of elements.  With
    partners the cube holds at least ``2^_SUM_LINE_BITS`` elements, four
    for each of the block's 256 threads, so that the block's start (the
    staging and the partner table) is spread over as many outputs at
    every ``h`` (PERF.md §6)."""
    line = _bits_in(_LINE_BYTES, dtype)
    if partners:
        line = max(line, _SUM_LINE_BITS - h)
    return min(L - h, line)


def _bits_in(n_bytes: int, dtype) -> int:
    return (n_bytes // dtype.itemsize).bit_length() - 1


def _check(vectors, dmb, G, partners=()) -> int:
    """Validate the arguments of one launch (``dmb=None``: no diagonal);
    returns ``L``."""
    v = vectors[0]
    if v.dtype not in _TYPES:
        raise TypeError(f"state must be complex64 or complex128, got {v.dtype}")
    rdtype = _TYPES[v.dtype][2]
    if v.dim() not in (1, 2):
        raise ValueError(f"state must be a 2^L vector or a (slots, 2^L) "
                         f"stack, got shape {tuple(v.shape)}")
    L = v.shape[-1].bit_length() - 1
    if v.shape[-1] != 1 << L or L < 1:
        raise ValueError(f"state length must be 2^L, got {v.shape[-1]}")
    if L > MAX_BITS:
        raise ValueError(f"L = {L} > {MAX_BITS} is not supported")
    n = v.numel()
    for x in vectors:
        if x.dtype != v.dtype or x.numel() != n or x.device != v.device:
            raise ValueError("state vectors must share dtype, length and device")
        if not x.is_contiguous():
            raise ValueError("state vectors must be contiguous")
    if dmb is not None and (dmb.dtype != rdtype or dmb.numel() != n
                            or dmb.device != v.device
                            or not dmb.is_contiguous()):
        raise ValueError(f"dmb must be a contiguous {rdtype} tensor of "
                         f"{n} entries on {v.device}")
    n_g = L + len(partners)
    if G.dtype != rdtype or tuple(G.shape) != (n_g,) or G.device != v.device \
            or not G.is_contiguous():
        raise ValueError(f"G must be a contiguous {rdtype} vector of shape "
                         f"({n_g},) on {v.device}")
    _check_partners(v, L, partners)
    return L


def _check_partners(v, L, partners) -> None:
    if len(partners) > MAX_PARTNERS:
        raise ValueError(f"{len(partners)} partners: at most {MAX_PARTNERS}")
    slots = v.numel() >> L
    for stack, slot_xor in partners:
        if stack.dtype != v.dtype or stack.device != v.device:
            raise ValueError(f"a partner must be {v.dtype} on {v.device}, "
                             f"got {stack.dtype} on {stack.device}")
        if stack.numel() != v.numel() or stack.shape[-1] != 1 << L \
                or not stack.is_contiguous():
            raise ValueError(f"a partner must be a contiguous stack of "
                             f"{slots} rows of 2^{L}, got shape "
                             f"{tuple(stack.shape)}")
        if not all(0 <= s ^ slot_xor < slots for s in range(slots)):
            raise ValueError(f"slot_xor {slot_xor} leaves the {slots} rows")


def _partner_rows(v, L, stack, slot_xor):
    """Row ``s ^ slot_xor`` of ``stack`` for each slot ``s`` of ``v``, in
    ``v``'s shape."""
    rows = stack.view(-1, 1 << L)
    return torch.stack([rows[s ^ slot_xor] for s in range(rows.shape[0])]
                       ).view(v.shape)


def flip_sum_plain(v: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """``Σ_j G_j·v[i ^ 2^j]`` over a flat ``2^L`` vector."""
    return flip_sum_range_plain(v, G, 0, G.shape[0])


def flip_sum_range_plain(v: torch.Tensor, G: torch.Tensor, lo: int,
                         hi: int) -> torch.Tensor:
    """``Σ_{lo ≤ j < hi} G_j·v[i ^ 2^j]`` over a flat ``2^L`` vector."""
    out = torch.zeros_like(v)
    for j in range(lo, hi):
        out += G[j] * v.view(-1, 2, 1 << j).flip(1).reshape(v.shape)
    return out


def _shifted_h(v, dmb, G, w, partners, bits):
    """``dmb·v + Σ_{j < bits} G_j·v[i ^ 2^j]``, then the partners and
    ``w``."""
    u = dmb.view(v.shape) * v + flip_sum_range_plain(v, G, 0, bits)
    return _add_outside(u, v, G, w, partners)


def _add_outside(u, v, G, w, partners):
    """``u`` plus what enters from outside the state ``v``: the partners
    in list order, each weighted by its entry of ``G`` after the ``L``
    local bits, then ``w`` (the high pass's order)."""
    L = v.shape[-1].bit_length() - 1
    for r, (stack, slot_xor) in enumerate(partners):
        u = u + G[L + r] * _partner_rows(v, L, stack, slot_xor)
    return u if w is None else u + w.view(v.shape)


def _opt(w):
    return [] if w is None else [w]


def cheby_flip_first_plain(v0, dmb, G, s, a0, a1, w=None, partners=()):
    """Plain PyTorch version of :func:`cheby_flip_first`."""
    L = _check([v0] + _opt(w), dmb, G, partners)
    v1 = (1j * s) * _shifted_h(v0, dmb, G, w, partners, L)
    return v1, a0 * v0 + a1 * v1


def cheby_flip_first_low_plain(v0, dmb, G, s, a0, a1, bits, w=None,
                               partners=()):
    """Plain PyTorch version of :func:`cheby_flip_first_low`."""
    L = _check([v0] + _opt(w), dmb, G, partners)
    _check_bits(bits, 0, L)
    v1 = (1j * s) * _shifted_h(v0, dmb, G, w, partners, bits)
    return v1, a0 * v0 + a1 * v1


def cheby_flip_iter_plain(v0, v1, phi, dmb, G, s2, ak, w=None, out=None,
                          partners=()):
    """Plain PyTorch version of :func:`cheby_flip_iter`."""
    out = v0 if out is None else out
    L = _check([v0, v1, phi, out] + _opt(w), dmb, G, partners)
    v2 = (1j * s2) * _shifted_h(v1, dmb, G, w, partners, L) + v0
    out.copy_(v2)
    _accumulate(phi, v2, ak)
    return out


def _accumulate(phi, v2, ak):
    """``Φ += a_k·v2`` for a number or a 0-d tensor ``a_k``."""
    if isinstance(ak, torch.Tensor):
        phi.add_(v2 * ak)
    else:
        phi.add_(v2, alpha=ak)


def cheby_flip_iter_low_plain(v0, v1, phi, dmb, G, s2, ak, bits, w=None,
                              out=None, partners=()):
    """Plain PyTorch version of :func:`cheby_flip_iter_low`."""
    out = v0 if out is None else out
    L = _check([v0, v1, phi, out] + _opt(w), dmb, G, partners)
    _check_bits(bits, 0, L)
    v2 = (1j * s2) * _shifted_h(v1, dmb, G, w, partners, bits) + v0
    out.copy_(v2)
    _accumulate(phi, v2, ak)
    return out


def cheby_flip_high_plain(v1, G, h, w=None, partners=()):
    """Plain PyTorch version of :func:`cheby_flip_high`: the top bits
    from the lowest up, then the partners in list order, then ``w``."""
    L = _check([v1] + _opt(w), None, G, partners)
    _check_bits(h, 0, L)
    return _add_outside(flip_sum_range_plain(v1, G, L - h, L), v1, G, w,
                        partners)


def _check_bits(bits, lo, hi):
    if not lo <= bits <= hi:
        raise ValueError(f"bit count {bits} outside [{lo}, {hi}]")


def _launch(fn_name, ctype, args, device):
    _cuda.launch(fn_name, args, device)
    LAUNCHES[ctype] += 1


def _refuse_grad(kernel, v, *tensors, partners=()):
    """:func:`._cuda.refuse_grad` over every tensor a wrapper takes."""
    _cuda.refuse_grad(lambda: f"{kernel}<{_TYPES[v.dtype][0]}>", v, *tensors,
                      *(stack for stack, _ in partners))


def _device_kind(v):
    if v.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {v.device}")
    return v.device.type


def cheby_flip_first(v0, dmb, G, s, a0, a1, w=None, partners=()):
    """Chebyshev setup ``v1 = i·s·((H−β)v0 + w)``, ``Φ = a0·v0 + a1·v1``
    (``H`` with the ``partners``' flips); returns ``(v1, Φ)``.  On the
    card: the high pass over ``v0`` (when :func:`flip_split` gives
    ``h > 0`` or partners come in), then the tiled setup pass."""
    if _device_kind(v0) == "cpu":
        return cheby_flip_first_plain(v0, dmb, G, s, a0, a1, w, partners)
    L = _check([v0] + _opt(w), dmb, G, partners)
    _refuse_grad("cheby_flip_first", v0, dmb, G, s, a0, a1, w,
                 partners=partners)
    tile_bits, h = flip_split(L, v0.dtype, setup=True)
    w = _outside(v0, G, w, L, h, partners)
    return _launch_first(v0, dmb, G, s, a0, a1, w, L, tile_bits, L - h)


def cheby_flip_first_low(v0, dmb, G, s, a0, a1, bits, w=None, partners=()):
    """The tiled pass of :func:`cheby_flip_first`: the same setup with
    the flips of bits ``0 .. bits−1`` only (the caller supplies the
    others through ``w``); returns ``(v1, Φ)``.  Partners are summed
    first by the high pass at ``h = 0``."""
    if _device_kind(v0) == "cpu":
        return cheby_flip_first_low_plain(v0, dmb, G, s, a0, a1, bits, w,
                                          partners)
    L = _check([v0] + _opt(w), dmb, G, partners)
    _check_bits(bits, 0, L)
    _refuse_grad("cheby_flip_first", v0, dmb, G, s, a0, a1, w,
                 partners=partners)
    w = _outside(v0, G, w, L, 0, partners)
    return _launch_first(v0, dmb, G, s, a0, a1, w, L,
                         flip_split(L, v0.dtype, setup=True)[0], bits)


def cheby_flip_iter(v0, v1, phi, dmb, G, s2, ak, w=None, out=None,
                    partners=()):
    """One order ``v2 = i·s2·((H−β)v1 + w) + v0``, ``Φ += a_k·v2``
    (``H`` with the ``partners``' flips).  ``v2`` goes into ``out``
    (default: ``v0``, overwritten in place) and is returned; ``Φ`` is
    updated in place.  On the card: the high pass (when
    :func:`flip_split` gives ``h > 0`` or partners come in), then the
    iteration pass."""
    if _device_kind(v0) == "cpu":
        return cheby_flip_iter_plain(v0, v1, phi, dmb, G, s2, ak, w, out,
                                     partners)
    out = v0 if out is None else out
    L = _check_iter(v0, v1, phi, out, w, dmb, G, partners)
    _refuse_grad("cheby_flip_iter", v0, v1, phi, out, dmb, G, s2, ak, w,
                 partners=partners)
    tile_bits, h = flip_split(L, v0.dtype)
    w = _outside(v1, G, w, L, h, partners)
    _launch_iter(v0, v1, phi, dmb, G, s2, ak, w, out, L, tile_bits, L - h)
    return out


def cheby_flip_iter_low(v0, v1, phi, dmb, G, s2, ak, bits, w=None,
                        out=None, partners=()):
    """The iteration pass of :func:`cheby_flip_iter`: the same order
    with the flips of bits ``0 .. bits−1`` only (the caller supplies the
    others through ``w``).  Partners are summed first by the high pass
    at ``h = 0``."""
    if _device_kind(v0) == "cpu":
        return cheby_flip_iter_low_plain(v0, v1, phi, dmb, G, s2, ak, bits,
                                         w, out, partners)
    out = v0 if out is None else out
    L = _check_iter(v0, v1, phi, out, w, dmb, G, partners)
    _check_bits(bits, 0, L)
    _refuse_grad("cheby_flip_iter", v0, v1, phi, out, dmb, G, s2, ak, w,
                 partners=partners)
    w = _outside(v1, G, w, L, 0, partners)
    _launch_iter(v0, v1, phi, dmb, G, s2, ak, w, out, L,
                 flip_split(L, v0.dtype)[0], bits)
    return out


def cheby_flip_high(v1, G, h, w=None, partners=()):
    """The high pass of :func:`cheby_flip_iter` (and, on ``v0``, of
    :func:`cheby_flip_first`): returns ``w_hi = Σ_{j ≥ L−h}
    G_j·v1[i ^ 2^j] + Σ_r G_{L+r}·partner_r`` (plus ``w`` when given) in
    a new vector.  On the card ``1 ≤ h ≤ 8``, or ``h = 0`` with
    partners."""
    if _device_kind(v1) == "cpu":
        return cheby_flip_high_plain(v1, G, h, w, partners)
    L = _check([v1] + _opt(w), None, G, partners)
    _check_bits(h, 0 if partners else 1, min(L, _MAX_HIGH_BITS))
    _refuse_grad("cheby_flip_high", v1, G, w, partners=partners)
    return _launch_high(v1, G, w, L, h, partners)


def _outside(x, G, w, L, h, partners):
    """The tiled pass's ``w``: the high pass's output over ``x`` where
    it has top bits or partners to sum, else ``w`` itself."""
    if h or partners:
        return _launch_high(x, G, w, L, h, partners)
    return w


def _check_iter(v0, v1, phi, out, w, dmb, G, partners=()) -> int:
    L = _check([v0, v1, phi, out] + _opt(w), dmb, G, partners)
    if v1.data_ptr() in (v0.data_ptr(), out.data_ptr(), phi.data_ptr()):
        raise ValueError("v1 must not share memory with v0, out or phi")
    return L


def _slots(L, *tensors):
    """Per slot, the tuple of each tensor's ``2^L``-entry row (``None``
    stays ``None``)."""
    views = [None if t is None else t.view(-1, 1 << L) for t in tensors]
    return [tuple(None if t is None else t[r] for t in views)
            for r in range(views[0].shape[0])]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _coefficient(a, v):
    """A Φ weight as the tiled kernels take it, ``(value, address)``: a
    number by value, a 0-d tensor of the state's real type on its device
    by address (read on the device, so that a replayed graph takes the
    values the tensor holds then)."""
    if not isinstance(a, torch.Tensor):
        return float(a), None
    if a.dim() != 0 or a.dtype != _TYPES[v.dtype][2] or a.device != v.device:
        raise ValueError(
            f"a coefficient tensor must be 0-d {_TYPES[v.dtype][2]} on "
            f"{v.device}, got {tuple(a.shape)} {a.dtype} on {a.device}")
    return 0.0, a.data_ptr()


def _launch_first(v0, dmb, G, s, a0, a1, w, L, tile_bits, bits):
    ctype, suffix, _ = _TYPES[v0.dtype]
    (a0, a0_ptr), (a1, a1_ptr) = _coefficient(a0, v0), _coefficient(a1, v0)
    if (a0_ptr is None) != (a1_ptr is None):
        raise ValueError("a0 and a1 must both be numbers or both tensors")
    v1 = torch.empty_like(v0)
    phi = torch.empty_like(v0)
    for x0, x1, p, d, wr in _slots(L, v0, v1, phi, dmb, w):
        _launch(
            f"cheby_flip_first_{suffix}", f"cheby_flip_first<{ctype}>",
            (x0.data_ptr(), x1.data_ptr(), p.data_ptr(), d.data_ptr(),
             G.data_ptr(), _ptr(wr), L, 1 << L, tile_bits, bits, float(s),
             a0, a1, a0_ptr, a1_ptr),
            v0.device,
        )
    return v1, phi


def _launch_iter(v0, v1, phi, dmb, G, s2, ak, w, out, L, tile_bits, bits):
    ctype, suffix, _ = _TYPES[v0.dtype]
    ak, ak_ptr = _coefficient(ak, v0)
    for x0, o, x1, p, d, wr in _slots(L, v0, out, v1, phi, dmb, w):
        _launch(
            f"cheby_flip_iter_{suffix}", f"cheby_flip_iter<{ctype}>",
            (x0.data_ptr(), o.data_ptr(), x1.data_ptr(), p.data_ptr(),
             d.data_ptr(), G.data_ptr(), _ptr(wr), L, 1 << L, tile_bits,
             bits, float(s2), ak, ak_ptr),
            v0.device,
        )


def _launch_high(v1, G, w, L, h, partners=()):
    ctype, suffix, _ = _TYPES[v1.dtype]
    w_hi = torch.empty_like(v1)
    rows = [(stack.view(-1, 1 << L), slot_xor) for stack, slot_xor in partners]
    line_bits = _line_bits(L, h, v1.dtype, bool(rows))
    for s, (x1, wr, o) in enumerate(_slots(L, v1, w, w_hi)):
        # no partners: a null table, the kernel without one
        ptrs = (ctypes.c_void_p * len(rows))(
            *[r[s ^ slot_xor].data_ptr() for r, slot_xor in rows]
        ) if rows else None
        _launch(
            f"cheby_flip_high_{suffix}", f"cheby_flip_high<{ctype}>",
            (x1.data_ptr(), G.data_ptr(), _ptr(wr), ptrs, len(rows),
             o.data_ptr(), L, 1 << L, h, line_bits),
            v1.device,
        )
    return w_hi
