"""Shard-slot meshes: PyTorch port of :mod:`quantumpropagators.parallel.mesh`.

The JAX package runs one process over every device of a 1D mesh and
lets ``shard_map`` hand each device its block of the state.
``torch.distributed`` runs one process per rank instead, so the port's
counterpart of a mesh device is a **shard slot**: a mesh of
``n_devices`` slots spreads them over the ranks of a process group,
each rank holding ``n_devices / world_size`` consecutive slots on its
own device (JAX's "local devices per process").  One process alone
holds every slot, so the JAX tests' 8-device meshes run in one CPU
process and four slots of a 2^24 chain run on one GPU.

A sharded vector of ``N`` entries is, on each rank, a
``(local slots, N / n_devices)`` tensor of its slots' rows; with one
rank that is the full vector viewed as ``(n_devices, N / n_devices)``
(:meth:`Mesh.local`, no copy).  The collectives the sharded modules use
are methods of the mesh: :meth:`~Mesh.ppermute` (between slots of one
rank a copy of the partner slot, across ranks ``batch_isend_irecv``),
:meth:`~Mesh.all_gather` and :meth:`~Mesh.psum` (``all_reduce``).
Cross-rank traffic runs on the group's backend: NCCL on the card, gloo
on the CPU (:func:`.distributed.initialize_multihost`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.operators import as_tensor, resolve_device

__all__ = ["Mesh", "chain_mesh", "shard_vector", "replicate", "STATE_AXIS"]

STATE_AXIS = "x"


class Mesh:
    """``n_devices`` shard slots over the ranks of ``group`` (``None``:
    this process alone), the state-sharding axis :data:`STATE_AXIS`.
    Rank ``r`` of the group holds slots ``r·n_local .. (r+1)·n_local − 1``
    on ``device``."""

    def __init__(self, n_devices: int, group=None, device=None):
        if group is None:
            world, rank = 1, 0
        else:
            world, rank = dist.get_world_size(group), dist.get_rank(group)
        if n_devices < 1 or n_devices % world:
            raise ValueError(f"{n_devices} slots do not spread evenly over "
                             f"{world} ranks")
        self.n_devices = int(n_devices)
        self.group = group
        self.world_size = world
        self.rank = rank
        self.n_local = self.n_devices // world
        self.first_slot = rank * self.n_local
        self.device = resolve_device(device)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slots of a sharded vector as a ``(n_local, −1)``
        view; ``x`` is that tensor already or any contiguous tensor of
        the same entries (one rank: the full vector)."""
        return x.view(self.n_local, -1)

    def shard(self, x) -> torch.Tensor:
        """This rank's slots of the whole vector ``x``
        (:func:`shard_vector`)."""
        return shard_vector(self, x)

    def local_rows(self, x):
        """This rank's rows of a per-slot stack: ``x`` has one leading
        row per slot of the mesh (or per local slot already)."""
        if x.shape[0] == self.n_local:
            return x
        if x.shape[0] != self.n_devices:
            raise ValueError(f"leading axis {x.shape[0]} is neither "
                             f"{self.n_devices} slots nor {self.n_local}")
        return x[self.first_slot:self.first_slot + self.n_local]

    def _peer(self, slot: int) -> int:
        """The global rank that holds ``slot``."""
        r = slot // self.n_local
        return r if self.group in (None, dist.group.WORLD) \
            else dist.get_global_rank(self.group, r)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """``jax.lax.ppermute`` over the slots: ``perm`` is a list of
        ``(source, destination)`` slot pairs, the same on every rank;
        row ``d`` of the result is source ``s``'s row of ``x`` (a copy),
        zero where no pair names ``d``.  ``x`` is ``(n_local, ...)``."""
        lo, hi = self.first_slot, self.first_slot + self.n_local
        src_of, ops, recvs = {}, [], []
        for s, d in perm:
            s_here, d_here = lo <= s < hi, lo <= d < hi
            if s_here and d_here:
                src_of[d - lo] = s - lo
            elif s_here:
                ops.append(dist.P2POp(dist.isend,
                                      _wire(x[s - lo].contiguous()),
                                      self._peer(d), self.group))
            elif d_here:
                buf = torch.empty_like(x[0])
                recvs.append((d - lo, buf))
                ops.append(dist.P2POp(dist.irecv, _wire(buf), self._peer(s),
                                      self.group))
        # rows are copied by views: an index tensor built from a list
        # would be a host-to-device copy that waits for the device
        if len(src_of) == self.n_local:  # all local: one copy
            return torch.stack([x[src_of[d]] for d in range(self.n_local)])
        full = len(src_of) + len(recvs) == self.n_local
        out = torch.empty_like(x) if full else torch.zeros_like(x)
        for d, s in src_of.items():
            out[d].copy_(x[s])
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            for d, buf in recvs:
                out[d] = buf
        return out

    def halos(self, x: torch.Tensor, w: int):
        """The ring's edge exchange of ``w`` entries per slot: returns
        ``(left, right)``, each ``(n_local, w)``, the left neighbour
        slot's last ``w`` entries and the right neighbour's first ``w``
        (the global edges wrap around)."""
        n = self.n_devices
        left = self.ppermute(x[:, -w:].contiguous(),
                             [(s, (s + 1) % n) for s in range(n)])
        right = self.ppermute(x[:, :w].contiguous(),
                              [(s, (s - 1) % n) for s in range(n)])
        return left, right

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every slot's row: ``(n_local, ...)`` in, ``(n_devices, ...)``
        out, in slot order."""
        if self.world_size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather([_wire(p) for p in parts], _wire(x.contiguous()),
                        group=self.group)
        return torch.cat(parts)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over all slots of per-slot values ``x`` of shape
        ``(n_local, ...)``, the same on every rank.  Runs one
        ``all_reduce`` when the group spans more than one rank (with one
        rank the local sum is the sum, and a graph that captures it holds
        no collective)."""
        total = x.sum(0)
        if self.group is not None and self.world_size > 1:
            dist.all_reduce(_wire(total), group=self.group)
        return total



def device_bits(n_devices: int) -> int:
    """``p`` with ``n_devices = 2^p``; raises for other counts."""
    p = n_devices.bit_length() - 1
    if n_devices < 1 or (1 << p) != n_devices:
        raise ValueError("n_devices must be a power of two")
    return p


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A real view of ``t`` for the backends (gloo has no complex
    types); writes through to ``t``."""
    return torch.view_as_real(t) if t.is_complex() else t


def chain_mesh(n_devices: int | None = None, *, group=None,
               device=None) -> Mesh:
    """1D mesh of ``n_devices`` shard slots (default: one per rank of
    ``group``) with the state-sharding axis :data:`STATE_AXIS`."""
    if n_devices is None:
        n_devices = 1 if group is None else dist.get_world_size(group)
    return Mesh(n_devices, group=group, device=device)


def shard_vector(mesh: Mesh, x, axis: int = 0) -> torch.Tensor:
    """This rank's slots of ``x`` split along ``axis``: a
    ``(n_local, n / n_devices, ...)`` tensor on the mesh's device (the
    split axis first)."""
    x = as_tensor(x, device=mesh.device).movedim(axis, 0)
    n = x.shape[0]
    if n % mesh.n_devices:
        raise ValueError(f"axis of {n} entries not divisible by "
                         f"{mesh.n_devices} slots")
    rows = x.reshape((mesh.n_devices, n // mesh.n_devices) + x.shape[1:])
    return mesh.local_rows(rows).contiguous()


def replicate(mesh: Mesh, x) -> torch.Tensor:
    """``x`` whole on the mesh's device (every rank holds all of it)."""
    return as_tensor(x, device=mesh.device)
