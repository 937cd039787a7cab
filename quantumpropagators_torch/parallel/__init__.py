"""Sharding over shard-slot meshes, multi-process start and checkpoints:
PyTorch port of :mod:`quantumpropagators.parallel`.

- :mod:`.mesh`: :class:`~.mesh.Mesh` (``n_devices`` shard slots over the
  ranks of a ``torch.distributed`` group), ``chain_mesh``,
  ``shard_vector``, ``replicate``, and the collectives ``ppermute``,
  ``all_gather``, ``psum``;
- :mod:`.distributed`: ``initialize_multihost`` and numpy-layout
  checkpoints;
- :mod:`.sharded_fused`: the sharded TFIM step on the flip kernels;
- :mod:`.sharded_chain`, :mod:`.sharded_csr`, :mod:`.sharded_bsr`,
  :mod:`.sharded_banded`: sharded operator applies and Chebyshev steps;
- :class:`~.sharded_bsr.DistributedBSR` and
  :class:`~.sharded_chain.ShardedChainOperator`: operators that carry
  their mesh, so ``arnoldi``, ``specrange``, ``expv``, ``newton`` and
  ``propagate`` take a sharded state unchanged.
"""

from .mesh import STATE_AXIS, Mesh, chain_mesh, replicate, shard_vector
from .sharded_bsr import DistributedBSR, partition_bsr, partition_bsr_dd
from .sharded_chain import (
    ShardedChainOperator,
    prepare_sharded_operator,
    shard_chain_operator,
)

__all__ = [
    "STATE_AXIS",
    "Mesh",
    "chain_mesh",
    "shard_vector",
    "replicate",
    "DistributedBSR",
    "partition_bsr",
    "partition_bsr_dd",
    "ShardedChainOperator",
    "shard_chain_operator",
    "prepare_sharded_operator",
]
