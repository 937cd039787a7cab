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
  :mod:`.sharded_banded`: sharded operator applies and Chebyshev steps.
"""
