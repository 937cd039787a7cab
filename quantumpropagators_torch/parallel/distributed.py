"""Multi-process runtime and checkpoint/resume: PyTorch port of
:mod:`quantumpropagators.parallel.distributed`.

- :func:`initialize_multihost` starts ``torch.distributed`` (NCCL when
  the package's default device is ``cuda``, gloo on the CPU); a mesh
  built on the resulting group (:func:`.mesh.chain_mesh`) spreads its
  shard slots over the processes.
- :func:`save_checkpoint` / :func:`load_checkpoint` write and read the
  JAX package's numpy layout: ``<path>.npz`` with ``/``-joined keys
  plus ``<path>.json`` listing them, so a checkpoint of either package
  loads in the other.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.operators import default_device, host_np

__all__ = [
    "initialize_multihost",
    "save_checkpoint",
    "load_checkpoint",
    "propagator_checkpoint_state",
    "restore_propagator",
]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
):
    """Start the multi-process runtime; returns the world group.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of
    rank 0; with no arguments the ``MASTER_ADDR``/``MASTER_PORT``/
    ``WORLD_SIZE``/``RANK`` environment is read.  ``backend`` defaults
    to ``"nccl"`` when the default device is ``cuda`` and ``"gloo"``
    otherwise.  Must run on every process before any mesh is built.
    """
    if backend is None:
        backend = "nccl" if default_device().type == "cuda" else "gloo"
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=init, **kwargs)
    return dist.group.WORLD


def propagator_checkpoint_state(propagator) -> dict:
    """Extract the durable state of a propagator: everything needed to
    resume (state, grid position, control parameters), as host numpy
    arrays."""
    params = {}
    if propagator.parameters is not None:
        for i, c in enumerate(propagator.parameters):
            params[str(i)] = host_np(propagator.parameters[c])
    return {
        "state": host_np(propagator.state),
        "t": float(propagator.t),
        "n": int(getattr(propagator, "n", 0)),
        "backward": bool(propagator.backward),
        "parameters": params,
    }


def restore_propagator(propagator, ckpt: dict):
    """Restore a propagator from :func:`propagator_checkpoint_state`
    output (the durable analogue of ``set_state!`` + ``set_t!``); the
    state goes to the device of the propagator's current state."""
    propagator.set_state(torch.as_tensor(np.asarray(ckpt["state"]),
                                         device=propagator.state.device))
    propagator.set_t(float(ckpt["t"]))
    if ckpt.get("parameters") and propagator.parameters is not None:
        for i, c in enumerate(propagator.parameters):
            key = str(i)
            if key in ckpt["parameters"]:
                propagator.parameters[c] = np.asarray(ckpt["parameters"][key])
    return propagator


def save_checkpoint(path, tree: dict) -> None:
    """Save a nested dict of arrays (tensors, numpy arrays, numbers) as
    ``<path>.npz`` + ``<path>.json``.  In a multi-process run call it
    from every process; only rank 0 writes."""
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {}

    def _flatten(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                _flatten(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = host_np(obj)

    _flatten("", tree)
    np.savez(str(path) + ".npz", **flat)
    with open(str(path) + ".json", "w") as f:
        json.dump(sorted(flat), f)


def load_checkpoint(path) -> dict:
    """Load a checkpoint written by :func:`save_checkpoint` (or by the
    JAX package's numpy fallback) as a nested dict of numpy arrays."""
    tree: dict = {}
    with np.load(str(Path(path)) + ".npz", allow_pickle=False) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree
