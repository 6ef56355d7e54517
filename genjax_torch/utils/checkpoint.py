"""Checkpoint and restore of inference state: traces, particle
collections, chain states, any pytree of tensors (counterpart of
``genjax_tpu/utils/checkpoint.py``).

Two formats, chosen by the path as in the JAX package:

- a ``.npz`` file: ``leaf_{i}`` for the ``i``-th leaf in the JAX
  package's flatten order (a dict's keys sorted, ``None`` an empty
  subtree), so a file either package writes restores in the other
  wherever the two trees flatten alike. It holds what this process holds.
- a directory: ``torch.distributed.checkpoint`` (DCP) in place of Orbax.
  With a mesh (given, or the world's 1-D mesh when a process group is
  up) every leaf with a leading axis is this rank's slice of a global
  array and is saved as a ``DTensor`` with ``Shard(0)``; 0-d leaves are
  replicated. A restore lays the saved global arrays onto the restoring
  world's template, so a world of 2 saves and a world of 1 (or 4)
  restores its own rows: the counterpart of Orbax's cross-topology
  restore.

``like`` supplies the structure (and, for a directory, this rank's
shapes, dtypes and devices), as the JAX package's template does.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from genjax_torch.core.pytree import (
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

__all__ = ["save_checkpoint", "restore_checkpoint"]


def _sort_dicts(tree):
    """``tree`` with every dict's keys in sorted order (JAX's)."""
    def fix(x):
        if isinstance(x, dict):
            return {k: _sort_dicts(x[k]) for k in sorted(x)}
        return x

    return tree_map(fix, tree, is_leaf=lambda x: isinstance(x, dict))


def _jax_order(tree) -> tuple[list, Any, list[int]]:
    """``(leaves, spec, order)``: ``tree``'s leaves and spec in the port's
    flatten order, and the positions of its non-``None`` leaves in the
    JAX package's flatten order."""
    leaves, spec = tree_flatten(tree)
    index = tree_unflatten(list(range(len(leaves))), spec)
    order = [i for i in tree_leaves(_sort_dicts(index))
             if leaves[i] is not None]
    return leaves, spec, order


def _as_like(data, like):
    """A saved array as the template leaf's kind: a tensor with its
    dtype and device, or a Python number."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.asarray(data)).to(like.device, like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(np.asarray(data).item())
    return torch.as_tensor(np.asarray(data))


@contextlib.contextmanager
def _quiet():
    """DCP's notes that a process without a group saves alone, and that a
    checkpoint is overwritten: both are what these functions mean."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*assuming the intent")
        warnings.filterwarnings("ignore", message=".*existing checkpoint")
        yield


def _mesh_for(leaves, mesh):
    if mesh is not None or not dist.is_initialized():
        return mesh
    from genjax_torch.parallel.mesh import particle_mesh

    dev = next((v.device for v in leaves if isinstance(v, torch.Tensor)),
               torch.device("cpu"))
    return particle_mesh(dev.type)


def _dcp_entries(leaves, order, mesh):
    """The DCP state dict: ``leaf_{j}`` for the ``j``-th leaf in JAX
    order, a ``DTensor`` (``Shard(0)``) where the leaf is a rank's slice."""
    from torch.distributed.tensor import DTensor, Shard

    out = {}
    for j, i in enumerate(order):
        v = leaves[i]
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(v)
        if mesh is not None and v.ndim >= 1:
            v = DTensor.from_local(v.contiguous(), mesh, [Shard(0)],
                                   run_check=False)
        out[f"leaf_{j}"] = v
    return out


def save_checkpoint(path: str, state: Any, mesh=None) -> None:
    """Save ``state``'s leaves to ``path``: a ``.npz`` file, or a DCP
    directory (every rank of the mesh calls it, each with its slices)."""
    leaves, _, order = _jax_order(state)
    if path.endswith(".npz"):
        np.savez(path, **{
            f"leaf_{j}": (leaves[i].detach().cpu().numpy()
                          if isinstance(leaves[i], torch.Tensor)
                          else np.asarray(leaves[i]))
            for j, i in enumerate(order)})
        return
    import torch.distributed.checkpoint as dcp

    mesh = _mesh_for(leaves, mesh)
    path = os.path.abspath(path)
    with _quiet():
        dcp.save(_dcp_entries(leaves, order, mesh),
                 storage_writer=dcp.FileSystemWriter(path, overwrite=True),
                 no_dist=not dist.is_initialized())


def restore_checkpoint(path: str, like: Any, mesh=None) -> Any:
    """Restore a state saved by :func:`save_checkpoint`; ``like`` gives
    the structure and, for a directory, this rank's shapes, dtypes and
    devices (its values are not read)."""
    leaves, spec, order = _jax_order(like)
    out = list(leaves)
    if path.endswith(".npz"):
        with np.load(path) as data:
            for j, i in enumerate(order):
                out[i] = _as_like(data[f"leaf_{j}"], leaves[i])
        return tree_unflatten(out, spec)
    import torch.distributed.checkpoint as dcp

    mesh = _mesh_for(leaves, mesh)
    targets = _dcp_entries(
        [torch.empty_like(v) if isinstance(v, torch.Tensor) else v
         for v in leaves], order, mesh)
    with _quiet():
        dcp.load(targets, checkpoint_id=os.path.abspath(path),
                 no_dist=not dist.is_initialized())
    for j, i in enumerate(order):
        v = targets[f"leaf_{j}"]
        v = v.to_local() if hasattr(v, "to_local") else v
        out[i] = _as_like(v.detach().cpu(), leaves[i]) if not isinstance(
            leaves[i], torch.Tensor) else v.to(leaves[i].dtype)
    return tree_unflatten(out, spec)
