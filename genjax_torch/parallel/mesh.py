"""Device meshes over the initialized process group, and the layout
helpers of sharded inference (counterpart of
``genjax_tpu/parallel/mesh.py``).

A mesh is ``torch.distributed.device_mesh.DeviceMesh``: one rank is one
device, and a named mesh axis is a process group. JAX's ``Mesh`` lays a
global array over devices and ``with_sharding_constraint`` pins its
layout; torch has no global array. Here every sharded value is the
rank's own slice of the leading axis, and each sharded function takes
and returns local slices (replicated values, such as log Z, are equal on
every rank). So ``P`` and ``NamedSharding`` have no counterpart, and the
helpers below move between the two views: :func:`shard_leading_axis`
cuts this rank's slice from a tree every rank holds whole, and
:func:`gather_leading_axis` gathers the whole tree back (the counterpart
of reading a sharded ``jax.Array`` whole). A mesh needs a process group:
without one (:func:`~genjax_torch.parallel.bootstrap.init_distributed`)
the mesh helpers raise.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from genjax_torch.core.pytree import tree_map

__all__ = [
    "DeviceMesh",
    "particle_mesh",
    "host_device_mesh",
    "shard_leading_axis",
    "replicated",
    "gather_leading_axis",
    "rank_range",
]


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs a process group: call "
            "genjax_torch.parallel.init_distributed(...) first (a world "
            "of one: init_distributed(num_processes=1))")
    return dist.get_world_size()


def particle_mesh(device: str = "cuda", axis_name: str = "particles"
                  ) -> DeviceMesh:
    """A 1-D mesh over every rank of the world, for sharding the particle
    or chain axis. ``device="cpu"`` for a gloo world."""
    return init_device_mesh(torch.device(device).type, (_world(),),
                            mesh_dim_names=(axis_name,))


def host_device_mesh(axis_names=("hosts", "chips"), device: str = "cuda"
                     ) -> DeviceMesh:
    """A 2-D (hosts x local devices) mesh: ``LOCAL_WORLD_SIZE`` ranks a
    host (all ranks on one host when it is unset)."""
    world = _world()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"host_device_mesh: world {world} is not a "
                         f"multiple of LOCAL_WORLD_SIZE {local}")
    return init_device_mesh(torch.device(device).type,
                            (world // local, local),
                            mesh_dim_names=tuple(axis_names))


class Axis(NamedTuple):
    """A mesh axis as the collectives use it: its process group, its size
    and this rank's index along it."""

    group: dist.ProcessGroup
    size: int
    rank: int

    def global_rank(self, index: int) -> int:
        return dist.get_global_rank(self.group, index % self.size)


def mesh_axis(mesh: DeviceMesh, axis_name) -> Axis:
    """The process group of ``axis_name``; a tuple of names is the
    flattened group of those axes (row-major, as JAX orders a tuple
    axis)."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"a mesh here is a torch DeviceMesh (parallel.particle_mesh / "
            f"host_device_mesh), not {type(mesh).__name__}")
    if isinstance(axis_name, tuple) and len(axis_name) > 1:
        group = mesh[axis_name]._flatten().get_group()
    else:
        if isinstance(axis_name, tuple):
            (axis_name,) = axis_name
        group = mesh.get_group(axis_name)
    return Axis(group, dist.get_world_size(group), dist.get_rank(group))


def rank_range(n: int, mesh: DeviceMesh, axis_name) -> tuple[int, int]:
    """This rank's ``[lo, hi)`` of an axis of ``n`` split evenly over
    ``mesh[axis_name]``."""
    ax = mesh_axis(mesh, axis_name)
    if n % ax.size:
        raise ValueError(f"{n} do not divide over {ax.size} ranks")
    per = n // ax.size
    return ax.rank * per, (ax.rank + 1) * per


def _is_sharded(x) -> bool:
    return isinstance(x, torch.Tensor) and x.ndim >= 1


def shard_leading_axis(tree, mesh: DeviceMesh, axis_name="particles"):
    """This rank's slice of the leading axis of every tensor leaf of
    ``tree`` (a tree every rank holds whole); 0-d tensors and Python
    values pass as they are."""
    ax = mesh_axis(mesh, axis_name)

    def cut(x):
        if not _is_sharded(x):
            return x
        n = x.shape[0]
        if n % ax.size:
            raise ValueError(f"shard_leading_axis: leading axis {n} does "
                             f"not divide over {ax.size} ranks")
        per = n // ax.size
        return x[ax.rank * per:(ax.rank + 1) * per]

    return tree_map(cut, tree)


def gather_leading_axis(tree, mesh: DeviceMesh, axis_name="particles"):
    """Every tensor leaf of ``tree`` (this rank's slice) gathered whole
    along its leading axis, in rank order; 0-d tensors pass. One
    all-gather a leaf, counted in ``collectives.comm``."""
    from genjax_torch.parallel.collectives import all_gather

    ax = mesh_axis(mesh, axis_name)
    return tree_map(lambda x: all_gather(x, ax, "gather")
                    if _is_sharded(x) else x, tree)


def replicated(tree, mesh: DeviceMesh):
    """``tree`` as it is, after checking that every tensor leaf holds the
    same value on every rank of ``mesh`` (a max and a min all-reduce a
    leaf; it raises where the ranks differ). A NaN equals a NaN at the
    same position: a float leaf goes up with its NaN mask beside it and
    its NaNs set to 0, so a value or its NaN-ness that differs between
    ranks raises, and a NaN that every rank holds passes."""
    from genjax_torch.parallel.collectives import all_reduce

    ax = Axis(mesh.get_group() if mesh.ndim == 1
              else mesh._flatten().get_group(),
              mesh.size(), mesh.get_rank())

    def check(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.is_floating_point():
            v = x.detach().to(torch.float64)
            nan = torch.isnan(v)
            v = torch.stack([torch.where(nan, torch.zeros_like(v), v),
                             nan.to(torch.float64)])
        else:
            v = x.detach().to(torch.int64)
        hi = all_reduce(v, dist.ReduceOp.MAX, ax, "replicated")
        lo = all_reduce(v, dist.ReduceOp.MIN, ax, "replicated")
        same = torch.equal(hi, v) and torch.equal(lo, v)
        if not same:
            raise ValueError("replicated: a leaf differs across ranks")
        return x

    return tree_map(check, tree)
