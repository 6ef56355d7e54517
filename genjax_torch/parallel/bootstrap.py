"""Process-group bootstrap for inference across processes (counterpart of
``genjax_tpu/parallel/bootstrap.py``).

JAX needs no initialization on one host and ``jax.distributed`` across
hosts. torch needs a process group for any collective, even in a world of
one, so :func:`init_distributed` always creates one: NCCL when the ranks
run on CUDA cards, gloo on the CPU. Each rank's card is
``cuda:{LOCAL_RANK}``. Under ``torchrun`` (which sets ``MASTER_ADDR``,
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``) call it with no arguments.
Nothing falls back: a world that cannot start raises.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "is_multihost", "local_particle_slice"]

#: How long a collective may wait for its peers before it raises.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str = "cuda",
    init_method: str | None = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Create this process's group. ``coordinator_address`` (``host:port``)
    becomes ``tcp://host:port``; ``init_method`` (a ``file://`` store, say)
    may be given instead. With neither and ``num_processes`` of 1 or
    less, the world of one meets in an in-memory store; with neither
    and more processes, torchrun's environment (``env://``) names the
    world. ``device="cuda"`` (the default) binds the rank to
    ``cuda:{LOCAL_RANK}`` and starts NCCL at once, so a card whose NCCL
    cannot start fails here; ``device="cpu"`` takes gloo."""
    dev_type = torch.device(device).type
    if dev_type not in ("cuda", "cpu"):
        raise ValueError(f"init_distributed: device {device!r} is neither "
                         "cuda nor cpu")
    kwargs = {"timeout": timeout}
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: device='cuda' and no CUDA "
                               "card is available; pass device='cpu' for "
                               "gloo")
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
        kwargs["backend"] = "nccl"
        kwargs["device_id"] = local
    else:
        kwargs["backend"] = "gloo"
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    single = num_processes is not None and num_processes <= 1
    if single:
        kwargs.update(rank=0, world_size=1)
        if init_method is None:
            kwargs["store"] = dist.HashStore()
    elif num_processes is not None:
        kwargs.update(rank=process_id, world_size=num_processes)
    if "store" not in kwargs:
        kwargs["init_method"] = init_method or "env://"
    dist.init_process_group(**kwargs)


def is_multihost() -> bool:
    """More than one process in the world."""
    return dist.is_initialized() and dist.get_world_size() > 1


def local_particle_slice(n_particles: int) -> tuple[int, int]:
    """The ``[start, stop)`` range of the global particle axis this rank
    owns under an even layout: for rank-local IO (checkpoint shards,
    observation feeding)."""
    per_rank = n_particles // dist.get_world_size()
    start = dist.get_rank() * per_rank
    return start, start + per_rank
