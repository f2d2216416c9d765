"""The process group and ``DeviceMesh`` of a simulator sweep across
processes: the port's counterpart of building a ``jax.sharding.Mesh``.

Every process of the sweep calls :func:`init_mesh` with the same shape,
dimension names and device type, then ``make_runner(spec, mesh=mesh)``
with the same knobs, and calls the runner with the same whole stacked
config; :func:`close_mesh` ends the group.  Under ``torchrun`` the rank,
world size and rendezvous come from its environment
(``torchrun --nproc-per-node=N sweep.py``); spawned processes name them,
e.g. a ``file://`` rendezvous.

* ``cuda``: NCCL, one card a rank (the card of the rank's local rank),
  the communicator made eagerly (``device_id``) so that the step's
  all-gather can be captured in the runner's CUDA graphs;
* ``cpu``: ``gloo``.

``backend`` overrides that choice (``gloo`` on CUDA tensors runs two ranks
on one card, eagerly: a ``gloo`` collective cannot be captured, so
``make_runner`` refuses a ``gloo`` page group on CUDA).

Timeouts: the ranks of a page row all-gather at every step, in lockstep,
so a page group waits at most ``TIMEOUT_S`` = 60 s and a rank that hangs
there fails the run instead of stalling it.  A lanes group's one
all-gather comes after each rank has run its whole lane shard, and the
shards end when their own lanes end (as a ``shard_map`` device's loop
does), minutes apart in a large sweep: the lanes groups and the default
group wait PyTorch's default for the backend (10 min for NCCL, 30 min
for ``gloo``).
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["TIMEOUT_S", "close_mesh", "init_mesh"]

#: the longest a page group's collective may wait, in seconds
TIMEOUT_S = 60.0


def init_mesh(shape: Sequence[int], names: Sequence[str] = ("lanes", "page"),
              device_type: str = "cuda", *, backend: Optional[str] = None,
              init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None):
    """A ``DeviceMesh`` of ``shape`` with ``names`` over the default
    process group of ``prod(shape)`` ranks, made first if there is none
    (a second mesh over the same ranks makes only its own groups);
    ``rank``, ``world_size`` and ``init_method`` default to torchrun's
    ``RANK``, ``WORLD_SIZE`` and ``env://``.  Row-major: rank r sits at
    ``np.unravel_index(r, shape)``, so the ranks of a page row are
    consecutive.  The second dimension's groups (page rows) wait at most
    ``TIMEOUT_S``; the others the backend's default."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape = tuple(int(n) for n in shape)
    if len(names) != len(shape):
        raise ValueError(f"init_mesh: {len(names)} names for shape {shape}")
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world = (int(os.environ["WORLD_SIZE"]) if world_size is None
             else int(world_size))
    if math.prod(shape) != world:
        raise ValueError(f"init_mesh: shape {shape} is not {world} ranks")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    device = None
    if device_type == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("init_mesh: no CUDA device is visible")
        if backend == "nccl" and world > n_cards:
            raise ValueError(f"init_mesh: NCCL takes one card a rank; "
                             f"{world} ranks, {n_cards} cards")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(device)
    lockstep = datetime.timedelta(seconds=TIMEOUT_S)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world,
            device_id=device if backend == "nccl" else None)
    elif (dist.get_rank(), dist.get_world_size()) != (rank, world):
        raise ValueError(
            f"init_mesh: the process group has rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, not {rank} of {world}")
    grid = np.arange(world).reshape(shape)
    groups = []
    for dim, size in enumerate(shape):
        # every rank makes every group of a dimension, in the same order
        mine = None
        for ranks in np.moveaxis(grid, dim, -1).reshape(-1, size).tolist():
            group = dist.new_group(
                ranks, backend=backend,
                timeout=lockstep if dim == 1 else None)
            if rank in ranks:
                mine = group
        groups.append(mine)
    return DeviceMesh.from_group(groups, device_type,
                                 mesh=torch.as_tensor(grid),
                                 mesh_dim_names=tuple(names))


def close_mesh() -> None:
    """End the process group :func:`init_mesh` made (its subgroups too)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
