"""The one collective of the buffer-pool kernels' page split across ranks.

The JAX package's page-sharded ops gather each page shard's candidates
with ``jax.lax.all_gather`` over the mesh's page axis
(``repro/kernels/ops.py:115-168``); the port's counterpart is
``torch.distributed``'s all-gather into one tensor over the page group of
a ``DeviceMesh``.  On a CUDA tensor and an NCCL group it is a device
collective that reads nothing back to the host and that a CUDA graph
captures once the communicator exists; on a CPU tensor (``gloo``) the
simulator's whole runner is host code anyway.  ``torch.distributed`` is
imported here only when a collective runs.
"""

from __future__ import annotations

import torch


def size_rank(group) -> tuple:
    """``(ranks in the group, this process's rank in it)``."""
    import torch.distributed as dist
    return dist.get_world_size(group), dist.get_rank(group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (same shape and dtype on each), stacked in rank
    order: ``(n, *x.shape)``.  A bool tensor travels as its bytes."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    src = x.contiguous()
    wire = (src.view(torch.uint8) if src.dtype == torch.bool else src) \
        .reshape(-1)
    out = torch.empty((n * wire.numel(),), dtype=wire.dtype,
                      device=wire.device)
    dist.all_gather_into_tensor(out, wire, group=group)
    out = out.view(n, *src.shape)
    return out.view(torch.bool) if src.dtype == torch.bool else out
