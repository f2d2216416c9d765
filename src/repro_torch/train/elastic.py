"""Elastic scaling: survive node loss by re-meshing and resharding (port of
``repro.train.elastic``).

Protocol (coordinator-driven, matches the checkpoint contract):

1. Failure detected (missed heartbeat / collective timeout) -> the run
   controller picks the largest healthy mesh from ``candidate_meshes``
   (e.g. 2x16x16 -> 16x16 -> 8x16: always shrink the pure-DP axes first so
   TP groups stay intact and no weight layout changes).
2. Every healthy host restarts the step loop with the new mesh; params/opt
   restore from the latest checkpoint via ``CheckpointManager.restore`` with
   the new mesh's NamedShardings (device_put reshards transparently).
3. The global batch is preserved by raising grad-accumulation microbatches
   by the DP shrink factor (`rebalance_microbatches`), so optimizer
   semantics (and the LR schedule) are unchanged — only step time grows.
4. Data streams resume exactly: positions (epoch, shard, page, offset) are
   in the checkpoint `extra`; lost readers' ranges are adopted via the
   pipeline's work stealing.

This module provides the pure decision logic (testable on CPU), a copy
of ``repro.train.elastic``, which builds no mesh either: a mesh over the
surviving devices is the caller's (``core.array_sim.init_mesh`` makes a
``torch.distributed`` DeviceMesh over a process group).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def chips(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out

    @property
    def dp_degree(self) -> int:
        out = 1
        for s, a in zip(self.shape, self.axes):
            if a in ("pod", "data"):
                out *= s
        return out


CANDIDATE_MESHES: List[MeshPlan] = [
    MeshPlan((2, 16, 16), ("pod", "data", "model")),
    MeshPlan((16, 16), ("data", "model")),
    MeshPlan((8, 16), ("data", "model")),
    MeshPlan((4, 16), ("data", "model")),
]


def plan_after_failure(
    healthy_chips: int, candidates: Sequence[MeshPlan] = CANDIDATE_MESHES
) -> Optional[MeshPlan]:
    """Largest candidate mesh that fits the surviving chips, preserving the
    model (TP) axis width so no parameter relayout is needed."""
    for plan in candidates:
        if plan.chips <= healthy_chips:
            return plan
    return None


def rebalance_microbatches(
    global_batch: int, old_dp: int, new_dp: int, old_microbatches: int
) -> int:
    """Keep the global batch (optimizer semantics) across a DP shrink."""
    assert global_batch % old_dp == 0
    per_replica = global_batch // old_dp * old_microbatches
    if global_batch % new_dp:
        raise ValueError(f"global batch {global_batch} not divisible by dp={new_dp}")
    per_replica_new = global_batch // new_dp
    # microbatch count grows so per-microbatch memory stays constant
    scale = max(1, per_replica_new * old_microbatches // max(per_replica, 1))
    return old_microbatches * max(1, scale)


def reassign_data_ranges(
    failed_readers: Sequence[int], healthy_readers: Sequence[int]
) -> List[Tuple[int, int]]:
    """Round-robin adoption of failed readers' shard ranges (work stealing)."""
    out = []
    for i, f in enumerate(failed_readers):
        out.append((f, healthy_readers[i % len(healthy_readers)]))
    return out
