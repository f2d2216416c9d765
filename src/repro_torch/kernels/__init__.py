"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref``) and the device dispatch (``ops``).

  batched_evict — eviction-victim selection over a policy score array
  fifo_grant    — budgeted head-of-line pop of the I/O request queue
  wake_solve    — grant step of every queued page (wake-exact jumps)
"""

from . import ops, ref
from .ops import (
    batched_evict, fifo_grant, launch_counts, reset_launch_counts,
    wake_solve,
)

__all__ = [
    "batched_evict", "fifo_grant", "launch_counts", "ops", "ref",
    "reset_launch_counts", "wake_solve",
]
