"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref``) and the device dispatch (``ops``).

  batched_evict   — eviction-victim selection over a policy score array
  fifo_grant      — budgeted head-of-line pop of the I/O request queue
  wake_solve      — grant step of every queued page (wake-exact jumps)
  paged_attention — decode attention through a page table (PBM-managed KV);
                    call it as ``ops.paged_attention``: the package's
                    ``paged_attention`` is the wrapper's module
  flash_attention — prefill attention (causal / window / full, GQA)
  mamba2_scan     — chunked SSD scan of the Mamba2 blocks
  mlstm_chunked   — chunkwise mLSTM (gated linear attention) of xLSTM

Call the model-stack kernels as ``ops.flash_attention`` etc. too.
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
