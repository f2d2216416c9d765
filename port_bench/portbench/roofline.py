"""Peaks of the card and the least time of the buffer-pool kernels B1-B3.

The arithmetic of ``chip_smoke.py``'s ``_bound_ms`` at commit 7b98c78,
frozen here: every input byte read once and every output byte written
once at the memory rate, against one comparison per page per level of a
sort plus one add per page at the float32 rate, whichever is longer.  The
bytes of each call follow from the shapes the simulator's step hands the
kernels (``src/repro_torch/core/array_sim/sim.py``: a ``(L, P)`` key row
per lane, the ``(P,)`` page sizes shared by every lane, one scalar per
lane of each budget, and the outputs of ``kernels/pbm_timeline.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

#: NVIDIA H100 SXM, data sheet: HBM3 bytes/s and float32 outside the
#: tensor cores (at the 700 W power limit), by the card's name
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_ops_per_s": 67e12},
}

#: CUDA kernel name (a part of it) -> the wrapper call it serves; each call
#: at P <= 16,384 is one launch of it
KERNELS = {
    "batched_evict_kernel": "B1",
    "fifo_grant_kernel": "B2",
    "wake_solve_kernel": "B3",
}
#: the page-split kernels (P beyond one block): a call is 2-4 launches of
#: these, which the per-call bound below does not price
SPLIT_KERNELS = ("split_evict_cand", "split_queue_cand", "split_sort_slices",
                 "split_rank", "split_evict_finish", "split_grant_finish",
                 "split_wake_finish")


def call_bytes(kernel: str, L: int, P: int) -> int:
    """Bytes one call reads and writes once: key (L, P) 4-byte, sizes (P,)
    f32, the per-lane scalars, and the outputs."""
    if kernel == "B1":       # key, sizes, evictable bool, need_free; mask bool
        return 4 * L * P + 4 * P + L * P + 4 * L + L * P
    if kernel == "B2":       # key, sizes, budget, pops; mask, bytes, count
        return 4 * L * P + 4 * P + 4 * L + 4 * L + L * P + 4 * L + 4 * L
    if kernel == "B3":       # key, sizes, credit0, inc, pops; step i32
        return 4 * L * P + 4 * P + 3 * 4 * L + 4 * L * P
    raise KeyError(kernel)


def bound_s(kernel: str, L: int, P: int, device: str) -> Tuple[float, str]:
    """Least seconds of one call, and which bound sets it."""
    peak = PEAKS[device]
    t_bytes = call_bytes(kernel, L, P) / peak["hbm_bytes_per_s"]
    n_ops = L * P * (max(1.0, math.log2(P)) + 1.0)
    t_ops = n_ops / peak["fp32_ops_per_s"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_of(name: str) -> Optional[str]:
    for part, k in KERNELS.items():
        if part in name:
            return k
    return None
