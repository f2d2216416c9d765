"""Dispatch of the port's kernels, by the tensor's device alone.

A CPU tensor takes the plain PyTorch version (:mod:`.ref`); a CUDA tensor
launches the hand-written kernel (:mod:`.pbm_timeline`,
:mod:`.paged_attention`) or raises.  There is no process-global backend
switch and no fallback around a build or a launch: what runs is decided by
where the caller put the data.

Signatures are the JAX package's (``repro.kernels.ops``).  The buffer-pool
kernels add the leading lane axis: ``key`` is ``(L, P)``, scalars are
``(L,)``, ``sizes`` is ``(L, P)`` or one shared ``(P,)`` row.
"""

from __future__ import annotations

from . import pbm_timeline, ref
from .paged_attention import paged_attention_kernel

__all__ = ["batched_evict", "fifo_grant", "wake_solve", "paged_attention",
           "launch_counts", "reset_launch_counts", "KERNELS"]

#: every kernel wrapper by name; each counts its own launches
KERNELS = {**pbm_timeline.KERNELS, "paged_attention": paged_attention_kernel}


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def batched_evict(key, sizes, evictable, need_free, *, vmax: int = 64):
    """Batched evict selection over a policy score array: the policy is
    entirely in ``key`` (f32 or i32, higher = evicted first)."""
    if key.device.type == "cpu":
        return ref.batched_evict_ref(key, sizes, evictable, need_free,
                                     vmax=vmax)
    return pbm_timeline.batched_evict_kernel(key, sizes, evictable,
                                             need_free, vmax=vmax)


def fifo_grant(key, sizes, budget, pops, *, vmax: int = 16):
    """Budgeted FIFO grant over the request-queue key array (the serial
    I/O server's pop, sized for a macro-step)."""
    if key.device.type == "cpu":
        return ref.fifo_grant_ref(key, sizes, budget, pops, vmax=vmax)
    return pbm_timeline.fifo_grant_kernel(key, sizes, budget, pops,
                                          vmax=vmax)


def wake_solve(key, sizes, credit0, inc, pops, *, h_cap: int = 64):
    """Per-page grant step of the frozen serial I/O server."""
    if key.device.type == "cpu":
        return ref.wake_solve_ref(key, sizes, credit0, inc, pops,
                                  h_cap=h_cap)
    return pbm_timeline.wake_solve_kernel(key, sizes, credit0, inc, pops,
                                          h_cap=h_cap)


def paged_attention(q, k_pages, v_pages, page_table, seq_lens):
    """One decode step of GQA attention through a page table: ``q``
    ``(B, H, dh)``, K/V pages ``(n_pages, page_size, Hk, dh)``,
    ``page_table`` ``(B, pages_per_seq)`` i32, ``seq_lens`` ``(B,)`` i32
    -> ``(B, H, dh)`` in ``q.dtype``."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, page_table,
                                       seq_lens)
    return paged_attention_kernel(q, k_pages, v_pages, page_table, seq_lens)
