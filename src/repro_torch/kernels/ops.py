"""Dispatch of the port's kernels, by the tensor's device alone.

A CPU tensor takes the plain PyTorch version (:mod:`.ref`); a CUDA tensor
launches the hand-written kernel (:mod:`.pbm_timeline`,
:mod:`.paged_attention`, :mod:`.flash_attention`, :mod:`.mamba2_scan`,
:mod:`.mlstm`) or raises.  There is no process-global backend
switch and no fallback around a build or a launch: what runs is decided by
where the caller put the data.

Under autograd (grad mode on and an input that requires grad) a CUDA call
of B5-B7 goes through :mod:`.autograd`: the kernel in the forward, the
plain version's VJP recomputed in the backward, each backward counted
(:func:`recompute_counts`).  Without grad it launches the kernel exactly
as before; a CPU call takes the plain version, which autograd
differentiates itself.  Inside ``accounting.card_route()`` (the dry run)
a ``meta`` tensor of B5-B7 takes the card's route with the kernel
replaced by a shape-only operator that the flop counter counts by the
kernel's bound formula (:mod:`.accounting`); outside it a meta tensor
reaches the kernel's wrapper, which refuses it.

Signatures are the JAX package's (``repro.kernels.ops``).  The buffer-pool
kernels add the leading lane axis: ``key`` is ``(L, P)``, scalars are
``(L,)``, ``sizes`` is ``(L, P)`` or one shared ``(P,)`` row.
"""

from __future__ import annotations

from typing import Optional

from . import accounting, autograd, pbm_timeline, ref
from .flash_attention import flash_attention_kernel
from .mamba2_scan import mamba2_scan_kernel
from .mlstm import mlstm_chunked_kernel
from .paged_attention import paged_attention_kernel

__all__ = ["batched_evict", "fifo_grant", "wake_solve", "paged_attention",
           "flash_attention", "mamba2_scan", "mlstm_chunked",
           "launch_counts", "reset_launch_counts", "add_launch_counts",
           "recompute_counts",
           "reset_recompute_counts", "KERNELS"]

#: every kernel wrapper by name; each counts its own launches
KERNELS = {**pbm_timeline.KERNELS, "paged_attention": paged_attention_kernel,
           "flash_attention": flash_attention_kernel,
           "mamba2_scan": mamba2_scan_kernel,
           "mlstm_chunked": mlstm_chunked_kernel}


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (kernel name -> launches, negative to take some
    back) to the kernels' counts.  A wrapper counts where it launches; in
    a captured CUDA graph that is once, at capture, so the simulator's
    runner adds each graph's launches at every replay."""
    for name, n in counts.items():
        KERNELS[name].launches += n


def recompute_counts() -> dict:
    """Backward recomputes of B5-B7's plain versions (:mod:`.autograd`)
    since the last :func:`reset_recompute_counts`."""
    return dict(autograd.RECOMPUTES)


def reset_recompute_counts() -> None:
    for name in autograd.RECOMPUTES:
        autograd.RECOMPUTES[name] = 0


def batched_evict(key, sizes, evictable, need_free, *, vmax: int = 64,
                  page_shards: int = 1, page_group=None):
    """Batched evict selection over a policy score array: the policy is
    entirely in ``key`` (f32 or i32, higher = evicted first).

    ``page_shards`` is the counterpart of the JAX package's ``page_axis``:
    with ``n > 1`` each of ``n`` page shards selects the candidates of its
    own ``P / n`` slice and the vmax-bounded prefix runs on the gathered
    list, bit-equal to the unsplit answer (``ref.evict_page_sharded``; on
    the card, one block a shard).  ``n`` must divide P.  A row too long
    for one block is split on the card whatever ``page_shards`` says.

    ``page_group`` (a ``torch.distributed`` group: the page axis of a
    ``DeviceMesh``, one process a device) splits the selection across its
    ranks instead, each holding the same rows: each rank selects in its
    own ``P / n`` slice, the ranks all-gather the candidates and every
    rank computes the same mask (``ref.evict_rank_sharded``; on the card
    two launches with the all-gather between them)."""
    if page_group is not None and int(page_shards) > 1:
        raise ValueError("page_shards and page_group: one page split only")
    if key.device.type == "cpu":
        if page_group is not None:
            return ref.evict_rank_sharded(key, sizes, evictable, need_free,
                                          page_group, vmax=vmax)
        if int(page_shards) > 1:
            return ref.evict_page_sharded(key, sizes, evictable, need_free,
                                          int(page_shards), vmax=vmax)
        return ref.batched_evict_ref(key, sizes, evictable, need_free,
                                     vmax=vmax)
    return pbm_timeline.batched_evict_kernel(key, sizes, evictable,
                                             need_free, vmax=vmax,
                                             page_shards=page_shards,
                                             page_group=page_group)


def fifo_grant(key, sizes, budget, pops, *, vmax: int = 16,
               page_shards: int = 1, page_group=None):
    """Budgeted FIFO grant over the request-queue key array (the serial
    I/O server's pop, sized for a macro-step).  ``page_shards`` splits
    the candidate selection over page shards as in :func:`batched_evict`
    (``ref.grant_page_sharded``), ``page_group`` across the ranks of a
    page group (``ref.grant_rank_sharded``), bit-equal to the unsplit
    answer."""
    if page_group is not None and int(page_shards) > 1:
        raise ValueError("page_shards and page_group: one page split only")
    if key.device.type == "cpu":
        if page_group is not None:
            return ref.grant_rank_sharded(key, sizes, budget, pops,
                                          page_group, vmax=vmax)
        if int(page_shards) > 1:
            return ref.grant_page_sharded(key, sizes, budget, pops,
                                          int(page_shards), vmax=vmax)
        return ref.fifo_grant_ref(key, sizes, budget, pops, vmax=vmax)
    return pbm_timeline.fifo_grant_kernel(key, sizes, budget, pops,
                                          vmax=vmax, page_shards=page_shards,
                                          page_group=page_group)


def wake_solve(key, sizes, credit0, inc, pops, *, h_cap: int = 64):
    """Per-page grant step of the frozen serial I/O server.  It takes no
    ``page_shards``: its output feeds lane-global jump decisions, so it
    runs unsplit, as in the JAX package ("runs replicated as-is"); a row
    too long for one block still takes the card's page-split kernels."""
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


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None,
                    offset: Optional[int] = None):
    """Prefill attention: ``q`` ``(B, T, H, dh)``, GQA ``k``/``v``
    ``(B, S, Hk, dh)`` -> ``(B, T, H, dh)`` in ``q.dtype``; query ``t`` and
    key ``s`` are ``t - s + offset`` apart (default ``S - T``, the JAX
    oracle's alignment)."""
    if accounting.takes_card_route(q):
        fwd = accounting.op("flash_attention")
    elif q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       offset=offset)
    else:
        fwd = flash_attention_kernel
    if autograd.wants_grad(q, k, v):
        return autograd.recompute_vjp(
            "flash_attention", fwd, ref.flash_attention_ref,
            (q, k, v), dict(causal=causal, window=window, offset=offset))
    return fwd(q, k, v, causal=causal, window=window, offset=offset)


def mamba2_scan(xh, a, b, c):
    """Chunked SSD scan output: ``xh`` ``(B, T, H, P)``, ``a`` ``(B, T, H)``
    f32, ``b``/``c`` ``(B, T, N)`` -> ``y`` ``(B, T, H, P)`` in
    ``xh.dtype``."""
    if accounting.takes_card_route(xh):
        fwd = accounting.op("mamba2_scan")
    elif xh.device.type == "cpu":
        return ref.mamba2_scan_ref(xh, a, b, c)
    else:
        fwd = mamba2_scan_kernel
    if autograd.wants_grad(xh, a, b, c):
        return autograd.recompute_vjp("mamba2_scan", fwd,
                                      ref.mamba2_scan_ref, (xh, a, b, c), {})
    return fwd(xh, a, b, c)


def mlstm_chunked(q, k, v, a, i):
    """Chunkwise mLSTM output: ``q``/``k`` ``(B, T, H, K)``, ``v``
    ``(B, T, H, P)``, ``a``/``i`` ``(B, T, H)`` f32 -> ``y`` ``(B, T, H, P)``
    in ``v.dtype``."""
    if accounting.takes_card_route(v):
        fwd = accounting.op("mlstm_chunked")
    elif v.device.type == "cpu":
        return ref.mlstm_chunked_ref(q, k, v, a, i)
    else:
        fwd = mlstm_chunked_kernel
    if autograd.wants_grad(q, k, v, a, i):
        return autograd.recompute_vjp("mlstm_chunked", fwd,
                                      ref.mlstm_chunked_ref,
                                      (q, k, v, a, i), {})
    return fwd(q, k, v, a, i)
