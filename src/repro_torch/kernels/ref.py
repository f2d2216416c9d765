"""Plain PyTorch versions of the port's kernels.

Each function defines the semantics of one kernel: the three buffer-pool
kernels of ``csrc/pbm_timeline.cu`` over a leading lane axis ``L`` (one
lane = one point of a sweep), and paged decode attention
(``csrc/paged_attention.cu``, :func:`paged_attention_ref`).  They are what
runs for CPU tensors, and what the CUDA kernels are held to on the card.

The rest of this note is about the three buffer-pool kernels.

Order is always **(key descending, page index ascending)**, taken from a
stable descending sort (``torch.topk`` promises no tie order).  Integer
keys are never cast to a float.

Byte prefixes are accumulated in **float64** and compared against the
f32 thresholds widened to double.  Page sizes are whole byte counts, so
every partial sum is exact in double and independent of the order it is
taken in: the CUDA kernels (which sum in page-index order) and these
functions (which sum in service order) agree bit for bit, and both agree
with an f32 prefix sum wherever that one is itself exact.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _service_order(key: torch.Tensor):
    """Stable descending sort along the page axis: equal keys keep
    ascending page index."""
    return torch.sort(key, dim=1, descending=True, stable=True)


def _lane_sizes(sizes: torch.Tensor, L: int) -> torch.Tensor:
    """``sizes`` may be one ``(P,)`` row shared by every lane."""
    return sizes.unsqueeze(0).expand(L, -1) if sizes.dim() == 1 else sizes


def batched_evict_ref(
    key: torch.Tensor,        # (L, P) f32 or i32 priority (higher = first)
    sizes: torch.Tensor,      # (L, P) or (P,) f32 page bytes
    evictable: torch.Tensor,  # (L, P) bool
    need_free: torch.Tensor,  # (L,) f32 bytes that must be freed
    *,
    vmax: int = 64,
) -> torch.Tensor:
    """Evict mask per lane: evictable pages in service order, among the
    ``vmax`` highest-priority ones, while the bytes freed *before* the
    page are below ``need_free`` (and ``need_free > 0``)."""
    L, P = key.shape
    sizes = _lane_sizes(sizes, L)
    if key.dtype.is_floating_point:
        low = float("-inf")
    else:
        low = torch.iinfo(key.dtype).min   # the dtype's own minimum
    masked = torch.where(evictable, key, torch.full_like(key, low))
    _, order = _service_order(masked)
    cand = order[:, : min(vmax, P)]
    c_ok = evictable.gather(1, cand)
    sz_c = torch.where(c_ok, sizes.gather(1, cand), 0.0).double()
    before = torch.cumsum(sz_c, dim=1) - sz_c
    need = need_free.unsqueeze(1)
    take = c_ok & (before < need.double()) & (need > 0)
    return torch.zeros_like(evictable).scatter_(1, cand, take)


def fifo_grant_ref(
    key: torch.Tensor,      # (L, P) i32 queue priority (-1 = not wanted)
    sizes: torch.Tensor,    # (L, P) or (P,) f32 page bytes
    budget: torch.Tensor,   # (L,) f32 byte budget of this grant
    pops: torch.Tensor,     # (L,) i32 max queue pops
    *,
    vmax: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Budgeted FIFO grant with strict head-of-line admission: the first
    entry that does not fit ``budget``, lies beyond ``min(pops, vmax)``
    or is not wanted blocks everything behind it.  Returns
    ``(mask (L, P) bool, granted_bytes (L,) f32, n_granted (L,) i32)``."""
    L, P = key.shape
    sizes = _lane_sizes(sizes, L)
    kv, order = _service_order(key)
    k = min(vmax, P)
    kv, cand = kv[:, :k], order[:, :k]
    sz = sizes.gather(1, cand).double()
    csum = torch.cumsum(sz, dim=1)
    pos = torch.arange(k, device=key.device)
    ok = torch.cumprod(
        ((kv >= 0) & (csum <= budget.double().unsqueeze(1))
         & (pos.unsqueeze(0) < pops.unsqueeze(1))).to(torch.int32),
        dim=1,
    ).bool()
    mask = torch.zeros(L, P, dtype=torch.bool, device=key.device)
    mask.scatter_(1, cand, ok)
    granted = torch.where(ok, sz, 0.0).sum(dim=1).float()
    return mask, granted, ok.sum(dim=1).to(torch.int32)


def wake_solve_ref(
    key: torch.Tensor,      # (L, P) i32 queue priority (-1 = not wanted)
    sizes: torch.Tensor,    # (L, P) or (P,) f32 page bytes
    credit0: torch.Tensor,  # (L,) f32 io-credit already banked
    inc: torch.Tensor,      # (L,) f32 credit bytes gained per fine step
    pops: torch.Tensor,     # (L,) i32 max queue pops per fine step
    *,
    h_cap: int = 64,
) -> torch.Tensor:
    """Grant step of every queued page of the frozen serial I/O server.

    Each fine step banks ``inc`` more bytes and pops at most ``pops``
    heads whose prefix-inclusive bytes fit the credit, so the grant count
    follows ``n_k = min(cnt_k, n_{k-1} + pops)`` with ``cnt_k`` the
    entries whose prefix fits ``credit0 + k*inc`` (a rounded f32 multiply,
    then a rounded f32 add).  A page at service rank ``r`` is granted at
    the first ``k`` with ``n_k >= r + 1``.  Returns ``(L, P)`` i32 in
    ``1..h_cap``; not wanted or not granted by then: ``h_cap + 1``.
    (``max(k_bytes, ceil(rank / pops))`` is NOT this function: steps
    starved of bytes waste their pops instead of banking them.)"""
    L, P = key.shape
    dev = key.device
    sizes = _lane_sizes(sizes, L)
    kv, order = _service_order(key)
    w_ord = kv >= 0
    sz = torch.where(w_ord, sizes.gather(1, order), 0.0).double()
    csum = torch.cumsum(sz, dim=1)
    ks = torch.arange(1, h_cap + 1, device=dev)
    thr = credit0.unsqueeze(1) + ks.float().unsqueeze(0) * inc.unsqueeze(1)
    cnt = (
        w_ord.unsqueeze(1)
        & (csum.unsqueeze(1) <= thr.double().unsqueeze(2))
    ).sum(dim=2)                                          # (L, h_cap) i64
    popl = pops.clamp(min=0).long()
    gap = ks.unsqueeze(1) - ks.unsqueeze(0)               # (k, j) -> k - j
    big = torch.iinfo(torch.int64).max
    ramp = torch.where(
        (gap >= 0).unsqueeze(0),
        cnt.unsqueeze(1) + gap.unsqueeze(0) * popl.view(L, 1, 1),
        big,
    )
    n_k = torch.minimum(ramp.amin(dim=2), ks.unsqueeze(0) * popl.unsqueeze(1))
    rank = torch.arange(P, device=dev)
    step = 1 + (n_k.unsqueeze(1) < (rank.view(1, P, 1) + 1)).sum(dim=2)
    step = torch.where(w_ord, step, h_cap + 1).to(torch.int32)
    return torch.zeros(L, P, dtype=torch.int32, device=dev).scatter_(
        1, order, step)


NEG_INF = -1e30


def paged_attention_ref(
    q: torch.Tensor,            # (B, H, dh) f32 or bf16
    k_pages: torch.Tensor,      # (n_pages, page_size, Hk, dh), q's dtype
    v_pages: torch.Tensor,      # (n_pages, page_size, Hk, dh), q's dtype
    page_table: torch.Tensor,   # (B, pages_per_seq) i32 pool page ids
    seq_lens: torch.Tensor,     # (B,) i32
) -> torch.Tensor:
    """One decode step of GQA attention through a page table: the plain
    version of ``repro.kernels.ref.paged_attention_ref``.

    Gathers every page of the table, f32 einsum, scale ``dh**-0.5`` after
    the dot, positions ``>= seq_len`` masked to ``-1e30``, softmax, output
    cast to ``q.dtype``.  Query head ``h`` reads KV head ``h // G`` with
    ``G = H // Hk``.  A sequence of length 0 has every score at ``-1e30``,
    so its softmax is uniform and the output is the mean of the table's V
    rows (the oracle's answer; the Pallas body returns 0 there)."""
    b, h, dh = q.shape
    _, page_size, hk, _ = k_pages.shape
    g = h // hk
    pages = page_table.shape[1]
    idx = page_table.long()
    k_seq = k_pages[idx].reshape(b, pages * page_size, hk, dh)
    v_seq = v_pages[idx].reshape(b, pages * page_size, hk, dh)
    qf = q.reshape(b, hk, g, dh).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k_seq.float()) * (dh ** -0.5)
    pos = torch.arange(pages * page_size, device=q.device)
    valid = pos.unsqueeze(0) < seq_lens.unsqueeze(1)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_seq.float())
    return out.reshape(b, h, dh).to(q.dtype)
