"""Plain PyTorch versions of the port's kernels.

Each function defines the semantics of one kernel: the three buffer-pool
kernels of ``csrc/pbm_timeline.cu`` over a leading lane axis ``L`` (one
lane = one point of a sweep), paged decode attention
(``csrc/paged_attention.cu``, :func:`paged_attention_ref`), and the three
kernels of the model stack's prefill: flash attention
(:func:`flash_attention_ref`), the chunked Mamba2 scan
(:func:`mamba2_scan_ref`) and the chunked mLSTM (:func:`mlstm_chunked_ref`).
They are what runs for CPU tensors, and what the CUDA kernels are held to
on the card.  The model-stack versions follow the JAX models' own chunked
formulations (``blocked_attention``, ``ssd_chunked``, ``gla_chunked``), so
the port's CPU model equals the JAX model to f32 rounding and their memory
stays bounded at long sequences.

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

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


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
    _, order = _service_order(_evict_keys(key, evictable))
    return _evict_head(order[:, : min(vmax, key.shape[1])], sizes, evictable,
                       need_free)


def _evict_head(cand, sizes, evictable, need_free) -> torch.Tensor:
    """The evict rule on the head ``cand`` ``(L, m)`` of the service
    order: evictable pages while the bytes freed before them (f64) are
    below ``need_free``."""
    sizes = _lane_sizes(sizes, cand.shape[0])
    c_ok = evictable.gather(1, cand)
    sz_c = torch.where(c_ok, sizes.gather(1, cand), 0.0).double()
    before = torch.cumsum(sz_c, dim=1, dtype=torch.float64) - sz_c
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
    kv, order = _service_order(key)
    k = min(vmax, key.shape[1])
    return _grant_head(kv[:, :k], order[:, :k], key.shape[1], sizes, budget,
                       pops)


def _grant_head(kv, cand, P: int, sizes, budget, pops):
    """The grant rule on the head of the service order, keys ``kv`` at
    pages ``cand`` ``(L, k)``: strict head-of-line admission (f64 byte
    prefix) -> ``(mask (L, P), granted_bytes, n_granted)``."""
    L, k = cand.shape
    sz = _lane_sizes(sizes, L).gather(1, cand).double()
    csum = torch.cumsum(sz, dim=1, dtype=torch.float64)
    pos = torch.arange(k, device=cand.device)
    ok = torch.cumprod(
        ((kv >= 0) & (csum <= budget.double().unsqueeze(1))
         & (pos.unsqueeze(0) < pops.unsqueeze(1))).to(torch.int32),
        dim=1,
    ).bool()
    mask = torch.zeros(L, P, dtype=torch.bool, device=cand.device)
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
    csum = torch.cumsum(sz, dim=1, dtype=torch.float64)
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


# ------------------------------------------- page-split candidate selection

def page_shard_candidates(key: torch.Tensor, n: int, head: int) -> torch.Tensor:
    """Global indices ``(L, n * m)`` of each of ``n`` page shards' first
    ``m = min(head, P / n)`` pages in service order (its own stable sort,
    key descending, index ascending), gathered and sorted by ascending
    global index: the plain version of the JAX package's
    ``_page_shard_candidates``.  A page among the lane's first ``head`` is
    among its own shard's first ``head``, so the candidates hold the
    lane's head, and a stable sort of their keys in index order gives its
    service order.  ``n`` must divide P."""
    L, P = key.shape
    if P % n:
        raise ValueError(
            f"page axis has {n} shards which do not divide the padded pool "
            f"size P={P}")
    p_loc = P // n
    m = min(int(head), p_loc)
    _, order = _service_order(key.reshape(L * n, p_loc))
    base = torch.arange(0, P, p_loc, device=key.device).repeat(L)
    cand = (order[:, :m] + base[:, None]).reshape(L, n * m)
    return torch.sort(cand, dim=1).values


def _split_head(key: torch.Tensor, n: int, head: int):
    """The first ``min(head, P)`` of each lane's service order, taken from
    the shards' candidates: ``(keys, global indices)``."""
    cand = page_shard_candidates(key, n, head)
    kv, pos = _service_order(key.gather(1, cand))
    take = min(int(head), key.shape[1])
    return kv[:, :take], cand.gather(1, pos[:, :take])


def _evict_keys(key: torch.Tensor, evictable: torch.Tensor) -> torch.Tensor:
    """``key`` with the pages that cannot be evicted at the key type's
    minimum (-inf for f32), a float -0.0 read as +0.0."""
    if key.dtype.is_floating_point:
        return torch.where(evictable, key + 0.0,
                           torch.full_like(key, float("-inf")))
    return torch.where(evictable, key,
                       torch.full_like(key, torch.iinfo(key.dtype).min))


def evict_page_sharded(key, sizes, evictable, need_free, n: int, *,
                       vmax: int = 64) -> torch.Tensor:
    """:func:`batched_evict_ref` from ``n`` page shards' candidates (the
    JAX package's ``_evict_page_sharded``): the same mask."""
    _, top = _split_head(_evict_keys(key, evictable), n, vmax)
    return _evict_head(top, sizes, evictable, need_free)


def grant_page_sharded(key, sizes, budget, pops, n: int, *,
                       vmax: int = 16):
    """:func:`fifo_grant_ref` from ``n`` page shards' candidates (the JAX
    package's ``_grant_page_sharded``): the same mask, bytes and count."""
    kv, top = _split_head(key, n, vmax)
    return _grant_head(kv, top, key.shape[1], sizes, budget, pops)


def page_rank_candidates(key: torch.Tensor, group, head: int) -> torch.Tensor:
    """:func:`page_shard_candidates` with each of ``group``'s n ranks
    taking one shard: this rank selects its own ``P / n`` slice's first
    ``min(head, P / n)`` pages (global indices), the ranks all-gather
    them, and every rank gets the same ``(L, n * m)`` candidates sorted by
    ascending global index.  ``key`` is the replicated row, as every rank
    of a page row holds it."""
    from .collective import all_gather, size_rank
    L, P = key.shape
    n, rank = size_rank(group)
    if P % n:
        raise ValueError(
            f"page axis has {n} shards which do not divide the padded pool "
            f"size P={P}")
    p_loc = P // n
    m = min(int(head), p_loc)
    start = rank * p_loc
    _, order = _service_order(key[:, start:start + p_loc])
    every = all_gather(order[:, :m] + start, group)          # (n, L, m)
    return torch.sort(every.permute(1, 0, 2).reshape(L, n * m), dim=1).values


def _rank_head(key: torch.Tensor, group, head: int):
    """:func:`_split_head` from the ranks' candidates."""
    cand = page_rank_candidates(key, group, head)
    kv, pos = _service_order(key.gather(1, cand))
    take = min(int(head), key.shape[1])
    return kv[:, :take], cand.gather(1, pos[:, :take])


def evict_rank_sharded(key, sizes, evictable, need_free, group, *,
                       vmax: int = 64) -> torch.Tensor:
    """:func:`batched_evict_ref` with the candidates selected across the
    ranks of a page ``group`` (the JAX package's ``_evict_page_sharded``
    under a ``shard_map``): the same mask on every rank."""
    _, top = _rank_head(_evict_keys(key, evictable), group, vmax)
    return _evict_head(top, sizes, evictable, need_free)


def grant_rank_sharded(key, sizes, budget, pops, group, *, vmax: int = 16):
    """:func:`fifo_grant_ref` with the candidates selected across the
    ranks of a page ``group`` (``_grant_page_sharded``): the same mask,
    bytes and count on every rank."""
    kv, top = _rank_head(key, group, vmax)
    return _grant_head(kv, top, key.shape[1], sizes, budget, pops)


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


def paged_attention_split_ref(
    q: torch.Tensor,            # (B, H, dh) f32 or bf16
    k_pages: torch.Tensor,      # (n_pages, page_size, Hk, dh), q's dtype
    v_pages: torch.Tensor,      # (n_pages, page_size, Hk, dh), q's dtype
    page_table: torch.Tensor,   # (B, pages_per_seq) i32 pool page ids
    seq_lens: torch.Tensor,     # (B,) i32
    pages_per_split: int,
    partials: bool = False,
):
    """:func:`paged_attention_ref` in the split-then-combine formulation of
    the CUDA kernel (``csrc/paged_attention.cu``), for tests only.

    Split ``k`` covers table pages ``[k * pages_per_split, ...)`` and reads
    only those that hold a position ``< seq_len`` (every page for
    ``seq_len <= 0``).  It reports its running max ``m``, denominator
    ``l`` and unnormalised numerator ``acc`` in f32; a split with no page
    to read reports ``m = -inf``, ``l = 0``, ``acc = 0``.  The combine takes
    ``M = max m``, weights ``exp(m - M)`` and divides by
    ``max(sum weight * l, 1e-30)``.  Returns the output in ``q.dtype``, and
    with ``partials`` also ``(m, l, acc)`` of shapes ``(B, Hk, G, n)``,
    ``(B, Hk, G, n)``, ``(B, Hk, G, n, dh)``."""
    b, h, dh = q.shape
    _, ps, hk, _ = k_pages.shape
    g = h // hk
    pps = page_table.shape[1]
    sl = seq_lens.long()
    n_read = torch.where(sl > 0, ((sl + ps - 1) // ps).clamp(max=pps),
                         torch.full_like(sl, pps))
    qf = q.reshape(b, hk, g, dh).float()
    ms, ls, accs = [], [], []
    for p0 in range(0, pps, pages_per_split):
        p1 = min(p0 + pages_per_split, pps)
        n = (p1 - p0) * ps
        idx = page_table[:, p0:p1].long()
        kk = k_pages[idx].reshape(b, n, hk, dh).float()
        vv = v_pages[idx].reshape(b, n, hk, dh).float()
        scores = torch.einsum("bkgd,bskd->bkgs", qf, kk) * (dh ** -0.5)
        pos = p0 * ps + torch.arange(n, device=q.device)
        scores = torch.where((pos[None, :] < seq_lens[:, None])[:, None, None],
                             scores, torch.full_like(scores, NEG_INF))
        read = (torch.arange(p0, p1, device=q.device)[None, :]
                < n_read[:, None]).repeat_interleave(ps, dim=1)   # (B, n)
        scores = torch.where(read[:, None, None, :], scores,
                             torch.full_like(scores, float("-inf")))
        m = scores.amax(dim=-1)                    # -inf: nothing read
        p = torch.exp(scores - m.clamp(min=NEG_INF)[..., None])
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p, vv))
        ms.append(m)
    m, l, acc = (torch.stack(ms, dim=-1), torch.stack(ls, dim=-1),
                 torch.stack(accs, dim=-2))
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))     # split 0 is finite
    out = (w[..., None] * acc).sum(dim=-2) \
        / (w * l).sum(dim=-1).clamp(min=1e-30)[..., None]
    out = out.reshape(b, h, dh).to(q.dtype)
    return (out, (m, l, acc)) if partials else out


# ------------------------------------------------- model-stack prefill ----

def flash_attention_ref(
    q: torch.Tensor,            # (B, T, H, dh) f32 or bf16
    k: torch.Tensor,            # (B, S, Hk, dh), q's dtype; GQA, not expanded
    v: torch.Tensor,            # (B, S, Hk, dh)
    causal: bool = True,
    window: Optional[int] = None,
    offset: Optional[int] = None,
    block: int = 512,
) -> torch.Tensor:
    """Causal / sliding-window / full attention, the plain version of
    ``repro.kernels.ref.flash_attention_ref`` in the formulation of the JAX
    model's ``blocked_attention``: query blocks of ``block`` rows, each
    against the whole K, f32 scores scaled by ``dh**-0.5`` after the dot,
    masked positions at ``-1e30``, softmax, f32 values, output in
    ``q.dtype``.

    Query ``t`` and key ``s`` are ``rel = t - s + offset`` apart; causal
    keeps ``rel >= 0`` and a window ``rel < window``.  ``offset`` defaults
    to ``S - T`` (the oracle's alignment of the last query with the last
    key); ``blocked_attention`` passes its ``q_offset``.  A row with every
    position masked gets a uniform softmax over the S keys, the mean of V
    (the oracle's answer; the Pallas body returns 0 there).  Head ``h``
    reads KV head ``h // (H // Hk)``, as ``jnp.repeat`` expands it."""
    b, t, h, dh = q.shape
    s, hk = k.shape[1], k.shape[2]
    g = h // hk
    off = s - t if offset is None else offset
    kf = k.float().permute(0, 2, 3, 1)               # (B, Hk, dh, S)
    vf = v.float().permute(0, 2, 1, 3)               # (B, Hk, S, dh)
    kpos = torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    for t0 in range(0, t, block):
        n = min(block, t - t0)
        qi = q[:, t0:t0 + n].float().reshape(b, n, hk, g, dh)
        qi = qi.permute(0, 2, 3, 1, 4).reshape(b, hk, g * n, dh)
        scores = (qi @ kf).view(b, hk, g, n, s) * (dh ** -0.5)
        rel = (torch.arange(t0, t0 + n, device=q.device)[:, None]
               - kpos[None, :] + off)
        mask = torch.ones_like(rel, dtype=torch.bool)
        if causal:
            mask &= rel >= 0
        if window is not None:
            mask &= rel < window
        scores = scores.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(scores, dim=-1).view(b, hk, g * n, s)
        o = (probs @ vf).view(b, hk, g, n, dh).permute(0, 3, 1, 2, 4)
        out[:, t0:t0 + n] = o.reshape(b, n, h, dh).to(q.dtype)
    return out


def _chunks(x: torch.Tensor, chunk: int, value: float = 0.0) -> torch.Tensor:
    """``(B, T, ...)`` -> ``(B, nc, chunk, ...)`` in f32, T padded at the
    end with ``value``."""
    B, T = x.shape[:2]
    nc = max(1, -(-T // chunk))
    pad = nc * chunk - T
    if pad:
        x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad), value=value)
    return x.reshape(B, nc, chunk, *x.shape[2:]).float()


def _decays(a_: torch.Tensor):
    """Per chunk, from the decays ``a_`` ``(B, nc, Q, H)``: the cumulative
    log decay, ``L[q, s] = exp(cum_q - cum_s)`` for ``q >= s`` and 0 above
    the diagonal (masked before the ``exp``, where the exponent is
    positive), and the chunk's total log decay ``(B, nc, 1, H)``."""
    Q = a_.shape[2]
    cum = torch.cumsum(torch.log(torch.clamp(a_, min=1e-20)), dim=2)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,Q,S,H)
    below = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a_.device))
    L = torch.exp(li.masked_fill(~below[None, None, :, :, None],
                                 float("-inf")))
    return cum, L, cum[:, :, -1:, :]


def ssd_chunked(
    xh: torch.Tensor,   # (B, T, H, P)  inputs per head
    a: torch.Tensor,    # (B, T, H)     per-step decay in (0, 1]
    b: torch.Tensor,    # (B, T, N)     input projection (shared groups)
    c: torch.Tensor,    # (B, T, N)     output projection
    chunk: int = 256,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: ``y_t = C_t . h_t``, ``h_t = a_t h_{t-1} + B_t x_t^T``
    (``repro.models.ssm.ssd_chunked``).  Returns ``(y, h_final)``, y
    ``(B, T, H, P)`` in ``xh.dtype``, h ``(B, H, P, N)`` f32.  A ragged T
    is padded with ``a = 1`` and zeros."""
    B, T, H, P = xh.shape
    N = b.shape[-1]
    xh_, a_ = _chunks(xh, chunk), _chunks(a, chunk, 1.0)
    b_, c_ = _chunks(b, chunk), _chunks(c, chunk)
    nc = xh_.shape[1]
    cum, L, total = _decays(a_)
    cb = c_ @ b_.transpose(-1, -2)                           # (B,nc,Q,S)
    y = torch.einsum("bnqsh,bnshp->bnqhp", cb[..., None] * L, xh_)
    dte = torch.exp(total - cum)                             # (B,nc,Q,H)
    chunk_state = torch.einsum("bnshp,bnsk->bnhpk", xh_ * dte[..., None], b_)
    chunk_decay = torch.exp(total[:, :, 0, :])               # (B,nc,H)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    h_prev = []
    for n in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, n, :, None, None] + chunk_state[:, n]
    h_prev = torch.stack(h_prev, dim=1)                      # (B,nc,H,P,N)
    y = y + torch.einsum("bnqk,bnhpk->bnqhp", c_, h_prev) \
        * torch.exp(cum)[..., None]
    return y.reshape(B, nc * chunk, H, P)[:, :T].to(xh.dtype), h


def mamba2_scan_ref(xh, a, b, c) -> torch.Tensor:
    """The chunked SSD scan's output ``y`` (``repro.kernels.ref.
    mamba2_scan_ref``'s, computed as the model computes it)."""
    return ssd_chunked(xh, a, b, c)[0]


def gla_chunked(
    q: torch.Tensor,    # (B, T, H, K)
    k: torch.Tensor,    # (B, T, H, K)
    v: torch.Tensor,    # (B, T, H, P)
    a: torch.Tensor,    # (B, T, H) per-step decay in (0, 1]
    i: torch.Tensor,    # (B, T, H) input-gate scale
    chunk: int = 256,
    c0: Optional[torch.Tensor] = None,
    n0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked mLSTM / gated linear attention,
    ``y_t = (q_t . C_t) / max(|q_t . n_t|, 1)``, ``C_t = a_t C + i_t k_t
    v_t^T``, ``n_t = a_t n + i_t k_t``, q scaled by ``K**-0.5``
    (``repro.models.xlstm.gla_chunked``).  Returns ``(y, C_final
    (B, H, K, P), n_final (B, H, K))``; a ragged T is padded with ``a = 1``,
    ``i = 0`` and zeros."""
    T, P = q.shape[1], v.shape[-1]
    y, nrm, C, nv = _gla_parts(q, k, v, a, i, chunk, c0, n0)
    y = y / torch.clamp(nrm.abs(), min=1.0)[..., None]
    B, nc = y.shape[:2]
    return y.reshape(B, nc * chunk, q.shape[2], P)[:, :T].to(v.dtype), C, nv


def _gla_parts(q, k, v, a, i, chunk, c0=None, n0=None):
    """:func:`gla_chunked` before its division, by chunk: the numerator
    ``(B, nc, chunk, H, P)`` and the normaliser ``(B, nc, chunk, H)`` in f32,
    and the final C and n."""
    B, T, H, K = q.shape
    P = v.shape[-1]
    qc = _chunks(q, chunk) * (K ** -0.5)
    kc, vc = _chunks(k, chunk), _chunks(v, chunk)
    ac, ic = _chunks(a, chunk, 1.0), _chunks(i, chunk)
    nc = qc.shape[1]
    cum, L, total = _decays(ac)
    qk = torch.einsum("bnchk,bnshk->bncsh", qc, kc)
    w = qk * L * ic[:, :, None, :, :]                        # gated scores
    y = torch.einsum("bncsh,bnshp->bnchp", w, vc)
    nrm = w.sum(dim=3)                                       # (B,nc,Q,H)
    dte = torch.exp(total - cum) * ic                        # (B,nc,Q,H)
    kw = kc * dte[..., None]
    chunk_state = torch.einsum("bnshk,bnshp->bnhkp", kw, vc)
    chunk_norm = kw.sum(dim=2)                               # (B,nc,H,K)
    chunk_decay = torch.exp(total[:, :, 0, :])               # (B,nc,H)
    C = (torch.zeros((B, H, K, P), dtype=torch.float32, device=q.device)
         if c0 is None else c0.float())
    nv = (torch.zeros((B, H, K), dtype=torch.float32, device=q.device)
          if n0 is None else n0.float())
    C_prev, n_prev = [], []
    for n in range(nc):
        C_prev.append(C)
        n_prev.append(nv)
        C = C * chunk_decay[:, n, :, None, None] + chunk_state[:, n]
        nv = nv * chunk_decay[:, n, :, None] + chunk_norm[:, n]
    dstart = torch.exp(cum)                                  # (B,nc,Q,H)
    y = y + torch.einsum("bnchk,bnhkp->bnchp", qc,
                         torch.stack(C_prev, dim=1)) * dstart[..., None]
    nrm = nrm + torch.einsum("bnchk,bnhk->bnch", qc,
                             torch.stack(n_prev, dim=1)) * dstart
    return y, nrm, C, nv


def mlstm_chunked_ref(q, k, v, a, i) -> torch.Tensor:
    """The chunked mLSTM's output ``y`` (the oracle is
    ``repro.kernels.ref.gla_ref``; computed as the model computes it)."""
    return gla_chunked(q, k, v, a, i)[0]
