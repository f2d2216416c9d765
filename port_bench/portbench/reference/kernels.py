"""B1-B3, the buffer pool's three kernels, in plain PyTorch: the eviction
select (B1), the budgeted FIFO grant (B2) and the serial server's wake
solve (B3), over a leading lane axis ``L``.

A frozen copy of ``batched_evict_ref``, ``fifo_grant_ref`` and
``wake_solve_ref`` of ``src/repro_torch/kernels/ref.py`` at commit
7b98c78, the plain versions the program's CUDA kernels are held to.

Order is always **(key descending, page index ascending)**, taken from a
stable descending sort.  Integer keys are never cast to a float.  Byte
prefixes are accumulated in **float64** and compared against the f32
thresholds widened to double: page sizes are whole byte counts, so every
partial sum is exact in double and independent of the order it is taken
in.
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





def _evict_keys(key: torch.Tensor, evictable: torch.Tensor) -> torch.Tensor:
    """``key`` with the pages that cannot be evicted at the key type's
    minimum (-inf for f32), a float -0.0 read as +0.0."""
    if key.dtype.is_floating_point:
        return torch.where(evictable, key + 0.0,
                           torch.full_like(key, float("-inf")))
    return torch.where(evictable, key,
                       torch.full_like(key, torch.iinfo(key.dtype).min))


def batched_evict(
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



def fifo_grant(
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


def wake_solve(
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


