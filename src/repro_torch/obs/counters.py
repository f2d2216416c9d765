"""Carried in-step counters: the :class:`Telemetry` tuple of the port.

Counterpart of the JAX package's ``repro.obs.counters``.  Telemetry is
data: fixed-shape integer counters threaded through the simulator's step
like any other carry leaf (``make_runner(telemetry=True)``), updated from
values the step computes anyway, and summarised on the host only after
the run.  With the knob off the step never builds the tuple and runs not
one operator more (bit-equal results, ``tests/test_torch_obs.py``).

The port keeps the lane axis explicit, so every counter is lane-major:

===============  ==========================================================
``hits``         ``(L,)`` i32 plan-trigger crossings of *resident* pages
                 (cooperative lanes: chunk pages consumed)
``misses``       ``(L,)`` i32 demand grants (loads that un-blocked a scan)
``loads``        ``(L,)`` i32 every I/O grant (demand + readahead)
``evictions``    ``(L,)`` i32 pages evicted by the batched eviction kernel
``evict_rank``   ``(L, N_BINS)`` i32 log2 histogram of each victim's rank
                 in the policy's score order (rank 0 = the policy's top
                 victim; mass in high bins = deep thrash)
``jump_hist``    ``(L, N_BINS)`` i32 log2 histogram of the macro-step
                 length in fine steps (all in bin 0 under ``fixed``)
``ioq_depth_*``  ``(L,)`` i32 pending request-queue depth, summed over
                 steps / peak
``chunk_picks``  ``(L,)`` i32 cooperative chunk selections
``pol_obs``      per compiled policy, an ``(L, n)`` f32 row its
                 ``observe`` hook accumulates (``(L, 0)`` for a policy
                 without one); lanes of another policy add zeros
===============  ==========================================================

Every histogram is an integer ``scatter_add_`` along the bin axis, so no
result depends on the order a device adds in.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

#: log2 histogram bins: bin b counts values in [2**b, 2**(b+1)), the last
#: bin absorbs the tail.  8 bins cover ranks / jumps up to 128+.
N_BINS = 8

_I32 = torch.int32


class Telemetry(NamedTuple):
    """Lane-major counters carried through the step (see the module
    docstring for each field)."""

    hits: torch.Tensor
    misses: torch.Tensor
    loads: torch.Tensor
    evictions: torch.Tensor
    evict_rank: torch.Tensor
    jump_hist: torch.Tensor
    ioq_depth_sum: torch.Tensor
    ioq_depth_max: torch.Tensor
    chunk_picks: torch.Tensor
    pol_obs: Tuple = ()


def count(c: torch.Tensor, event: torch.Tensor) -> torch.Tensor:
    """Add ``event`` — an ``(L, ...)`` mask or count, or an ``(L,)`` flag —
    summed per lane, into the ``(L,)`` counter ``c`` (in ``c``'s dtype)."""
    if event.dim() > 1:
        event = event.sum(dim=tuple(range(1, event.dim())), dtype=c.dtype)
    return c + event.to(c.dtype)


def hist(h: torch.Tensor, bins: torch.Tensor, weights) -> torch.Tensor:
    """Scatter-add ``weights`` into the ``(L, N)`` histogram ``h`` at
    ``bins`` (``(L, ...)`` indices; ``weights`` of the same shape, or a
    Python number for every entry)."""
    L = h.shape[0]
    idx = bins.reshape(L, -1)
    if torch.is_tensor(weights):
        w = weights.reshape(L, -1).to(h.dtype)
    else:
        w = torch.full(idx.shape, weights, dtype=h.dtype, device=h.device)
    return h.scatter_add(1, idx, w)


def log2_bin(x: torch.Tensor, n_bins: int = N_BINS) -> torch.Tensor:
    """Map values to log2 bins: 1 -> 0, 2-3 -> 1, 4-7 -> 2, ..., clipped
    to ``[0, n_bins)`` (zero and negative values land in bin 0).

    The bin is the bit length of ``max(x, 1)`` less one, counted as the
    powers of two 2, 4, ..., 2**(n_bins - 1) that ``x`` reaches: exact
    integer comparisons, where a ``log2`` of a float may differ between
    devices in the last place.  Returns int64 (an index)."""
    dtype = x.dtype if x.dtype.is_floating_point else torch.int64
    return (x.unsqueeze(-1) >= _pows(n_bins, dtype, x.device)).sum(dim=-1)


@functools.lru_cache(maxsize=None)
def _pows(n_bins: int, dtype, device) -> torch.Tensor:
    """2, 4, ..., 2**(n_bins - 1) on ``device``, made once."""
    return torch.tensor([1 << b for b in range(1, n_bins)], dtype=dtype,
                        device=device)


# analysis: host -- the zeroed counters, made once before the loop
def init_telemetry(policies, spec, lanes: int, device) -> Telemetry:
    """Zeroed :class:`Telemetry` for ``lanes`` lanes of a compiled policy
    set.  A policy opts into a row through ``observe_init`` (``None`` = no
    row: an ``(L, 0)`` placeholder keeps the tuple's structure)."""
    rows = []
    for p in policies:
        proto = p.observe_init(spec, lanes, device)
        rows.append(torch.zeros((lanes, 0), dtype=torch.float32,
                                device=device)
                    if proto is None else torch.zeros_like(proto))
    z = torch.zeros(lanes, dtype=_I32, device=device)
    zh = torch.zeros((lanes, N_BINS), dtype=_I32, device=device)
    return Telemetry(
        hits=z, misses=z, loads=z, evictions=z,
        evict_rank=zh, jump_hist=zh,
        ioq_depth_sum=z, ioq_depth_max=z, chunk_picks=z,
        pol_obs=tuple(rows),
    )


# analysis: host -- one lane's counters, after the run
def lane_slice(tele: Telemetry, i: int) -> Telemetry:
    """Lane ``i`` of a lane-major :class:`Telemetry`."""
    return Telemetry(*(x[i] for x in tele[:-1]),
                     pol_obs=tuple(r[i] for r in tele.pol_obs))


# analysis: host -- the host digest of a finished run
def summarize(tele: Telemetry, policies=None, steps=None) -> dict:
    """Host-side digest of ONE lane's telemetry (:func:`lane_slice`) — the
    dict stamped into ``ArrayResult.extras['telemetry']``; the same keys,
    values and rounding as the JAX package's."""
    hits = int(tele.hits)
    misses = int(tele.misses)
    out = {
        "hits": hits,
        "misses": misses,
        "loads": int(tele.loads),
        "evictions": int(tele.evictions),
        "hit_rate": round(hits / max(1, hits + misses), 4),
        "evict_rank_hist": tele.evict_rank.tolist(),
        "jump_hist": tele.jump_hist.tolist(),
        "ioq_depth_max": int(tele.ioq_depth_max),
        "chunk_picks": int(tele.chunk_picks),
    }
    if steps is not None and int(steps) > 0:
        out["ioq_depth_mean"] = round(
            int(tele.ioq_depth_sum) / int(steps), 2)
    if policies is not None:
        pol = {}
        for p, row in zip(policies, tele.pol_obs):
            name = p if isinstance(p, str) else p.name
            arr = row.detach().cpu().numpy()
            if arr.size and np.any(arr):   # other lanes' rows stay zero
                pol[name] = [round(float(v), 2) for v in arr.tolist()]
        if pol:
            out["policy_obs"] = pol
    return out
