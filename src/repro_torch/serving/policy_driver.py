"""Serving-side policy driver: the policy registry on the decode path.

The port's own copy of ``repro.serving.policy_driver`` (pure Python):
the same bucket geometry, keys and tie-breaks, so a run under the port's
engine takes the same decisions as one under the JAX package's.

This is where the reproduction's policy API leaves the simulator and lands
in the inference stack (DESIGN.md §2).  The continuous-batching scheduler
*is* the paper's "known future": its own queue discloses exactly which
request decodes next, which resumes when, and how long every page stays in
the access sequence.  The driver translates that schedule into the same
policy surface the simulator already uses — one name table
(``repro_torch.core.policy_registry``), four paper policies:

* ``lru``   — preempt the least-recently-decoded request (classic baseline);
* ``pbm``   — the paper's time-of-next-consumption estimate: each request's
  remaining tokens over the *measured* decode rate, quantised into the
  PBM priority-bucket geometry (paper Fig. 10) — victims come from the
  furthest bucket, LRU inside a bucket;
* ``cscan`` — CScan-style relevance: prefix-shared refcounted pages are the
  paper's shared chunks (many consumers still want them — spilling their
  owner frees nothing and loses sharing), so the victim is the request
  whose footprint is most *exclusive* per freed slot;
* ``opt``   — exact Belady distances from ``Request.remaining``: the
  scheduler is the oracle, so the paper's "unattainable" OPT is attainable.

Per-page next-access estimates (:meth:`DecodeSchedule.page_horizons`):
while a request is scheduled, paged attention re-reads its whole page
table every decode step — the next access of every resident page is the
very next step.  What differentiates victims is the **occupancy horizon**:
how long a page stays in the future access sequence, which is its owner's
remaining decode work (estimated for PBM, exact for OPT) and, for shared
prefix pages, the *furthest* of the sharers' horizons.

The driver also owns the prefetch half — the push-based prepare-ahead
design of the zicIO / shared-IO line (PAPERS.md arXiv 1905.07113): while
the batch is full, the next resume candidate's host pages are staged back
into free HBM *before* a batch slot opens, so its swap-in delay is paid in
the shadow of other requests' decode steps.  Which request resumes next is
itself a policy decision (:meth:`ServingPolicy.resume_key`): LRU keeps
FIFO arrival order; PBM/OPT resume the request with the nearest
(estimated/exact) completion first — the known future says it frees the
pool soonest; CScan resumes the request with the most shared pages first
(highest keep-relevance per slot).
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

if TYPE_CHECKING:  # pragma: no cover - type-only, avoids an import cycle
    from .engine import Request
    from .kv_cache import PagePool

__all__ = [
    "DecodeSchedule", "PolicyDriver", "ServingPolicy",
    "ServingCScan", "ServingLRU", "ServingOPT", "ServingPBM",
    "pbm_bucket",
]

#: PBM bucket geometry on the serving path: ``slice`` is the serving
#: analogue of the simulator's time slice, measured in engine steps.
SLICE_STEPS = 4.0
N_GROUPS = 10
BUCKETS_PER_GROUP = 2


def pbm_bucket(eta_steps: float, slice_steps: float = SLICE_STEPS,
               n_groups: int = N_GROUPS,
               m: int = BUCKETS_PER_GROUP) -> int:
    """The paper's ``TimeToBucketNumber`` (Fig. 10) for one scalar eta:
    group ``g`` covers slice offsets ``[m*(2^g - 1), m*(2^(g+1) - 1))``
    with bucket width ``2^g`` slices — log-spaced lookahead, exactly the
    geometry the simulator's vectorised ``time_to_bucket`` implements."""
    s = max(eta_steps, 0.0) / slice_steps
    g = int(math.floor(math.log2(s / m + 1.0)))
    g = min(max(g, 0), n_groups - 1)
    start = m * ((1 << g) - 1)
    width = 1 << g
    idx = int((s - start) // width)
    return min(max(g * m + idx, 0), n_groups * m - 1)


class DecodeSchedule:
    """One step's view of the engine's own future.

    Built by the driver from live engine state (never carried): the active
    batch, the swapped queue, the measured decode rate, and the page pool's
    refcounts.  Policies read the future through this object only."""

    def __init__(self, *, step: int, rate: float,
                 active: Sequence["Request"], swapped: Sequence["Request"],
                 pool: "PagePool"):
        self.step = step
        self.rate = max(rate, 1e-6)    # measured tokens/step/request
        self.active = active
        self.swapped = swapped
        self.pool = pool

    # ------------------------------------------------- request horizons --
    def remaining_tokens(self, req: "Request") -> int:
        """Exact Belady distance: the scheduler's own plan says precisely
        how many decode steps this request's pages stay in the access
        sequence (``max_new_tokens`` is the serving contract)."""
        return req.remaining

    def eta_steps(self, req: "Request") -> float:
        """PBM's estimate of the same horizon: remaining tokens over the
        *measured* decode rate (the serving analogue of the simulator's
        per-slice speed estimator)."""
        return req.remaining / self.rate

    # ---------------------------------------------------- page estimates --
    def sharers(self, pid: int) -> int:
        """Refcount of a page — how many requests' page tables hold it.
        Shared prompt-prefix pages are the paper's shared chunks."""
        m = self.pool.meta.get(pid)
        return 0 if m is None else m.ref_count

    def page_horizons(self, exact: bool = False) -> Dict[int, float]:
        """Per-page occupancy horizon over every scheduled request's pages:
        steps until the page leaves the future access sequence.  A shared
        page inherits the furthest sharer's horizon (some consumer still
        reads it until then)."""
        out: Dict[int, float] = {}
        for req in self.active:
            if req.kv is None:
                continue
            h = float(self.remaining_tokens(req)) if exact \
                else self.eta_steps(req)
            for pid in req.kv.pages:
                out[pid] = max(out.get(pid, 0.0), h)
        return out


class ServingPolicy:
    """One buffer policy on the serving path.

    ``victim_key`` orders preemption (higher = preempt first) among the
    engine's candidates; ``resume_key`` orders swap-in (lower = resume
    first) over the swapped queue.  Keys may be tuples (lexicographic).
    """

    name: str = "?"

    def victim_key(self, req: "Request", sched: DecodeSchedule):
        raise NotImplementedError

    def resume_key(self, req: "Request", sched: DecodeSchedule):
        return (req.arrival_step, req.rid)          # FIFO

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}({self.name})"


class ServingLRU(ServingPolicy):
    """Classic baseline: preempt the least-recently-decoded request, resume
    in arrival order.  Under continuous batching every active request
    decodes every step, so "least recent" degenerates to "longest in the
    batch" — usually the request *closest* to completion, which must then
    resume almost immediately: the ping-pong the predictive policies
    avoid."""

    name = "lru"

    def victim_key(self, req, sched):
        return (sched.step - req.last_decode_step, -req.rid)


class ServingPBM(ServingPolicy):
    """Predictive Buffer Manager: remaining tokens over the measured decode
    rate, pushed through the paper's priority-bucket geometry.  Victims
    come from the furthest bucket (LRU order inside a bucket — the
    bucketed timeline blurs priorities only within one bucket, exactly
    like the simulator); resumes take the nearest-completion bucket
    first."""

    name = "pbm"

    def victim_key(self, req, sched):
        return (pbm_bucket(sched.eta_steps(req)),
                sched.step - req.last_decode_step, -req.rid)

    def resume_key(self, req, sched):
        return (pbm_bucket(sched.eta_steps(req)), req.arrival_step, req.rid)


class ServingCScan(ServingPolicy):
    """CScan-style relevance over prefix-shared refcounted pages.

    KeepRelevance maps to refcounts: a shared prefix page is a chunk many
    consumers still want — ``PagePool.swap_out`` keeps it resident anyway,
    so preempting its owner frees nothing for it and costs a preemption.
    The victim is the request that frees the most *exclusive* slots per
    unit of lost relevance (most exclusive pages first, fewest shared
    pages as the penalty), ties broken toward the furthest completion;
    resumes take the most-shared request first (highest keep-relevance
    per occupied slot)."""

    name = "cscan"

    @staticmethod
    def _split(req, sched):
        pages = req.kv.pages if req.kv is not None else []
        shared = sum(1 for p in pages if sched.sharers(p) > 1)
        return len(pages) - shared, shared

    def victim_key(self, req, sched):
        exclusive, shared = self._split(req, sched)
        return (exclusive - shared, sched.remaining_tokens(req), -req.rid)

    def resume_key(self, req, sched):
        exclusive, shared = self._split(req, sched)
        return (-shared, req.arrival_step, req.rid)


class ServingOPT(ServingPolicy):
    """Belady, attainable: the decode schedule is the oracle.  Preempt the
    request whose pages stay in the access sequence longest (exact
    remaining tokens); resume the one that completes soonest."""

    name = "opt"

    def victim_key(self, req, sched):
        return (sched.remaining_tokens(req), -req.rid)

    def resume_key(self, req, sched):
        return (sched.remaining_tokens(req), req.arrival_step, req.rid)


class PolicyDriver:
    """Glue between the engine and a registry :class:`ServingPolicy`:
    builds the :class:`DecodeSchedule` view each step and answers the
    three questions the engine asks — whom to preempt, whom to resume
    next, and whether to prepare the next resume ahead of need."""

    def __init__(self, policy: ServingPolicy):
        self.policy = policy

    def view(self, engine) -> DecodeSchedule:
        return DecodeSchedule(
            step=engine.stats.steps, rate=engine._decode_rate,
            active=engine.active, swapped=engine.swapped, pool=engine.pool,
        )

    def choose_victim(self, candidates: Sequence["Request"],
                      sched: DecodeSchedule) -> Optional["Request"]:
        if not candidates:
            return None
        return max(candidates,
                   key=lambda r: self.policy.victim_key(r, sched))

    def next_resume(self, sched: DecodeSchedule) -> Optional["Request"]:
        if not sched.swapped:
            return None
        return min(sched.swapped,
                   key=lambda r: self.policy.resume_key(r, sched))

    def resume_order(self, sched: DecodeSchedule) -> List["Request"]:
        """The full swapped queue in the policy's resume order — the
        engine walks it when the preferred candidate does not fit the
        free pool (forward-progress fallback)."""
        return sorted(sched.swapped,
                      key=lambda r: self.policy.resume_key(r, sched))
