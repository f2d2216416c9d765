"""The ``ArrayPolicy`` surface: buffer policies as tensor functions.

Counterpart of the JAX package's ``repro.core.array_sim.policies``.  The
batched step (``array_sim.sim.make_step``) hardcodes no policy: it drives
a tuple of :class:`ArrayPolicy` objects — private state plus tensor hooks
— and dispatches eviction on the score arrays they provide.  Every tensor
carries a leading **lane axis** ``L`` (one lane = one point of a sweep);
a lane selects its policy by indexing the stacked per-policy arrays with
its config id, so a whole (policy x buffer) grid runs as one batched
call.

The protocol:

* :meth:`ArrayPolicy.init_state` — the policy's private state for a
  workload (``()`` for stateless policies), with the lane axis;
* :meth:`ArrayPolicy.on_request` / :meth:`ArrayPolicy.on_consume` —
  advance that state from the step's observation window
  (:class:`StepCtx`);
* :meth:`ArrayPolicy.score_victims` — the policy itself: an ``(L, P)``
  f32 eviction priority (higher = evicted first) consumed by
  ``repro_torch.kernels.ops.batched_evict``;
* :meth:`ArrayPolicy.scan_horizon` — per stream, the seconds until the
  policy's own state next needs attention (``None``: no own clock);
* static knobs: ``request_window``, ``fifo_tie``, ``cooperative``.

The numeric cores the policies are built from live here too:
:func:`time_to_bucket` (paper Fig. 10), :func:`next_consumption`
(paper Fig. 9), :func:`target_buckets`, :func:`shift_timeline`.
The telemetry hooks (``observe*``) arrive with the telemetry slice.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch

# "no interest" sentinel: a finite big value, not inf
BIG = 1e30
BIG_CUT = 1e29

_U32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _const(value, dtype, device) -> torch.Tensor:
    """A 0-d constant on ``device``, made once: a Python scalar handed to
    ``torch.where`` costs a fill kernel on every call."""
    return torch.full((), value, dtype=dtype, device=device)


def time_to_bucket(eta, time_slice, n_groups: int, m: int):
    """Vectorised TimeToBucketNumber: bucket index for each eta (seconds).

    Group ``g`` covers slice offsets ``[m*(2^g - 1), m*(2^(g+1) - 1))``
    with bucket width ``2^g`` slices.  ``eta=inf`` maps to the last
    bucket (callers decide not-requested separately).
    """
    nb = n_groups * m
    s = torch.clamp(eta, min=0.0) / time_slice
    g = torch.floor(torch.log2(s / m + 1.0)).clamp(0, n_groups - 1)
    g = g.to(torch.int32)
    glen = torch.bitwise_left_shift(torch.ones_like(g), g)
    start = m * (glen - 1)
    # clamped in float: a float beyond the integer range has no defined
    # conversion, and everything past nb lands in the last bucket anyway
    idx = torch.floor((s - start.float()) / glen.float()).clamp(max=1e9)
    b = torch.clamp(g * m + idx.to(torch.int32), 0, nb - 1)   # i32
    return torch.where(eta <= 0.0, _const(0, torch.int32, b.device), b)


def next_consumption(page_first, page_last, page_col, cols_cur, cur_abs,
                     scan_end, speed, active, scan_start=None, eps=None):
    """``PageNextConsumption`` over a page array: min over streams of the
    estimated seconds until the page's consumption, :data:`BIG` where no
    registered scan wants the page.

    Page arrays are ``(N,)`` (one row shared by the lanes) or ``(L, N)``;
    stream arrays are ``(L, S)``, ``cols_cur`` is ``(L, S, C)``; the
    result is ``(L, N)``.  Consumption is **plan-trigger granular**: a
    page is consumed the instant the scan cursor crosses its trigger
    ``max(page_first, scan_start)``, and from then on the scan no longer
    registers interest.  ``eps`` absorbs f32 cursor rounding.
    ``scan_start=None`` keeps the page-overlap interest
    (``page_last > cur``), the registration-time view.

    One ``(L, S, N)`` broadcast and a min over streams (the minimum is
    exact, so the order of the reduction does not matter).
    """
    L, S = cur_abs.shape
    if page_col.dim() == 1:
        colmask = cols_cur[:, :, page_col]                    # (L, S, N)
        pf, pl = page_first.view(1, 1, -1), page_last.view(1, 1, -1)
    else:
        colmask = cols_cur.gather(
            2, page_col.unsqueeze(1).expand(L, S, page_col.shape[1]))
        pf, pl = page_first.unsqueeze(1), page_last.unsqueeze(1)
    cur = cur_abs.unsqueeze(2)
    if scan_start is None:
        trigger = pf
        pending = pl > cur
    else:
        st = scan_start.unsqueeze(2)
        trigger = torch.maximum(pf, st)
        tol = 0.0 if eps is None else eps.unsqueeze(2)
        pending = (trigger >= cur - tol) & (pl > st)
    interest = (
        colmask & pending & (pf < scan_end.unsqueeze(2))
        & active.unsqueeze(2)
    )
    e = torch.clamp(trigger - cur, min=0.0) / torch.clamp(
        speed, min=1e-6).unsqueeze(2)
    return torch.where(interest, e, _const(BIG, e.dtype, e.device)).amin(dim=1)


def target_buckets(eta, time_slice, n_groups: int, m: int, page_valid=None):
    """Bucket every page would get if pushed now: ``time_to_bucket`` for
    requested pages, the not-requested sentinel (== nb) otherwise.
    ``page_valid=None`` means every page is valid."""
    nb = n_groups * m
    requested = eta < BIG_CUT
    if page_valid is not None:
        requested = requested & page_valid
    b = time_to_bucket(
        torch.where(requested, eta, _const(0.0, eta.dtype, eta.device)),
        time_slice, n_groups, m)
    return torch.where(requested, b, _const(nb, torch.int32, eta.device))


def shift_timeline(bucket, b_target, slices_done, k, *, nb: int, m: int,
                   k_max: Optional[int] = None):
    """``RefreshRequestedBuckets`` (paper Fig. 9/10): advance the bucketed
    timeline by ``k`` slices.  Per elapsed slice, bucket ``b`` (length
    ``2**(b//m)`` slices) moves left when the slice counter divides its
    length; a page shifted past position 0 is *spilled* and re-bucketed at
    ``b_target``.

    ``k`` is a Python int (every lane shifts ``k`` times) or an ``(L,)``
    tensor of per-lane counts: the loop then runs to the static
    ``k_max`` and a lane takes part in its first ``k`` rounds only."""
    per_lane = torch.is_tensor(k)
    if per_lane and k_max is None:
        raise ValueError("shift_timeline: a per-lane k needs the static k_max")
    sd = slices_done.unsqueeze(1)
    b = bucket
    for i in range(k_max if per_lane else max(int(k), 0)):
        tp = sd + (i + 1)
        blen = torch.bitwise_left_shift(
            torch.ones_like(b), torch.clamp(b, 0, nb - 1) // m)
        moved = (b >= 0) & (b < nb) & ((tp % blen) == 0)
        b2 = torch.where(moved, b - 1, b)
        b2 = torch.where(b2 < 0, b_target, b2)
        b = torch.where((k > i).unsqueeze(1), b2, b) if per_lane else b2
    return b


class StepCtx:
    """Observation window one simulation step hands to the policy hooks.

    Built fresh inside the step (never carried), after the CPU advance
    and the I/O grant phase, so hooks see this step's loads and trigger
    crossings plus the post-advance scan view.  The consumption estimates
    are memoised per step: however many policies ask for
    :meth:`eta_estimate`, it is computed once, and a step without a
    PBM-like policy never computes it.

    ``refresh`` is a static Python bool: the cheap within-slice step and
    the once-per-``time_slice`` boundary step are two functions, like the
    paper's PBM cadence.  Page arrays are ``(L, P)`` unless marked
    shared, stream arrays ``(L, S)``, scalars ``(L,)``.
    """

    def __init__(self, *, spec, refresh: bool, time_slice, now, steps,
                 dt, page_first, page_last, page_col, page_valid, resident,
                 last_used, load_mask, cross_pidx, crossed, active, cols,
                 cur, end, start, eps, rate, speed_push,
                 slices_done=None, slices_elapsed=None, slices_max=None,
                 upd_pages=None, upd_on=None):
        self.spec = spec
        self.refresh = refresh
        self.time_slice = time_slice
        self.now = now                  # (L,) sim clock at the end of the step
        self.steps = steps
        self.slices_done = slices_done  # (L,) PBM slices elapsed (pre-step)
        self.slices_elapsed = slices_elapsed
        # ^ (L,) slices THIS refresh step stands in for (None == 1)
        self.slices_max = slices_max    # static bound of slices_elapsed
        self.dt = dt                    # (L,) step length
        self.page_first = page_first    # (P,) shared
        self.page_last = page_last      # (P,) shared
        self.page_col = page_col        # (P,) shared, i64
        self.page_valid = page_valid    # (P,) shared
        self.resident = resident        # pre-eviction residency
        self.last_used = last_used      # post-touch LRU clock
        self.load_mask = load_mask      # granted loads this step
        self.cross_pidx = cross_pidx    # (L, S, C, W) windowed page ids
        self.crossed = crossed          # (L, S, C, W) triggers crossed
        self.upd_pages = upd_pages      # (L, U) i64 compacted update set
        self.upd_on = upd_on            # (L, U) bool
        self.active = active            # post-advance view ------------
        self.cols = cols                # (L, S, C) bool
        self.cur = cur
        self.end = end
        self.start = start
        self.eps = eps
        self.rate = rate                # true current query rate
        self.speed_push = speed_push    # estimator with the engine's dips
        self._eta_estimate = None
        self._eta_exact = None

    def eta_estimate(self):
        """PBM's estimated next consumption per page, from the per-slice
        speed estimator.  Memoised per step."""
        if self._eta_estimate is None:
            self._eta_estimate = next_consumption(
                self.page_first, self.page_last, self.page_col,
                self.cols, self.cur, self.end, self.speed_push,
                self.active, scan_start=self.start, eps=self.eps,
            )
        return self._eta_estimate

    def eta_estimate_at(self, pages):
        """:meth:`eta_estimate` for an ``(L, U)`` page-id subset (the
        within-slice update set)."""
        return next_consumption(
            self.page_first[pages], self.page_last[pages],
            self.page_col[pages], self.cols, self.cur, self.end,
            self.speed_push, self.active, scan_start=self.start,
            eps=self.eps,
        )

    def eta_exact(self):
        """OPT's oracle: exact next-consumption distances from the true
        CPU rates of the current queries.  Memoised per step."""
        if self._eta_exact is None:
            self._eta_exact = next_consumption(
                self.page_first, self.page_last, self.page_col,
                self.cols, self.cur, self.end, self.rate,
                self.active, scan_start=self.start, eps=self.eps,
            )
        return self._eta_exact


class HorizonView:
    """What the event-horizon stepper hands to
    :meth:`ArrayPolicy.scan_horizon`: the post-advance per-stream scan
    view plus the fine step length."""

    def __init__(self, *, spec, active, start, end, rate, dt_ref):
        self.spec = spec
        self.active = active
        self.start = start
        self.end = end
        self.rate = rate
        self.dt_ref = dt_ref


class ArrayPolicy:
    """Base protocol: a buffer policy as private state + tensor hooks.
    The defaults are a stateless policy that only scores victims."""

    #: registry name (also the event-engine counterpart's name)
    name: str = "?"
    #: the policy schedules loads itself (ABM) through the cooperative
    #: substrate — not ported yet
    cooperative: bool = False
    #: request-cohort service order: "stream" = per-stream blocks,
    #: "plan" = plan-deterministic page order
    fifo_tie: str = "stream"

    def request_window(self, spec, prefetch_pages: int) -> int:
        """Plan-entry readahead width for this policy (static)."""
        return prefetch_pages

    def init_state(self, spec, lanes: int, device) -> Any:
        """Policy-private state for a workload (device tensors, lane axis
        first)."""
        return ()

    def on_request(self, pstate, ctx: StepCtx):
        return pstate

    def on_consume(self, pstate, ctx: StepCtx):
        return pstate

    def score_victims(self, pstate, ctx: StepCtx) -> torch.Tensor:
        """``(L, P)`` f32 eviction priority, higher = evicted first."""
        raise NotImplementedError

    def scan_horizon(self, pstate, hz: HorizonView):
        """``(L, S)`` seconds until this policy's state next needs a step,
        or ``None`` for no policy-specific constraint."""
        return None

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}({self.name})"


def _lru_age(ctx: StepCtx) -> torch.Tensor:
    return torch.clamp(ctx.now.unsqueeze(1) - ctx.last_used, min=0.0)


class ArrayLRU(ArrayPolicy):
    """Least-recently-used: score = age of the last consumption touch."""

    name = "lru"
    fifo_tie = "stream"

    def request_window(self, spec, prefetch_pages: int) -> int:
        # calibrated against the event engine: its 8-entry window
        # underfeeds the array LRU at single-table deep thrash; on
        # multi-table workloads the engine's own width tracks
        return prefetch_pages + 2 if spec.n_tables == 1 else prefetch_pages

    def score_victims(self, pstate, ctx: StepCtx) -> torch.Tensor:
        return _lru_age(ctx)


def pbm_tie_hash(now: torch.Tensor, n_pages: int) -> torch.Tensor:
    """PBM's per-(page, call) tie value in [0, 1): a Knuth multiplicative
    hash of the page index against the bits of ``now + 1`` (f32), top 24
    bits scaled.  uint32 wrap-around arithmetic, done in int64 and masked.
    ``now`` is ``(L,)``; the result ``(L, P)``."""
    seed = (now.float() + 1.0).view(torch.int32).long() & _U32
    idx = torch.arange(n_pages, device=now.device, dtype=torch.int64)
    h32 = (idx.unsqueeze(0) * 2654435761 + seed.unsqueeze(1) * 40503) & _U32
    return (h32 >> 8).float() * 2.0 ** -24


class ArrayPBM(ArrayPolicy):
    """Predictive Buffer Manager: the paper's bucketed consumption
    timeline as policy state (one ``(L, P)`` bucket array).

    Within a slice the timeline is static except for pages whose estimate
    just changed (this step's loads and crossed triggers); at the slice
    boundary every page's next consumption is recomputed,
    no-longer-requested pages demote, and the timeline shifts with spill
    re-bucketing."""

    name = "pbm"
    fifo_tie = "plan"

    def init_state(self, spec, lanes: int, device):
        return torch.full((lanes, spec.n_pages), spec.not_requested,
                          dtype=torch.int32, device=device)

    def on_consume(self, bucket, ctx: StepCtx):
        spec = ctx.spec
        NR = spec.not_requested
        m = spec.buckets_per_group
        if ctx.refresh:
            eta = ctx.eta_estimate()
            b_target = target_buckets(eta, ctx.time_slice, spec.n_groups,
                                      m, ctx.page_valid)
            interested = (eta < BIG_CUT) & ctx.page_valid
            assign = (
                ctx.load_mask | ((bucket == NR) & interested)
                | (b_target == 0)
            )
            bucket_pre = torch.where(
                interested, torch.where(assign, b_target, bucket),
                _const(NR, torch.int32, bucket.device))
            k = 1 if ctx.slices_elapsed is None else ctx.slices_elapsed
            return shift_timeline(bucket_pre, b_target, ctx.slices_done,
                                  k, nb=spec.nb, m=m, k_max=ctx.slices_max)
        # within a slice: one gather/scatter over the compacted update
        # set.  Combining (min) scatter with an NR+1 sentinel for off
        # entries: duplicate ON entries of one page carry identical b_u,
        # so the result does not depend on the order of the scatter.
        upd, upd_on = ctx.upd_pages, ctx.upd_on
        eta_u = ctx.eta_estimate_at(upd)
        b_u = target_buckets(eta_u, ctx.time_slice, spec.n_groups, m)
        off = _const(NR + 1, torch.int32, bucket.device)
        new_b = torch.full_like(bucket, NR + 1).scatter_reduce_(
            1, upd, torch.where(upd_on, b_u, off), "amin",
            include_self=True)
        return torch.where(new_b <= NR, new_b, bucket)

    def score_victims(self, bucket, ctx: StepCtx) -> torch.Tensor:
        # composite key: bucket level dominates; not-requested (== nb) is
        # the top level with LRU order inside; requested buckets break
        # ties by a per-(page, call) hash (a FIXED index order would carve
        # a stable always-kept elite out of every bucket)
        nb = ctx.spec.nb
        age = _lru_age(ctx)
        tie = pbm_tie_hash(ctx.now, bucket.shape[1])
        tb = torch.where(bucket == nb, age / (age + 1.0), tie)
        return bucket.float() + 0.5 * tb


class ArrayOPT(ArrayPolicy):
    """OPT / Belady on exact plan distances (paper §3, §4).

    The scan plans are static and in-order, so every page's exact next
    consumption is one :func:`next_consumption` over the TRUE current
    query rates.  Unreferenced pages go first in LRU order, then
    referenced pages by furthest exact next use.  The score array is
    recomputed once per PBM slice and held stale in between (the policy
    state is the cached f32 key): the event oracle ranks victims from
    burst-quantised scan positions, and freezing the ranking on the slice
    cadence reproduces its churn channel."""

    name = "opt"
    fifo_tie = "stream"

    def init_state(self, spec, lanes: int, device):
        return torch.zeros((lanes, spec.n_pages), dtype=torch.float32,
                           device=device)

    def on_consume(self, key, ctx: StepCtx):
        if not ctx.refresh:
            return key
        eta = ctx.eta_exact()
        age = _lru_age(ctx)
        # bands: referenced pages map to [0, 1) monotone in eta,
        # unreferenced to [2, 3) in LRU order
        return torch.where(
            eta >= BIG_CUT, 2.0 + age / (age + 1.0), eta / (eta + 1.0))

    def score_victims(self, key, ctx: StepCtx) -> torch.Tensor:
        return key
