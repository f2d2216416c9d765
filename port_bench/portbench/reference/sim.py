"""The plain reference's machine: the horizon stepper of the batched
simulator of concurrent scans over a buffer pool, in plain PyTorch.

A frozen copy of ``src/repro_torch/core/array_sim/sim.py`` at commit
7b98c78 (the state, the configs and ``make_step``'s horizon macro-step),
cut to what the benchmark's cells run: the horizon stepper with
``wake_exact``, no telemetry, no sanitizer, no page split and no mesh.
B1-B3 are their plain PyTorch versions (:mod:`.kernels`), never the
card's kernels, and :func:`run` is the loop nest written out eagerly: no
CUDA graph is captured.  The benchmark holds each lane of the program's
runner to this machine, run on the same scans, pools and prefix; so a
later change to the program that changes what a sweep computes shows as
a gap, whatever device or kernel it runs on.

The machine, as the program states it: per-page state (residency, LRU
clock, FIFO request stamp) and per-stream state (query index, cursor,
speed estimate) as dense tensors with a leading lane axis; scans that
consume tuples with per-page plan-trigger semantics; a
bandwidth-budgeted serial I/O server popping a stamp-FIFO request queue;
eviction dispatched on the score arrays the policies provide; the PBM
timeline refreshed once per ``time_slice``; array-CScan's chunk-granular
ABM substrate (:mod:`.coop`) blended per lane by the lane's policy id.
Each macro-step jumps to the next event (wake-exact jumps at
supersaturated points).  Sums over the pool are taken in float64 and
rounded once to f32, so they do not depend on a device's reduction order.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import coop as coop_mod
from .kernels import batched_evict, fifo_grant, wake_solve
from .policies import (BIG_CUT, ArrayCScan, ArrayLRU, ArrayOPT, ArrayPBM,
                       ArrayPolicy, HorizonView, StepCtx)
from .spec import SimSpec, spec_to_torch

#: the policies' stable array ids (the program's registry at commit 7b98c78)
POLICY_IDS = {"lru": 0, "pbm": 1, "cscan": 2, "opt": 3}
_POLICY_CLASSES = {"lru": ArrayLRU, "pbm": ArrayPBM, "cscan": ArrayCScan,
                   "opt": ArrayOPT}


def resolve_policies(names: Sequence[str]) -> Tuple[ArrayPolicy, ...]:
    """The policy objects of a lane set, at most one cooperative."""
    out = tuple(_POLICY_CLASSES[n]() for n in names)
    if sum(p.cooperative for p in out) > 1:
        raise ValueError("at most one cooperative policy per step")
    return out


_REQ_NONE = 1 << 24   # FIFO stamp sentinel: page not currently requested
_JIT_STEPS = 6        # LRU-clock jitter amplitude in step-lengths
_LOAD_MAX = 6         # load grants per fine step (credit caps at ~5 pages)
_PROG_MIN = 1.0       # tuples: a slice with less progress skips the EWMA
_BURST_W = 0.75       # burst-report weight in the speed estimate
_RATE_JIT = 0.08      # per-(stream, query) CPU pacing skew amplitude
_GATE_P = 0.105       # blocked-scan window-refresh rate per fine step
_DIP_P = 0.31         # fraction of fine steps a stream's push speed dips
_DIP_DEPTH = 0.8      # dip floor as a fraction of the effective rate
_SEG_PAGES = 2.0      # plan entries pinned per running burst
_SEG_WIN = 2          # static back-window (pages/column) the pin scan walks
_MAX_ABSORB = 3       # whole slices a wake-exact refresh step may absorb
_UPD_CAP = 512        # within-slice update set handed to the policies

_U32 = 0xFFFFFFFF
_INF = float("inf")


class ArraySimConfig(NamedTuple):
    """Runtime knobs of one lane; a batch of configs (one per sweep
    point) is stacked leaf-wise into ``(L,)`` tensors."""

    capacity_bytes: torch.Tensor   # f32 buffer-pool capacity
    bandwidth: torch.Tensor        # f32 bytes/sec of the I/O server
    policy: torch.Tensor           # i32 registry array id
    max_time: torch.Tensor         # f32 livelock guard


class SimState(NamedTuple):
    # ---- per-page (L, P) -------------------------------------------------
    resident: torch.Tensor       # bool
    last_used: torch.Tensor      # f32 LRU clock
    req_step: torch.Tensor       # i32 FIFO stamp: step the page was first wanted
    req_tie: torch.Tensor        # i32 within-cohort service rank fixed at stamp
    fresh: torch.Tensor          # bool: loaded but not consumed since (churn)
    # ---- per-stream (L, S) -----------------------------------------------
    qidx: torch.Tensor           # i64 current query (== n_q when stream done)
    pos: torch.Tensor            # f32 tuples consumed within current query
    speed: torch.Tensor          # f32 EWMA tuples/sec (effective, stalls incl.)
    consumed: torch.Tensor       # f32 lifetime tuples consumed (speed input)
    consumed_ref: torch.Tensor   # f32 `consumed` at the last slice boundary
    stream_done_t: torch.Tensor  # f32 finish time, -1 while running
    # ---- per-lane scalars (L,) -------------------------------------------
    t: torch.Tensor              # f32 sim clock
    steps: torch.Tensor          # i32 macro-steps executed
    slices_done: torch.Tensor    # i32 PBM slices elapsed (the livelock guard)
    io_credit: torch.Tensor      # f32 banked I/O bytes
    io_bytes: torch.Tensor       # f32 lifetime loaded bytes (paper I/O volume)
    loads: torch.Tensor          # i32 lifetime page loads
    loads_demand: torch.Tensor   # i32 loads granted for a blocking frontier
    churn: torch.Tensor          # i32 loads evicted before any consumption
    # ---- policy-private state (one entry per compiled ArrayPolicy) -------
    pstate: Tuple = ()


class _View(NamedTuple):
    """Derived per-stream view of the current query + per-column cursors,
    carried alongside :class:`SimState` (this step's post-advance view is
    the next step's pre-advance view).  The *frontier* of a column is its
    first page whose trigger (``max(page_first, scan_start)``) the scan
    cursor has not crossed yet; ``ftrig`` is the absolute tuple position
    at which the column next needs a page resident."""

    active: torch.Tensor    # (L, S) bool
    length: torch.Tensor    # (L, S) f32
    rate: torch.Tensor      # (L, S) f32
    cols: torch.Tensor      # (L, S, C) bool
    start: torch.Tensor     # (L, S) f32 absolute scan start
    cur: torch.Tensor       # (L, S) f32 absolute cursor
    end: torch.Tensor       # (L, S) f32 absolute scan end
    eps: torch.Tensor       # (L, S) f32 cursor tolerance
    frontier: torch.Tensor  # (L, S, C) i64 local index of next unconsumed page
    fpidx: torch.Tensor     # (L, S, C) i64 global page id of the frontier
    ftrig: torch.Tensor     # (L, S, C) f32 per-column trigger cursor
    fneed: torch.Tensor     # (L, S, C) bool frontier exists inside the range


def _u01(idx_mul: torch.Tensor, t: torch.Tensor, t_mult: int) -> torch.Tensor:
    """Deterministic per-(index, time) uniform draw in [0, 1): Knuth
    multiplicative hash of an index against a time-like salt, top 24 bits
    scaled.  The reference computes it in wrap-around uint32; here the
    products are taken in int64 and masked to 32 bits.  ``idx_mul`` is the
    index already multiplied by its constant (int64, see :func:`_idx_mul`);
    ``t`` broadcasts against it."""
    h = (idx_mul + t.long() * t_mult) & _U32
    return (h >> 8).float() * 2.0 ** -24


def _idx_mul(n: int, device, idx_mult: int = 2654435761) -> torch.Tensor:
    return torch.arange(n, device=device, dtype=torch.int64) * idx_mult


def make_config(spec: SimSpec, capacity_bytes: float, bandwidth: float,
                policy: str, max_time: float, device) -> ArraySimConfig:
    """One lane's config (0-d tensors on ``device``)."""
    dev = torch.device(device)
    return ArraySimConfig(
        capacity_bytes=torch.tensor(capacity_bytes, dtype=torch.float32,
                                    device=dev),
        bandwidth=torch.tensor(bandwidth, dtype=torch.float32, device=dev),
        policy=torch.tensor(POLICY_IDS[policy], dtype=torch.int32, device=dev),
        max_time=torch.tensor(max_time, dtype=torch.float32, device=dev),
    )


def stack_configs(cfgs: Sequence[ArraySimConfig]) -> ArraySimConfig:
    """Stack N configs leaf-wise into one ``(L,)`` batched config."""
    return ArraySimConfig(*(torch.stack(xs) for xs in zip(*cfgs)))


def _lanes(cfg: ArraySimConfig) -> ArraySimConfig:
    """A config with the lane axis (a single 0-d config becomes L = 1)."""
    if cfg.policy.dim() == 0:
        return ArraySimConfig(*(x.unsqueeze(0) for x in cfg))
    return cfg


def init_state(spec: SimSpec, policies: Sequence[ArrayPolicy],
               lanes: int, device) -> SimState:
    dev = torch.device(device)
    L, P, S = lanes, spec.n_pages, spec.n_streams
    f32, i32 = torch.float32, torch.int32

    def full(shape, val, dtype):
        return torch.full(shape, val, dtype=dtype, device=dev)

    n_q = torch.as_tensor(spec.n_q, device=dev)
    return SimState(
        resident=full((L, P), False, torch.bool),
        last_used=full((L, P), -1e9, f32),
        req_step=full((L, P), _REQ_NONE, i32),
        req_tie=full((L, P), 0, i32),
        fresh=full((L, P), False, torch.bool),
        qidx=full((L, S), 0, torch.int64),
        pos=full((L, S), 0.0, f32),
        speed=torch.as_tensor(spec.q_rate[:, 0], dtype=f32,
                              device=dev).expand(L, S).clone(),
        consumed=full((L, S), 0.0, f32),
        consumed_ref=full((L, S), 0.0, f32),
        stream_done_t=torch.where(n_q > 0, -1.0, 0.0).to(f32)
        .expand(L, S).clone(),
        t=full((L,), 0.0, f32),
        steps=full((L,), 0, i32),
        slices_done=full((L,), 0, i32),
        io_credit=full((L,), 0.0, f32),
        io_bytes=full((L,), 0.0, f32),
        loads=full((L,), 0, i32),
        loads_demand=full((L,), 0, i32),
        churn=full((L,), 0, i32),
        pstate=tuple(p.init_state(spec, L, dev) for p in policies),
    )


def _evict_candidates(spec: SimSpec) -> int:
    """Eviction-candidate window (``vmax``) of the eviction kernel: the
    top-k priority pages considered per call must cover a whole amortised
    batch (16 pages) of *maximum-size* pages even when the priority order
    is led by small column-tail / dimension-table pages.  64 is the
    single-table floor; capped at 256."""
    sizes = spec.page_size[spec.page_valid]
    if sizes.size == 0:
        return 64
    med = float(np.median(sizes))
    need = int(np.ceil(16 * float(np.max(sizes)) / max(med, 1.0))) + 16
    return int(min(256, max(64, need)))


def _freeze(mask: torch.Tensor, new, old):
    """Per-lane select over a carry: lanes where ``mask`` is False keep
    ``old``.  Walks tuples (NamedTuples included) down to the tensors."""
    if torch.is_tensor(new):
        return torch.where(mask.view((-1,) + (1,) * (new.dim() - 1)),
                           new, old)
    kids = [_freeze(mask, n, o) for n, o in zip(new, old)]
    return type(new)(*kids) if hasattr(new, "_fields") else tuple(kids)


class _LaneConsts(NamedTuple):
    """Per-lane values that depend on the config alone (constant over a
    run): computed once by ``step.lane_consts(cfg)``."""

    ok_id: torch.Tensor      # (L,) bool: policy id is in the compiled set
    pol_local: torch.Tensor  # (L,) i64 index into the compiled policy tuple
    is_coop: torch.Tensor    # (L,) bool: the lane runs the cooperative model
    sat: torch.Tensor        # (L,) bool: supersaturated lane
    k_win: torch.Tensor      # (L, 1, 1, 1) i64 readahead width
    plan_tie: torch.Tensor   # (L, 1) bool: plan-order cohort ties
    dt_bad: torch.Tensor     # (L,) f32 step length of an invalid lane
    batch: torch.Tensor      # (L,) f32 amortised eviction batch bytes
    inc_ref: torch.Tensor    # (L,) f32 credit bytes per fine step
    pops_wake: torch.Tensor  # (L,) i32 pops per fine step (wake solve)
    pop_cap: torch.Tensor    # (L,) i32 most pops one macro-step may take
    h_cap: torch.Tensor      # (L,) f32 longest jump the lane may plan


def make_step(spec: SimSpec, dt: float, time_slice: float,
              prefetch_pages: int, refresh: bool, policies: Sequence[str],
              device, h_max: float = 8.0, h_io: float = 3.0):
    """Build ``step(carry, cfg, live=None, lc=None) -> carry`` of the
    horizon stepper with ``wake_exact``, for a policy set, over a lane
    axis.

    ``refresh=False`` is the cheap within-slice macro-step; ``refresh=True``
    is the once-per-``time_slice`` boundary step (PBM recomputes every
    page's next consumption and shifts its timeline there, OPT re-scores,
    and the step drops dead request-queue entries).  A lane's
    ``cfg.policy`` selects between the policy-provided score / readahead /
    tie arrays; with a cooperative policy among them the step also runs
    the chunk-granular substrate and blends per lane between the in-order
    and cooperative models.

    The carry is ``(state, view, win, adv_lim, pend, rem, next_h)``: each
    step closes by computing the NEXT step's event horizon (the earliest
    interesting time over the trigger-arrival / chunk-completion /
    io-credit / completion candidates) together with the trigger window
    of the post-advance view.  ``rem`` is the whole-fine-step budget left
    in the current PBM slice; the cheap step jumps ``min(next_h, rem -
    1)`` fine steps and the refresh step absorbs the final jump.  ``h_io``
    bounds the jump, in fine steps, while requests are pending and the
    lane is not supersaturated; a supersaturated lane jumps to the exact
    serial-server wake (B3), the refresh step absorbing up to
    ``_MAX_ABSORB`` whole slices.

    ``live`` is an ``(L,)`` bool mask: lanes where it is False come back
    unchanged (``None`` = every lane steps).  ``lc`` is the cached
    ``step.lane_consts(cfg)``.
    """
    dev = torch.device(device)
    policies = resolve_policies(policies)
    P, S, Q, C = spec.n_pages, spec.n_streams, spec.n_queries, spec.n_cols
    vmax = _evict_candidates(spec)
    K = int(prefetch_pages)
    # deepest per-column readahead actually reachable: the plan-entry
    # window spreads ~K entries over the scanned columns
    K_LOOP = min(K, 4)
    # one PBM slice is a whole number of fine steps, and a macro-step is
    # an integer multiple of the fine step: time is quantised, not
    # accumulated
    n_inner = max(1, int(round(time_slice / float(dt))))
    h_max_i = max(1, int(round(h_max)))
    dt_long = float(dt) * min(h_max_i, n_inner)
    # static per-column trigger lookahead, sized for the longest jump
    W = spec.trigger_window(max(float(dt), dt_long), tight=True)
    n_rounds_io = max(_LOAD_MAX, int(round(h_io)) + 2)
    # a wake-exact jump spans at most the slice budget plus the absorbed
    # slices (and never more than 64 fine steps); the grant's candidate
    # window must cover every pop such a jump stands in for
    wake_cap_i = min(64, max(h_max_i, (1 + _MAX_ABSORB) * n_inner))
    n_rounds = max(n_rounds_io, wake_cap_i * _LOAD_MAX)
    f32 = np.float32
    dt_ref = float(f32(dt))
    time_slice_f = float(f32(time_slice))
    # jitter amplitude times the hash's 2^-24 (a power of two: exact)
    jit_scale = float(f32(_JIT_STEPS) * f32(dt)) * 2.0 ** -24
    t_io_base = float(f32(h_io) * f32(dt))
    gate_base = float(f32(_GATE_P))
    dip_p0 = float(f32(_DIP_P))
    dip_q0 = float(f32(1.0) - f32(_DIP_P))
    max_page = float(np.max(spec.page_size))
    # supersaturation threshold: the aggregate plan-window bytes every
    # stream can keep requested at once
    sat_bytes = float(f32(S * K * max_page))

    ts = spec_to_torch(spec, dev)
    page_size, page_first, page_last = ts.page_size, ts.page_first, ts.page_last
    page_col, page_valid = ts.page_col, ts.page_valid
    col_start, col_npages, col_tpp = ts.col_start, ts.col_npages, ts.col_tpp
    q_start, q_len, q_rate, q_cols, n_q = (
        ts.q_start, ts.q_len, ts.q_rate, ts.q_cols, ts.n_q)
    page_size64 = page_size.double()
    col_last = col_npages - 1
    inv_tpp = 1.0 / col_tpp
    s_idx = torch.arange(S, device=dev)
    s_mul = _idx_mul(S, dev)
    p_mul = _idx_mul(P, dev)
    tie_idx = (32767 - torch.arange(P, device=dev)).to(torch.int32)
    wk = torch.arange(W + 1, device=dev)
    ks = torch.arange(K_LOOP + 1, device=dev)
    ks_is0 = (ks == 0).view(1, 1, 1, -1)
    kb = torch.where(ks == 0, 31, torch.clamp(K_LOOP + 1 - ks, 1, 30)).to(
        torch.int32)
    bk = torch.arange(_SEG_WIN, device=dev)
    U = min(P, _UPD_CAP)
    slot_ids = torch.arange(C * (K_LOOP + 1), device=dev)
    # 0-d constants: a Python scalar in torch.where costs a fill kernel on
    # every call, a tensor made once does not
    zero_f = torch.zeros((), device=dev)
    inf_f = torch.full((), _INF, device=dev)
    ninf_f = torch.full((), -_INF, device=dev)
    neg1_i = torch.full((), -1, dtype=torch.int32, device=dev)
    none_i = torch.full((), _REQ_NONE, dtype=torch.int32, device=dev)
    tie_max_i = torch.full((), 32767, dtype=torch.int32, device=dev)
    dt_ref_f = torch.full((), dt_ref, device=dev)
    t_io_base_f = torch.full((), t_io_base, device=dev)
    dip_p0_f = torch.full((), dip_p0, device=dev)
    dip_q0_f = torch.full((), dip_q0, device=dev)
    cap4_f = torch.full((), 4 * max_page, device=dev)
    cap1_f = torch.full((), max_page, device=dev)
    # the three per-(stream, step) draws of one step share one hash pass:
    # rows = request gate, cohort order, speed dip
    s_mul3 = torch.stack([_idx_mul(S, dev, 2246822519), s_mul, s_mul])
    t_mul3 = torch.tensor([[3266489917], [40503], [3266489917]], device=dev)

    # ---- policy dispatch tables (policy-provided, id-indexed) ------------
    n_pol = len(policies)
    ids = POLICY_IDS
    max_id = max(ids.values())
    lookup_np = np.zeros(max_id + 1, np.int64)
    valid_np = np.zeros(max_id + 1, bool)
    for j, p in enumerate(policies):
        lookup_np[ids[p.name]] = j
        valid_np[ids[p.name]] = True
    lookup = torch.as_tensor(lookup_np, device=dev)
    id_valid = torch.as_tensor(valid_np, device=dev)
    k_wins = torch.as_tensor(
        [p.request_window(spec, K) for p in policies], device=dev)
    plan_flags = torch.as_tensor(
        [p.fifo_tie == "plan" for p in policies], device=dev)
    coop_idx = next((j for j, p in enumerate(policies) if p.cooperative),
                    None)
    has_coop = coop_idx is not None
    coop_flags = torch.as_tensor([p.cooperative for p in policies],
                                 device=dev)
    if has_coop:
        if spec.q_table is None:
            raise ValueError(
                "cooperative policy needs the multitable query-table map; "
                "lower the workload with compiler.compile_workload")
        cc = coop_mod.coop_consts(spec, dev)
        q_table = torch.as_tensor(spec.q_table, device=dev).long()
    else:
        cc = None
    p_ids = torch.arange(P, device=dev)

    def sel(is_coop, coop_val, inorder_val):
        """Per-lane blend between the cooperative and in-order models:
        nothing to blend without a cooperative policy, nothing else to
        blend with it alone."""
        if not has_coop:
            return inorder_val
        if n_pol == 1:
            return coop_val
        return torch.where(
            is_coop.view((-1,) + (1,) * (inorder_val.dim() - 1)),
            coop_val, inorder_val)

    def lane_consts(cfg: ArraySimConfig) -> _LaneConsts:
        cfg = _lanes(cfg)
        pid = cfg.policy.long()
        pid_c = pid.clamp(0, max_id)
        # a config whose policy id is NOT in this step's compiled set must
        # not silently run as some other policy: the lane trips the
        # livelock guard on its first step and ends truncated
        ok_id = (pid >= 0) & (pid <= max_id) & id_valid[pid_c]
        pol_local = lookup[pid_c]
        sat = cfg.capacity_bytes < sat_bytes
        return _LaneConsts(
            ok_id=ok_id,
            pol_local=pol_local,
            is_coop=coop_flags[pol_local],
            sat=sat,
            k_win=k_wins[pol_local].view(-1, 1, 1, 1),
            plan_tie=plan_flags[pol_local].view(-1, 1),
            dt_bad=cfg.max_time + 1.0,
            batch=torch.clamp(cfg.capacity_bytes, max=16 * max_page),
            inc_ref=cfg.bandwidth * dt_ref,
            pops_wake=torch.full_like(cfg.policy, _LOAD_MAX),
            # non-saturated lanes keep the short pop cap; a wake-exact
            # supersaturated jump needs every pop its fine steps would take
            pop_cap=torch.where(sat, n_rounds, n_rounds_io).to(torch.int32),
            h_cap=torch.where(sat, float(wake_cap_i), float(h_max_i)),
        )

    def pool_bytes(mask: torch.Tensor) -> torch.Tensor:
        """Bytes of the masked pages per lane: summed in float64 (exact
        for byte counts, so independent of the reduction order), rounded
        once to f32."""
        return (page_size64 * mask).sum(dim=1).float()

    def query_view(qidx, pos) -> _View:
        """Gather the per-stream view of the current query + per-column
        frontier cursors (plan-trigger granular, see :class:`_View`).
        Every gather index is clamped into its table: an out-of-range
        index asserts on the device."""
        qi = qidx.clamp(0, Q - 1)
        active = qidx < n_q
        start = q_start[s_idx, qi]
        length = q_len[s_idx, qi]
        rate = q_rate[s_idx, qi]
        cols = q_cols[s_idx, qi]                          # (L, S, C)
        cur = start + pos
        end = start + length
        # tolerance for "has the cursor crossed this trigger": one tuple
        # plus the f32 ulp of the cursor magnitude
        eps = 1.0 + 4e-7 * end
        cur3 = cur.unsqueeze(2)
        local = torch.floor(cur3 / col_tpp).long()
        local = torch.minimum(local.clamp(min=0), col_last)
        # page boundaries are exact ints but tpp is fractional: correct the
        # division so cur lands in [first, last) of its page
        pidx0 = col_start + local
        local = local + (cur3 >= page_last[pidx0]).long() \
            - (cur3 < page_first[pidx0]).long()
        local = torch.minimum(local.clamp(min=0), col_last)
        pidx0 = col_start + local
        # frontier: the containing page iff its trigger is still ahead of
        # (or at) the cursor, else the next page
        start3 = start.unsqueeze(2)
        trig0 = torch.maximum(page_first[pidx0], start3)
        consumed0 = trig0 < (cur - eps).unsqueeze(2)
        frontier = local + consumed0.long()               # may == npages
        fpidx = col_start + torch.minimum(frontier, col_last)
        pf_f = page_first[fpidx]
        ftrig = torch.maximum(pf_f, start3)
        fneed = (
            active.unsqueeze(2) & cols & (frontier < col_npages)
            & (pf_f < end.unsqueeze(2))
        )
        return _View(active, length, rate, cols, start, cur, end, eps,
                     frontier, fpidx, ftrig, fneed)

    col_start4 = col_start.view(1, 1, C, 1)
    col_last4 = col_last.view(1, 1, C, 1)
    col_npages4 = col_npages.view(1, 1, C, 1)

    def window(view: _View):
        """Trigger-window geometry of a view: global page ids, triggers,
        need mask and cursor distance of the next W+1 plan triggers per
        (stream, column).  Entries w < W gate the advance (block at the
        first absent trigger), entry W is the conservative cap.  Computed
        once on the post-advance view and carried: this step's ``view2``
        window IS the next step's ``view`` window."""
        w_local = view.frontier.unsqueeze(3) + wk
        w_pidx = col_start4 + torch.minimum(w_local, col_last4)
        pf = page_first[w_pidx]
        w_trig = torch.maximum(pf, view.start.view(-1, S, 1, 1))
        w_need = (
            view.fneed.unsqueeze(3) & (w_local < col_npages4)
            & (pf < view.end.view(-1, S, 1, 1))
        )
        w_dist = torch.clamp(w_trig - view.cur.view(-1, S, 1, 1), min=0.0)
        return w_pidx, w_trig, w_need, w_dist

    def gather_w(rows: torch.Tensor, idx_flat: torch.Tensor):
        """``rows (L, P)`` at the flattened window ids, as ``(L, S, C, W)``."""
        return rows.gather(1, idx_flat).view(-1, S, C, W)

    def absent_in(win, resident, idx_flat=None):
        w_pidx, _w_trig, w_need, _w_dist = win
        if idx_flat is None:
            idx_flat = w_pidx[..., :W].reshape(w_pidx.shape[0], -1)
        return w_need[..., :W] & ~gather_w(resident, idx_flat)

    def adv_limit(win, resident, absent=None):
        """Per-stream advance limit against a residency: distance to the
        first absent trigger, capped at the (W+1)-th trigger when every
        windowed page is resident."""
        _w_pidx, _w_trig, w_need, w_dist = win
        if absent is None:
            absent = absent_in(win, resident)
        lim = torch.where(absent, w_dist[..., :W], inf_f).amin(dim=3)
        cap = torch.where(w_need[..., W], w_dist[..., W], inf_f)
        return torch.minimum(lim, cap).amin(dim=2)           # (L, S)

    def compact(mask: torch.Tensor):
        """Ids of the first ``U`` set entries of each row, ascending, with
        their on-flags: a fixed-size compaction that never reads the count
        on the host.  The stable sort puts the set entries first in index
        order; slots beyond the count hold unset pages (flag False).
        Overflow beyond ``U`` leaves a page out, like the reference."""
        order = torch.sort((~mask).to(torch.uint8), dim=1, stable=True)[1]
        ids_u = order[:, :U]
        return ids_u, mask.gather(1, ids_u)

    def core(state: SimState, view: _View, win, cfg: ArraySimConfig,
             lc: _LaneConsts, h_u, adv_lim, pend_in, slices_u=None):
        """One macro-step standing in for ``h_u`` (an ``(L,)`` i32) fine
        steps.  ``adv_lim`` is the advance limit against this step's
        residency (the previous step's horizon computed it), ``pend_in``
        the queue bytes that horizon saw.  Returns the stepper's carry."""
        L = h_u.shape[0]
        h_f = h_u.float()
        dt = h_f * dt_ref                                   # (L,)
        dt1 = dt.unsqueeze(1)
        ok_id, sat, is_coop = lc.ok_id, lc.sat, lc.is_coop
        t2 = state.t + torch.where(ok_id, dt, lc.dt_bad)
        t2c = t2.unsqueeze(1)
        steps1 = state.steps.unsqueeze(1)
        one_step = (h_u == 1)
        # this step's three per-(stream, step) uniform draws, (L, 3, S)
        steps_l = state.steps.long()
        h3 = ((s_mul3 + steps_l.view(L, 1, 1) * t_mul3) & _U32) >> 8
        u3 = h3.float() * 2.0 ** -24

        # ============ CPU: consume up to the first absent trigger =========
        (active, length, rate, cols, start, cur, end, eps, _frontier,
         _fpidx, _ftrig, _fneed) = view
        # tie-break jitter for the LRU clock: every touch/load in one step
        # would otherwise share the timestamp t2 and eviction would break
        # the ties by page index, a systematic bias.  A deterministic
        # per-(page, step) hash spanning _JIT_STEPS FINE step lengths
        # reproduces the event engine's order noise.
        jit_p = (((p_mul + steps_l.unsqueeze(1) * 40503) & _U32) >> 8
                 ).float() * jit_scale                      # (L, P)
        w_pidx, w_trig, w_need, _w_dist = win
        # per-(stream, query) CPU-rate skew: scans at the same position
        # drift apart within a query instead of advancing in lockstep
        ur = _u01(s_mul, state.qidx, 48271)
        rate_j = rate * (1.0 + _RATE_JIT * (2.0 * ur - 1.0))
        runnable = active & (adv_lim > 0.0)
        remaining = length - state.pos
        adv_io = torch.where(
            runnable,
            torch.minimum(torch.minimum(rate_j * dt1, remaining), adv_lim),
            zero_f,
        ).clamp(min=0.0)
        margin = torch.clamp(3e-5 * length, min=0.5)
        finished_io = runnable & (remaining - adv_io <= margin)
        if has_coop:
            # the cooperative CPU model: chunk-granular, out of order
            cstate = state.pstate[coop_idx]
            q_tab = q_table[s_idx, state.qidx.clamp(0, Q - 1)]
            coop_cpu = coop_mod.cpu_phase(
                cc, cstate, active=active, start=start, end=end, cols=cols,
                q_tab=q_tab, rate_j=rate_j, dt=dt1, credit_cap=rate_j * dt1,
                resident=state.resident, page_valid=page_valid)
            adv = sel(is_coop, coop_cpu.adv, adv_io)
            finished = sel(is_coop, coop_cpu.finished, finished_io)
        else:
            adv, finished = adv_io, finished_io
        # invalid-lane freeze: no consumption, no completions — the lane
        # must end truncated, not half-run
        ok1 = ok_id.unsqueeze(1)
        adv = torch.where(ok1, adv, zero_f)
        finished = finished & ok1
        cur2_pre = cur + adv_io

        qidx2 = state.qidx + finished.long()
        pos2 = torch.where(finished, zero_f, state.pos + adv)
        newly_done = (qidx2 >= n_q) & (state.stream_done_t < 0)
        stream_done_t2 = torch.where(newly_done, t2c, state.stream_done_t)

        # speed estimation on the engine's report cadence, not per step:
        # once per PBM slice from the cumulative consumed-tuples counter
        consumed2 = state.consumed + adv
        # post-advance view (the I/O demand below works on it); its rate
        # is the rate of the query each stream is in after this step
        view2 = query_view(qidx2, pos2)
        (active2, len2, rate2, cols2, start2, cur2, end2, eps2, frontier2,
         _fpidx2, _ftrig2, need2) = view2
        next_rate = rate2
        speed1 = torch.where(finished, next_rate, state.speed)
        if refresh:
            prog = consumed2 - state.consumed_ref
            if slices_u is None:
                inst = prog / time_slice_f
            else:
                inst = prog / (time_slice_f * slices_u.float()).unsqueeze(1)
            speed2 = torch.where(
                active & (prog > _PROG_MIN) & ~finished,
                _BURST_W * next_rate + (1.0 - _BURST_W) * inst,
                speed1,
            )
            consumed_ref2 = consumed2
        else:
            speed2 = speed1
            consumed_ref2 = state.consumed_ref

        # pages consumed this step: resident windowed pages whose trigger
        # the cursor crossed (the predicate the next view's frontier uses)
        cross_pidx = w_pidx[..., :W]
        cross_flat = cross_pidx.reshape(L, -1)
        crossed = (
            w_need[..., :W]
            & runnable.view(L, S, 1, 1)
            & gather_w(state.resident, cross_flat)
            & (w_trig[..., :W] < (cur2_pre - eps).view(L, S, 1, 1))
        )
        if has_coop:
            crossed = crossed & ~is_coop.view(L, 1, 1, 1)
        # the LRU clock ticks when a page is consumed
        touch = torch.where(
            crossed, t2.view(L, 1, 1, 1) + gather_w(jit_p, cross_flat), ninf_f)
        last_used2 = state.last_used.scatter_reduce(
            1, cross_flat, touch.view(L, -1), "amax", include_self=True)
        if has_coop:
            touched_coop = is_coop.unsqueeze(1) & coop_cpu.consumed_pages
            last_used2 = torch.where(touched_coop, t2c + jit_p, last_used2)

        # ================= I/O demand of the post-advance view ===========
        # request set = the engine's plan window: the blocking page plus
        # the next ~K plan entries in (trigger, column, page) order — an
        # entry-COUNT window, resident entries included in the budget
        dens = torch.where(need2, inv_tpp, zero_f).sum(dim=2)  # (L, S)
        pf_local = frontier2.unsqueeze(3) + ks
        pf_pidx = col_start4 + torch.minimum(pf_local, col_last4)
        pf_first = page_first[pf_pidx]
        exists = (
            (pf_local < col_npages4) & need2.unsqueeze(3)
            & (pf_first < end2.view(L, S, 1, 1))
        )
        pf_trig = torch.maximum(pf_first, start2.view(L, S, 1, 1))
        e_trig = torch.where(exists, pf_trig, inf_f)
        # rank in the plan order: a stable sort resolves equal triggers by
        # (column, page) flat position — the engine's plan sort key — and
        # the rank is the inverse permutation
        order = torch.sort(e_trig.view(L, S, -1), dim=2, stable=True)[1]
        rank = torch.empty_like(order).scatter_(
            2, order, slot_ids.expand_as(order)).view(L, S, C, K_LOOP + 1)
        # the k=0 slot (the frontier itself) is always requested once its
        # trigger reaches the cursor — the blocking demand
        blocking = ks_is0 & (pf_trig <= (cur2 + eps2).view(L, S, 1, 1))
        # request cadence gate: a scan issues requests only while it runs
        # and at the instant it blocks; a blocked scan's window refreshes
        # as a per-fine-step Bernoulli process scaled by its duty cycle
        ug = u3[:, 0]
        t_pos = torch.clamp(state.t, min=1e-9).unsqueeze(1)
        duty_g = torch.clamp(
            (state.consumed / t_pos) / torch.clamp(rate, min=1.0), 0.0, 1.0)
        gate_p = gate_base * (1.0 - duty_g)
        # a macro-step fires the per-fine-step process with the
        # compounded probability; h_u == 1 keeps gate_p exactly
        gate_p = torch.where(
            one_step.unsqueeze(1), gate_p,
            1.0 - torch.pow(1.0 - gate_p, h_f.unsqueeze(1)))
        gate = (adv_io > 0.0) | (steps1 == 0) | finished | (ug < gate_p)
        # per-policy readahead width; the blocking demand is exempt from
        # the gate
        ok = exists & (
            ((rank <= lc.k_win) & gate.view(L, S, 1, 1)) | blocking)
        pf_flat = pf_pidx.reshape(L, -1)
        bonus = torch.full((L, P), -1, dtype=torch.int32, device=dev)
        bonus.scatter_reduce_(
            1, pf_flat, torch.where(ok, kb, neg1_i).view(L, -1), "amax",
            include_self=True)
        not_res = ~state.resident & page_valid
        in_plan_window = (bonus >= 0) & not_res
        # FIFO request queue, array-form: every page keeps the step at
        # which it was first requested, and the request STAYS queued after
        # the cursor's plan window moves past it (dropped on load, and at
        # each slice refresh for pages no active scan is interested in)
        wanted = in_plan_window | ((state.req_step != _REQ_NONE) & not_res)
        stamp_now = (state.steps + 1).unsqueeze(1)
        req_step2 = torch.where(
            wanted, torch.minimum(state.req_step, stamp_now), none_i)
        # strict FIFO by first-wanted step; ties within one step's cohort
        # resolve by a (stream hash, plan rank) slot fixed at stamp time
        stamp_age = torch.clamp(stamp_now - req_step2, 0, 32767)
        # cohort order of the streams, 512 * u truncated: the top 9 of the
        # draw's 24 bits
        s_ord = h3[:, 1] >> 15
        slot = (s_ord.view(L, S, 1, 1) * 64 + rank.clamp(0, 63)).to(
            torch.int32)
        tie_now = torch.full((L, P), 32767, dtype=torch.int32, device=dev)
        tie_now.scatter_reduce_(
            1, pf_flat, torch.where(ok, slot, tie_max_i).view(L, -1), "amin",
            include_self=True)
        new_stamp = wanted & (state.req_step == _REQ_NONE)
        req_tie2 = torch.where(new_stamp, tie_now, state.req_tie)
        # per-policy cohort order: stream-block order or plan order
        tie15 = torch.where(lc.plan_tie, tie_idx, 32767 - req_tie2)
        load_key = torch.where(wanted, stamp_age * 32768 + tie15, neg1_i)

        # ================= I/O server: budgeted admission =================
        used = pool_bytes(state.resident)
        free = cfg.capacity_bytes - used
        # a running scan pins the pages of its current CPU burst — the last
        # ~segment_pages plan entries behind the cursor; a blocked scan
        # pins nothing, so tiny pools cannot livelock
        seg_len = _SEG_PAGES / torch.clamp(dens, min=1e-30)   # (L, S)
        b_local = frontier2.unsqueeze(3) - 1 - bk
        b_pidx = col_start4 + torch.minimum(b_local.clamp(min=0), col_last4)
        b_trig = torch.maximum(page_first[b_pidx], start2.view(L, S, 1, 1))
        burst = (
            (b_local >= 0)
            & (cols2 & active2.unsqueeze(2)).unsqueeze(3)
            & runnable.view(L, S, 1, 1)
            & (b_trig >= (cur2 - seg_len).view(L, S, 1, 1))
        )
        pin = torch.zeros((L, P), dtype=torch.int32, device=dev)
        pin.scatter_reduce_(
            1, b_pidx.reshape(L, -1), burst.view(L, -1).to(torch.int32),
            "amax", include_self=True)
        evictable = state.resident & (pin == 0) & page_valid
        wanted_q = wanted
        if has_coop:
            # the cooperative I/O model: one chunk at a time, Keep < Load
            done3 = coop_mod.clear_on_query_change(
                coop_cpu.done, coop_cpu.finished)
            coop_io = coop_mod.io_phase(
                cc, done=done3, cur_chunk=coop_cpu.cur_chunk,
                inflight=cstate.inflight, pin_pages=coop_cpu.pin_pages,
                active=active2, start=start2, end=end2, cols=cols2,
                q_tab=q_table[s_idx, qidx2.clamp(0, Q - 1)],
                resident=state.resident, free=free, page_size=page_size,
                page_valid=page_valid)
            load_key = sel(is_coop, coop_io.load_key, load_key)
            wanted_q = sel(is_coop, coop_io.wanted, wanted)
            evictable = sel(is_coop, coop_io.evictable, evictable)
        evictable_bytes = pool_bytes(evictable)
        headroom = free + evictable_bytes
        # one rounding, as the JAX package's compiled step takes it (XLA
        # contracts this multiply-add on the CPU): the f64 product of two
        # f32 values is exact
        credit = (state.io_credit.double()
                  + cfg.bandwidth.double() * dt.double()).float()
        # an invalid lane's server grants nothing
        budget = torch.where(ok_id, torch.minimum(credit, headroom), zero_f)
        # serial-server causality over a macro-step: credit accrued
        # while the queue was EMPTY must not fund requests that only
        # appear at the end of the jump, so the serviceable bytes are
        # capped at the queue content present when the jump began
        # plus one fine step's credit
        pend0 = pend_in
        if has_coop:
            infl0 = cstate.inflight
            pend_c0 = (
                (cc.page_chunk == infl0.clamp(0, cc.n_chunks - 1)
                 .unsqueeze(1))
                & (infl0 >= 0).unsqueeze(1) & not_res)
            pend0 = sel(is_coop, pool_bytes(pend_c0), pend_in)
        budget = torch.minimum(
            budget, state.io_credit + pend0 + lc.inc_ref)
        # budgeted FIFO pop as ONE batched grant: strict head-of-line,
        # _LOAD_MAX pops per fine step stood in for
        pops = torch.minimum(h_u * _LOAD_MAX, lc.pop_cap)
        load_mask, load_bytes, n_load = fifo_grant(
            load_key, page_size, budget, pops, vmax=n_rounds)

        # bank leftover credit: 4 pages while requests remain unserved,
        # one page-time with an empty queue
        leftover = credit - load_bytes
        starved_io = (wanted_q & ~load_mask).any(dim=1)
        io_credit2 = torch.minimum(
            leftover, torch.where(starved_io, cap4_f, cap1_f))

        # engine speed-estimate DIPS, sampled per (stream, step) with the
        # probability compounded over the fine steps of a macro-step
        eff_rate = torch.clamp(state.consumed / t_pos, min=1.0)
        dip_p = torch.where(one_step, dip_p0_f, 1.0 - torch.pow(dip_q0_f, h_f))
        speed_push = torch.where(
            u3[:, 2] < dip_p.unsqueeze(1),
            torch.minimum(_DIP_DEPTH * eff_rate, speed2), speed2)

        # ================= policy hooks + batched eviction ================
        was_crossed = torch.zeros((L, P), dtype=torch.int32, device=dev)
        was_crossed.scatter_reduce_(
            1, cross_flat, crossed.view(L, -1).to(torch.int32), "amax",
            include_self=True)
        crossed_io = was_crossed = was_crossed > 0
        if has_coop:
            was_crossed = sel(is_coop, coop_cpu.consumed_pages, crossed_io)
        # compacted within-slice update set: the pages whose consumption
        # state changed this step (loads + crossings).  The JAX package's
        # fixed stepper hands PBM the padded grant and in-order cross
        # windows instead (no chunk consumption): the update is a min over
        # the same set of pages with one value a page, so the result is
        # the same.
        if refresh:
            upd_pages = upd_on = None
        else:
            upd_pages, upd_on = compact(
                (was_crossed | load_mask)
                & page_valid)
        ctx = StepCtx(
            spec=spec, refresh=refresh, time_slice=time_slice_f, now=t2,
            steps=state.steps, slices_done=state.slices_done,
            slices_elapsed=slices_u, slices_max=1 + _MAX_ABSORB, dt=dt,
            page_first=page_first, page_last=page_last, page_col=page_col,
            page_valid=page_valid, resident=state.resident,
            last_used=last_used2, load_mask=load_mask,
            cross_pidx=cross_pidx, crossed=crossed,
            upd_pages=upd_pages, upd_on=upd_on,
            active=active2, cols=cols2, cur=cur2, end=end2, start=start2,
            eps=eps2, rate=rate2, speed_push=speed_push,
            coop=coop_io if has_coop else None,
        )
        pstate2 = tuple(
            coop_mod.CoopState(
                done=done3, cur_chunk=coop_cpu.cur_chunk,
                chunk_pos=coop_cpu.chunk_pos, credit=coop_cpu.credit,
                inflight=coop_io.inflight)
            if p.cooperative else p.on_consume(p.on_request(ps, ctx), ctx)
            for p, ps in zip(policies, state.pstate))
        keys = [p.score_victims(ps, ctx) for p, ps in zip(policies, pstate2)]
        if n_pol == 1:
            key = keys[0]
        else:
            key = torch.stack(keys).gather(
                0, lc.pol_local.view(1, L, 1).expand(1, L, P))[0]

        if refresh:
            # query-end request drop, slice-quantised
            interested = (ctx.eta_estimate() < BIG_CUT) & page_valid
            req_step2 = torch.where(interested, req_step2, none_i)
            slices_done2 = state.slices_done + (
                1 if slices_u is None else slices_u)
        else:
            slices_done2 = state.slices_done

        # evictions are amortised in batches (>= 16 pages); the
        # cooperative server evicts exactly what its chunk needs
        over = load_bytes > free
        need_free = torch.where(
            over,
            torch.minimum(torch.maximum(load_bytes, lc.batch) - free,
                          evictable_bytes),
            zero_f,
        )
        if has_coop:
            need_coop = torch.where(
                over, torch.minimum(load_bytes - free, evictable_bytes),
                zero_f)
            need_free = sel(is_coop, need_coop, need_free)
        evict = batched_evict(key, page_size, evictable, need_free, vmax=vmax)

        resident2 = (state.resident & ~evict) | load_mask
        last_used3 = torch.where(load_mask, t2c + jit_p, last_used2)
        # churn diagnostic: a page evicted while still "fresh" (loaded but
        # never consumed since) was a wasted load
        not_crossed = ~was_crossed
        fresh2 = load_mask | (state.fresh & not_crossed & resident2)
        churn2 = state.churn + (state.fresh & evict & not_crossed).sum(
            dim=1, dtype=torch.int32)
        req_step3 = torch.where(load_mask, none_i, req_step2)
        demand_hit = load_mask & (bonus == 31)
        if has_coop:
            demand_hit = demand_hit & ~is_coop.unsqueeze(1)

        new_state = SimState(
            resident=resident2,
            last_used=last_used3,
            req_step=req_step3,
            req_tie=req_tie2,
            fresh=fresh2,
            qidx=qidx2,
            pos=pos2,
            speed=speed2,
            consumed=consumed2,
            consumed_ref=consumed_ref2,
            stream_done_t=stream_done_t2,
            t=t2,
            steps=state.steps + 1,
            slices_done=slices_done2,
            io_credit=io_credit2,
            io_bytes=state.io_bytes + load_bytes,
            loads=state.loads + n_load,
            loads_demand=state.loads_demand + demand_hit.sum(
                dim=1, dtype=torch.int32),
            churn=churn2,
            pstate=pstate2,
        )

        # ================= event horizon of the NEXT step =================
        # The earliest "interesting" time ahead: the post-advance trigger
        # window (computed here ONCE and carried) and the pending request
        # queue.  Everything is a lower bound on "nothing the
        # discretisation cares about happens before then".
        win2 = window(view2)
        w_pidx2, _wt2, _wn2, w_dist2 = win2
        win2_flat = w_pidx2[..., :W].reshape(L, -1)
        absent2 = absent_in(win2, resident2, win2_flat)
        adv_lim2 = adv_limit(win2, resident2, absent2)
        runnable2 = active2 & (adv_lim2 > 0.0)
        remaining2 = torch.clamp(len2 - pos2, min=0.0)
        # next trigger arrival / stream completion
        t_cpu = torch.where(
            runnable2,
            torch.minimum(adv_lim2, remaining2) / torch.clamp(rate2, min=1.0),
            inf_f,
        )
        # io-credit horizon: while requests are pending the server is the
        # clock.  Non-saturated lanes jump at most h_io fine steps;
        # supersaturated lanes jump by the EXACT serial-server wake (or
        # never, without wake_exact).
        wanted3 = (req_step3 != _REQ_NONE) & ~resident2 & page_valid
        pend_bytes2 = pool_bytes(wanted3)
        pend2 = pend_bytes2 > 0.0
        # the queue key the NEXT step will serve: one step older
        stamp_age3 = torch.clamp(
            (state.steps + 2).unsqueeze(1) - req_step3, 0, 32767)
        wake_key = torch.where(wanted3, stamp_age3 * 32768 + tie15,
                               neg1_i)
        wake_step = wake_solve(
            wake_key, page_size, io_credit2, lc.inc_ref, lc.pops_wake,
            h_cap=wake_cap_i)
        # a blocked stream wakes when EVERY absent page it sits on is
        # granted; the lane jumps to the EARLIEST such wake
        d0 = absent2 & (w_dist2[..., :W] <= 0.0)
        kp = torch.where(
            d0, gather_w(wake_step, win2_flat).float(), zero_f)
        k_stream = kp.amax(dim=(2, 3))
        blocked_s = active2 & ~runnable2 & d0.any(dim=3).any(dim=2)
        k_wake = torch.where(blocked_s, k_stream, inf_f).amin(dim=1)
        # headroom guard: the solve's credit cadence is only real
        # while the pool can absorb it
        finite = torch.isfinite(k_wake)
        can_jump = finite & (
            io_credit2 + k_wake * cfg.bandwidth * dt_ref <= headroom)
        t_wake = torch.where(
            can_jump, (k_wake + 0.25) * dt_ref,
            torch.where(finite, dt_ref_f, t_io_base_f))
        t_io_pend = torch.where(sat, t_wake, t_io_base_f)
        t_io = torch.where(pend2, t_io_pend, inf_f)
        if has_coop:
            # cooperative lanes: consumption is chunk-granular, so the
            # in-order trigger candidate means nothing; the chunk in flight
            # plays the pending queue's role (the wake solve models the
            # in-order queue: cooperative lanes keep the fine cadence
            # while saturated)
            t_cpu = sel(is_coop, inf_f.expand(L, S), t_cpu)
            t_io_coop = torch.where(sat, zero_f, t_io_base_f)
            t_io = sel(is_coop,
                       torch.where(coop_io.inflight >= 0, t_io_coop, inf_f),
                       t_io)
        next_dt = torch.minimum(t_cpu.amin(dim=1), t_io)
        # per-policy horizon providers (ArrayPolicy.scan_horizon): the
        # in-order policies have no clock of their own; array-CScan reports
        # each stream's current-chunk completion
        hz = HorizonView(spec=spec, active=active2, start=start2, end=end2,
                         rate=rate2, dt_ref=dt_ref, coop=cc)
        t_tab = [p.scan_horizon(ps, hz) for p, ps in zip(policies, pstate2)]
        if any(t is not None for t in t_tab):
            t_tab = [torch.full_like(t_cpu, _INF) if t is None else t
                     for t in t_tab]
            t_pol = torch.stack(t_tab).gather(
                0, lc.pol_local.view(1, L, 1).expand(1, L, S))[0]
            next_dt = torch.minimum(next_dt, t_pol.amin(dim=1))
        # quantise to whole fine steps (floor: undershooting a horizon only
        # costs an extra step).  Clamped in float: inf has no integer.
        next_h = torch.minimum(
            torch.floor(next_dt / dt_ref).clamp(min=1.0), lc.h_cap,
        ).to(torch.int32)
        return (new_state, view2, win2, adv_lim2, pend_bytes2, next_h)


    if refresh:
        def step(carry, cfg: ArraySimConfig, live=None, lc=None):
            # slice-boundary step: absorb the slice remainder, then re-arm
            # the slice budget of n_inner fine steps
            cfg = _lanes(cfg)
            lc = lane_consts(cfg) if lc is None else lc
            state, view, win, adv_lim, pend, rem_u, next_h = carry
            # a wake-exact supersaturated jump may clear whole slices
            # beyond this one's tail: absorb up to _MAX_ABSORB of them
            # (the PBM timeline shift, the slice counter and the
            # speed-EWMA cadence all advance by the absorbed count)
            extra = torch.where(
                lc.sat,
                torch.clamp(
                    torch.div(next_h - rem_u, n_inner, rounding_mode="floor"),
                    0, _MAX_ABSORB),
                0,
            )
            h_u = rem_u + extra * n_inner
            slices_u = 1 + extra
            new_state, view2, win2, adv_lim2, pend2, next_h2 = core(
                state, view, win, cfg, lc, h_u, adv_lim, pend,
                slices_u=slices_u)
            out = (new_state, view2, win2, adv_lim2, pend2,
                   torch.full_like(rem_u, n_inner), next_h2)
            return out if live is None else _freeze(live, out, carry)
    else:
        def step(carry, cfg: ArraySimConfig, live=None, lc=None):
            # within-slice macro-step: jump to the event horizon, keeping
            # at least one fine step of slice for the refresh to absorb
            cfg = _lanes(cfg)
            lc = lane_consts(cfg) if lc is None else lc
            state, view, win, adv_lim, pend, rem_u, next_h = carry
            h = torch.minimum(next_h, rem_u - 1)
            new_state, view2, win2, adv_lim2, pend2, next_h2 = core(
                state, view, win, cfg, lc, h, adv_lim, pend)
            out = (new_state, view2, win2, adv_lim2, pend2, rem_u - h,
                   next_h2)
            return out if live is None else _freeze(live, out, carry)

    step.adv_limit = adv_limit
    step.query_view = query_view
    step.window = window
    step.lane_consts = lane_consts
    step.n_inner = n_inner
    return step


def run(spec: SimSpec, cfg: ArraySimConfig, policies: Sequence[str],
        bandwidth_ref: float, time_slice: float, device,
        prefetch_pages: int = 8, max_slices: int = 80_000) -> SimState:
    """Step every lane of a stacked config from t = 0 until every stream
    of every lane has finished or the lane's ``max_time`` is reached: the
    program's ``make_runner(stepper="horizon", wake_exact=True)`` loop
    nest, written out eagerly.  The outer loop runs while any lane is
    unfinished, the inner loop while any live lane has macro-steps left
    in its slice; a lane whose own condition is false is frozen by a
    per-lane select.  Returns the final state."""
    dev = torch.device(device)
    pols = resolve_policies(policies)
    dt = float(np.max(spec.page_size)) / float(bandwidth_ref)
    cheap = make_step(spec, dt, time_slice, prefetch_pages, False, policies, dev)
    full = make_step(spec, dt, time_slice, prefetch_pages, True, policies, dev)
    n_inner = cheap.n_inner
    cfg = _lanes(cfg)
    L = cfg.policy.shape[0]
    lc = cheap.lane_consts(cfg)
    state = init_state(spec, pols, L, dev)
    view = cheap.query_view(state.qidx, state.pos)
    win = cheap.window(view)
    i32 = dict(dtype=torch.int32, device=dev)
    carry = (state, view, win, cheap.adv_limit(win, state.resident),
             torch.zeros(L, dtype=torch.float32, device=dev),
             torch.full((L,), n_inner, **i32), torch.ones(L, **i32))
    while True:
        st = carry[0]
        live = ((st.stream_done_t < 0).any(dim=1) & (st.t < cfg.max_time)
                & (st.slices_done < max_slices))
        n_live = int(live.sum())
        if n_live == 0:
            return carry[0]
        while True:
            # keep macro-stepping while the slice has more than one fine
            # step left AND the planned jump falls short of the boundary
            inner = live & (carry[5] > 1) & (carry[6] < carry[5])
            n_in = int(inner.sum())
            if n_in == 0:
                break
            carry = cheap(carry, cfg, None if n_in == L else inner, lc)
        carry = full(carry, cfg, None if n_live == L else live, lc)
