"""Cooperative Scans substrate of the array simulator (paper §2), lane-major.

Counterpart of the JAX package's ``repro.core.array_sim.coop``.  The ABM
*inverts* buffer-management control flow: loading decisions are global,
CScan operators consume whichever chunk of their range is ready
(out-of-order, chunk-at-a-time), and eviction is relevance-driven.  The
step (``sim.make_step``) runs this chunk-granular fluid model whenever a
``cooperative`` policy (array-CScan) is among its policies, and blends it
per lane with the in-order model by the lane's policy id.

The model mirrors the event engine's ``policies/cscan.py`` at chunk
granularity:

* **state** (:class:`CoopState`, the cooperative policy's private state):
  per (stream, chunk) consumed flags for the stream's current query, the
  chunk each stream is consuming (+ fractional progress and banked CPU
  credit), and the single chunk the serial I/O server is loading;
* **CPU** (:func:`cpu_phase`): an idle scan picks the *available* chunk
  (all pages of its columns resident) the fewest other scans are
  interested in (``UseRelevance``), then consumes its tuple overlap at the
  query rate; completion leftovers bank one step of credit;
* **I/O** (:func:`io_phase`): when the server idles, pick the next load by
  ``QueryRelevance`` (starved scans first, then fewest chunks remaining)
  then ``LoadRelevance`` (most interested scans, lowest chunk id), gated
  by the paper's eviction rule: a chunk is loadable only if enough bytes
  are held by chunks with strictly lower ``KeepRelevance`` (interest
  count).  Victims come from the least-interesting chunks through the same
  batched-evict kernel as every other policy, scored by ``keep_key``.

Every tensor carries the lane axis first: ``(L, S, CH)`` for ``done``,
``(L, S)`` for the per-stream leaves, ``(L,)`` for ``inflight``.

**Tie rules** (stated, not inherited from a reduction's behaviour): the
chunk an idle scan picks is the one with the smallest key ``interest
count * (CH + 2) + chunk id`` — fewest interested scans, then the lowest
id (keys are distinct per chunk, so the minimum is unique); the chunk the
server selects among equally relevant ones is the lowest id (a minimum
over the masked ids).  Byte sums over pages (a chunk's missing bytes, the
bytes held below each interest count and their prefix) are taken in
float64 — exact for byte counts, so independent of the order a device
reduces in — and rounded once to f32.  Where the f32 sums of the JAX
package are exact too (page sizes that are multiples of 2^k with totals
below 2^(24+k) bytes: the micro workload at every scale the repo runs),
the two agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_NEGI = -(1 << 30)
_PICK_BIG = 1 << 30

#: pick→consume rounds unrolled per step: a chunk's CPU time can be about
#: one step, so completing one chunk and starting the next must happen
#: within a step, or chunk boundaries quantise every scan to at most one
#: chunk a step
_PICK_ROUNDS = 2


class CoopState(NamedTuple):
    """Cooperative-substrate state: the ``ArrayCScan`` policy state."""

    done: torch.Tensor        # (L, S, CH) bool chunks consumed (current query)
    cur_chunk: torch.Tensor   # (L, S) i64 chunk being consumed, -1 = none
    chunk_pos: torch.Tensor   # (L, S) f32 tuples consumed within cur_chunk
    credit: torch.Tensor      # (L, S) f32 banked CPU budget (completion spill)
    inflight: torch.Tensor    # (L,) i64 chunk the I/O server loads, -1 = idle


class CoopCpu(NamedTuple):
    """CPU-phase outputs the step blends into its per-lane state."""

    adv: torch.Tensor             # (L, S) tuples credited to ``pos``
    finished: torch.Tensor        # (L, S) bool current query completed
    consumed_pages: torch.Tensor  # (L, P) bool pages of completed chunks
    pin_pages: torch.Tensor       # (L, P) bool pages of chunks being consumed
    done: torch.Tensor            # (L, S, CH) post-consumption flags
    cur_chunk: torch.Tensor       # (L, S) i64
    chunk_pos: torch.Tensor       # (L, S) f32
    credit: torch.Tensor          # (L, S) f32


class CoopIo(NamedTuple):
    """I/O-phase outputs: the cooperative lane's request set and evict view."""

    load_key: torch.Tensor    # (L, P) i32 server queue key (-1 = not wanted)
    wanted: torch.Tensor      # (L, P) bool missing pages of the inflight chunk
    evictable: torch.Tensor   # (L, P) bool Keep < Load rule applied
    keep_key: torch.Tensor    # (L, P) f32 eviction priority (fewest interest)
    inflight: torch.Tensor    # (L,) i64 updated inflight chunk
    starved: torch.Tensor     # (L, S) bool diagnostic


class CoopConsts(NamedTuple):
    """Device constants the step closes over (from ``SimSpec``)."""

    n_chunks: int
    n_cols: int
    page_chunk: torch.Tensor   # (P,) i64
    page_cc: torch.Tensor      # (P,) i64 flat (chunk, column) id of a page
    chunk_first: torch.Tensor  # (CH,) f32 table-local tuple coords
    chunk_last: torch.Tensor   # (CH,) f32
    chunk_table: torch.Tensor  # (CH,) i64
    chunk_ids: torch.Tensor    # (CH,) i64
    keep_tie: torch.Tensor     # (P,) f32 lowest-chunk-first part of keep_key


def coop_consts(spec, device) -> CoopConsts:
    if spec.page_chunk is None or int(spec.n_chunks) <= 0:
        raise ValueError(
            "spec has no chunk geometry — recompile the workload with "
            "compiler.compile_workload (the cooperative policy needs it)"
        )
    CH, C = int(spec.n_chunks), int(spec.n_cols)

    def to(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=device, dtype=dtype)

    page_chunk = to(spec.page_chunk, torch.int64)
    page_col = to(spec.page_col, torch.int64)
    keep_tie = 0.5 * (CH - page_chunk.float()) / CH
    return CoopConsts(
        n_chunks=CH, n_cols=C, page_chunk=page_chunk,
        page_cc=page_chunk * C + page_col,
        chunk_first=to(spec.chunk_first, torch.float32),
        chunk_last=to(spec.chunk_last, torch.float32),
        chunk_table=to(spec.chunk_table, torch.int64),
        chunk_ids=torch.arange(CH, device=device),
        keep_tie=keep_tie,
    )


def init_coop_state(spec, lanes: int, device) -> CoopState:
    S, CH = spec.n_streams, int(spec.n_chunks)
    if CH <= 0:
        raise ValueError(
            "spec has no chunk geometry — recompile the workload with "
            "compiler.compile_workload"
        )
    L = lanes
    return CoopState(
        done=torch.zeros((L, S, CH), dtype=torch.bool, device=device),
        cur_chunk=torch.full((L, S), -1, dtype=torch.int64, device=device),
        chunk_pos=torch.zeros((L, S), dtype=torch.float32, device=device),
        credit=torch.zeros((L, S), dtype=torch.float32, device=device),
        inflight=torch.full((L,), -1, dtype=torch.int64, device=device),
    )


def chunk_pick(prev_inflight, new_inflight):
    """Did the I/O server switch to loading a NEW chunk this step?  Both
    arguments are ``(L,)`` inflight chunk ids, ``-1`` = idle."""
    return (new_inflight >= 0) & (new_inflight != prev_inflight)


def _interest(cc: CoopConsts, active, start, end, q_tab, done):
    """``(L, S, CH)`` pending interest and per-(stream, chunk) tuple
    overlap: a scan is interested in every not-yet-consumed chunk of its
    table that overlaps its range (``ScanState.chunks_remaining``)."""
    ov_lo = torch.maximum(cc.chunk_first, start.unsqueeze(2))
    ov_hi = torch.minimum(cc.chunk_last, end.unsqueeze(2))
    overlap = torch.clamp(ov_hi - ov_lo, min=0.0)
    in_range = (
        (overlap > 0.0)
        & (cc.chunk_table == q_tab.unsqueeze(2))
        & active.unsqueeze(2)
    )
    return in_range & ~done, overlap


def _by_chunk_col(cc: CoopConsts, mask):
    """``(L, P)`` page mask → ``(L, CH, C)`` "some masked page in this
    (chunk, column)"."""
    L = mask.shape[0]
    cnt = torch.zeros((L, cc.n_chunks * cc.n_cols), dtype=torch.int32,
                      device=mask.device)
    cnt.index_add_(1, cc.page_cc, mask.to(torch.int32))
    return (cnt > 0).view(L, cc.n_chunks, cc.n_cols)


def _at_pages(cc: CoopConsts, per_cc):
    """``(L, CH, C)`` → the ``(L, P)`` value of each page's (chunk, column)."""
    return per_cc.reshape(per_cc.shape[0], -1)[:, cc.page_cc]


def _chunk_missing(cc: CoopConsts, cols, resident, page_valid):
    """``(L, S, CH)`` "some page of my columns is absent": the complement
    of the ABM's chunk availability."""
    miss_cc = _by_chunk_col(cc, ~resident & page_valid)
    return (miss_cc.unsqueeze(1) & cols.unsqueeze(2)).any(dim=3)


def _streams_to_chunks(cc: CoopConsts, chunk, on, cols):
    """``(L, CH, C)``: the columns of the streams for which ``on`` holds,
    at the chunk each names (``chunk`` clamped into range)."""
    hit = (cc.chunk_ids == chunk.unsqueeze(2)) & on.unsqueeze(2)
    return (hit.unsqueeze(3) & cols.unsqueeze(2)).any(dim=1), hit


def cpu_phase(cc: CoopConsts, cstate: CoopState, *, active, start, end,
              cols, q_tab, rate_j, dt, credit_cap, resident,
              page_valid) -> CoopCpu:
    """One CPU step of every CScan: pick-if-idle (UseRelevance), consume,
    complete, chained for ``_PICK_ROUNDS`` rounds so the leftover budget
    of a completed chunk flows into the next one within the same step;
    any residue banks as capped credit.  Runs on the pre-advance view.
    ``dt`` is the ``(L, 1)`` step length."""
    CH = cc.n_chunks
    interest0, overlap = _interest(cc, active, start, end, q_tab,
                                   cstate.done)
    in_range = interest0 | cstate.done      # static within the step
    miss_sc = _chunk_missing(cc, cols, resident, page_valid)
    live = in_range & active.unsqueeze(2)
    zero = torch.zeros((), device=overlap.device)

    done = cstate.done
    cur = cstate.cur_chunk
    chunk_pos = cstate.chunk_pos
    budget = rate_j * dt + cstate.credit
    adv = torch.zeros_like(chunk_pos)
    consumed_any = torch.zeros_like(active)
    completed_cc = torch.zeros((cols.shape[0], CH, cc.n_cols),
                               dtype=torch.bool, device=cols.device)

    for _ in range(_PICK_ROUNDS):
        interest = live & ~done
        avail = interest & ~miss_sc
        count = interest.sum(dim=1)                          # (L, CH)
        # UseRelevance: the available chunk the FEWEST scans want, lowest
        # id on ties (one distinct key per chunk)
        pick_key = torch.where(
            avail, (count * (CH + 2) + cc.chunk_ids).unsqueeze(1),
            _PICK_BIG)
        pick = pick_key.amin(dim=2) % (CH + 2)
        started = (cur < 0) & avail.any(dim=2)
        cur = torch.where(started, pick, cur)
        chunk_pos = torch.where(started, zero, chunk_pos)

        consuming = cur >= 0
        ci = cur.clamp(0, CH - 1)
        cur_ov = overlap.gather(2, ci.unsqueeze(2)).squeeze(2)
        room = torch.clamp(cur_ov - chunk_pos, min=0.0)
        adv_t = torch.where(consuming, torch.minimum(budget, room), zero)
        budget = budget - adv_t
        pos_in = chunk_pos + adv_t
        completed = consuming & (
            pos_in >= cur_ov - torch.clamp(1e-6 * cur_ov, min=1e-3))
        consumed_any = consumed_any | (adv_t > 0.0) | completed
        cc_done, hit = _streams_to_chunks(cc, ci, completed, cols)
        done = done | hit
        completed_cc = completed_cc | cc_done
        adv = adv + torch.where(completed, cur_ov, zero)
        cur = torch.where(completed, -1, cur)
        chunk_pos = torch.where(completed, zero, pos_in)

    # bank the residue only for scans that did work and ended the step
    # between chunks: an idle (starved) scan accumulates nothing
    credit2 = torch.where(consumed_any & (cur < 0),
                          torch.minimum(budget, credit_cap), zero)
    # query completion: every interested chunk consumed
    finished = active & ~(live & ~done).any(dim=2)
    consumed_pages = _at_pages(cc, completed_cc) & page_valid
    # a chunk being consumed is pinned for its scan's columns
    pin_cc, _ = _streams_to_chunks(cc, cur.clamp(0, CH - 1), cur >= 0, cols)
    pin_pages = _at_pages(cc, pin_cc) & page_valid
    return CoopCpu(adv=adv, finished=finished,
                   consumed_pages=consumed_pages, pin_pages=pin_pages,
                   done=done, cur_chunk=cur, chunk_pos=chunk_pos,
                   credit=credit2)


def io_phase(cc: CoopConsts, *, done, cur_chunk, inflight, pin_pages,
             active, start, end, cols, q_tab, resident, free, page_size,
             page_valid) -> CoopIo:
    """ABM's next-load decision as one batched selection per lane.

    Runs on the post-advance view.  The Keep < Load rule is enforced
    twice: chunk selection requires enough bytes held at strictly lower
    interest counts (feasibility), and the evictable mask handed to the
    eviction kernel keeps only pages of chunks whose interest is below
    the inflight chunk's LoadRelevance.  ``free`` is ``(L,)`` f32,
    ``page_size`` the shared ``(P,)`` row."""
    CH = cc.n_chunks
    L, S = active.shape
    P = page_size.shape[0]
    dev = page_size.device
    interest, _ = _interest(cc, active, start, end, q_tab, done)
    miss_sc = _chunk_missing(cc, cols, resident, page_valid)
    avail = interest & ~miss_sc
    count = interest.sum(dim=1)                                # (L, CH)
    n_remaining = interest.sum(dim=2)                          # (L, S)
    starved = (active & (cur_chunk < 0) & (n_remaining > 0)
               & ~avail.any(dim=2))

    # union of the interested scans' columns per chunk: a chunk is loaded
    # once for everyone
    ucols = (interest.unsqueeze(3) & cols.unsqueeze(2)).any(dim=1)
    missing_p = ~resident & page_valid & _at_pages(cc, ucols)
    size64 = page_size.double()
    zero64 = torch.zeros((), dtype=torch.float64, device=dev)
    mb = torch.zeros((L, CH), dtype=torch.float64, device=dev).index_add_(
        1, cc.page_chunk, torch.where(missing_p, size64, zero64)).float()

    # Keep < Load feasibility: bytes resident in chunks whose interest
    # count is strictly below k, by a bytes-by-count histogram and its
    # prefix (counts are bounded by the stream count)
    count_p = count[:, cc.page_chunk]                          # (L, P)
    base_ev = resident & page_valid & ~pin_pages
    bb = torch.zeros((L, S + 2), dtype=torch.float64, device=dev)
    bb.scatter_add_(1, count_p.clamp(0, S + 1),
                    torch.where(base_ev, size64, zero64))
    below = torch.cat([torch.zeros((L, 1), dtype=torch.float64, device=dev),
                       torch.cumsum(bb, dim=1)], dim=1).float()
    feasible = free.unsqueeze(1) + below.gather(1, count.clamp(0, S + 1)) \
        >= mb

    # keep (or drop) the chunk in flight: it stays until fully resident
    # for the interested union, loses its interest, or turns infeasible
    infl_c = inflight.clamp(0, CH - 1).unsqueeze(1)
    still = (
        (inflight >= 0) & (mb.gather(1, infl_c).squeeze(1) > 0)
        & (count.gather(1, infl_c).squeeze(1) > 0)
        & feasible.gather(1, infl_c).squeeze(1)
    )
    inflight1 = torch.where(still, inflight, -1)

    # ABM next_load: the best query first (starved, then fewest chunks
    # remaining), then that query's best chunk (most interested scans,
    # lowest id): a lexicographic arg-max in masked reductions
    qkey_s = (torch.where(starved, 2048, 0)
              + (1023 - n_remaining.clamp(0, 1023)))           # (L, S)
    qbest = torch.where(interest, qkey_s.unsqueeze(2), _NEGI).amax(dim=1)
    loadable = (count > 0) & (mb > 0) & feasible
    qm = torch.where(loadable, qbest, _NEGI).amax(dim=1, keepdim=True)
    top_q = loadable & (qbest == qm)
    cm = torch.where(top_q, count, _NEGI).amax(dim=1, keepdim=True)
    sel_mask = top_q & (count == cm)
    sel = torch.where(sel_mask, cc.chunk_ids, CH).amin(dim=1)   # lowest id
    inflight2 = torch.where(
        inflight1 >= 0, inflight1,
        torch.where(sel_mask.any(dim=1), sel, -1))

    # the server's request set: missing pages of the inflight chunk in
    # page-index order (one chunk at a time: the serial ABM server)
    infl2_c = inflight2.clamp(0, CH - 1)
    loading = (inflight2 >= 0).unsqueeze(1)
    want_p = (cc.page_chunk == infl2_c.unsqueeze(1)) & loading & missing_p
    order = ((1 << 24) - torch.arange(P, device=dev)).to(torch.int32)
    load_key = torch.where(want_p, order, -1).to(torch.int32)

    # eviction view: only chunks with KeepRelevance strictly below the
    # inflight chunk's LoadRelevance may be evicted; fewest-interest
    # chunks go first, lowest chunk id on ties
    infl_count = torch.where(
        inflight2 >= 0, count.gather(1, infl2_c.unsqueeze(1)).squeeze(1), 0)
    evictable = base_ev & (count_p < infl_count.unsqueeze(1))
    keep_key = (S + 1.0 - count_p.float()) + cc.keep_tie
    return CoopIo(load_key=load_key, wanted=want_p, evictable=evictable,
                  keep_key=keep_key, inflight=inflight2, starved=starved)


def chunk_horizon(cc: CoopConsts, cstate: CoopState, hz):
    """``(L, S)`` event horizon of the cooperative model (seconds): a
    consuming scan's next interesting moment is its current chunk's
    completion; an idle active scan needs a fine step to run the pick
    loop; inactive streams contribute nothing (``inf``)."""
    ci = cstate.cur_chunk.clamp(0, cc.n_chunks - 1)
    ov = torch.clamp(
        torch.minimum(cc.chunk_last[ci], hz.end)
        - torch.maximum(cc.chunk_first[ci], hz.start),
        min=0.0)
    rem_c = torch.clamp(ov - cstate.chunk_pos, min=0.0)
    dt_ref = torch.full((), hz.dt_ref, device=ov.device)
    t = torch.where(cstate.cur_chunk >= 0,
                    rem_c / torch.clamp(hz.rate, min=1.0), dt_ref)
    return torch.where(hz.active, t, float("inf"))


def clear_on_query_change(done, finished):
    """A finished query's chunk flags reset: the next query registers a
    fresh ``chunks_remaining`` set."""
    return done & ~finished.unsqueeze(2)


def chunk_geometry(db, tnames, page_rows):
    """Compiler helper: global chunk ids for the compiled tables.

    Returns ``(n_chunks, chunk_first, chunk_last, chunk_table,
    page_chunk)`` where ``page_rows`` is the compiled page list as
    ``(table_index, first_tuple)`` pairs in global page order.  A page
    belongs to the chunk containing its first tuple ("one page contains
    data from multiple adjacent chunks" — unique ownership by first
    tuple).
    """
    chunk_first, chunk_last, chunk_table = [], [], []
    offs = []
    for ti, tname in enumerate(tnames):
        t = db.tables[tname]
        offs.append(len(chunk_first))
        for ch in range(t.n_chunks):
            lo, hi = t.chunk_range(ch)
            chunk_first.append(float(lo))
            chunk_last.append(float(hi))
            chunk_table.append(ti)
    page_chunk = np.zeros(len(page_rows), np.int32)
    for gi, (ti, first) in enumerate(page_rows):
        t = db.tables[tnames[ti]]
        local = min(int(first // t.chunk_tuples), t.n_chunks - 1)
        page_chunk[gi] = offs[ti] + local
    return (
        len(chunk_first),
        np.asarray(chunk_first, np.float32),
        np.asarray(chunk_last, np.float32),
        np.asarray(chunk_table, np.int32),
        page_chunk,
    )
