"""Discrete-event engine for concurrent scans over a bandwidth-limited device.

Reproduces the paper's experimental machine abstractly:

* **CPU**: every scan processes tuples at ``spec.tuple_rate`` (the paper
  maxes out 8 threads/query; we fold parallel speedup into the rate).  A
  scan runs in *segments*: it consumes forward while the pages it needs are
  resident, pinning the in-use pages, then blocks on the first miss.
* **I/O**: a single bandwidth-limited server (the paper throttles page
  delivery from storage to the buffer manager exactly this way to simulate
  200 MB/s – 2 GB/s subsystems).  In-order mode services a FIFO of page
  requests (demand + readahead); cooperative mode services ABM chunk loads.
* **Buffer pool**: fixed capacity; eviction by the plugged policy
  (LRU/MRU/PBM/OPT) or by ABM's KeepRelevance (CScans).

Metrics match the paper: average stream time, total I/O volume, and the
sharing-potential sampling of Figs 17/18.  With ``record_trace`` the page
reference string is captured so Belady's MIN can be replayed on it — the
paper's OPT methodology.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .pages import Database, Page, PageId
from .policies.base import BufferPool, Policy
from .policies.cscan import ABM, LoadDecision
from .scans import ScanSpec, ScanState


@dataclass
class EngineConfig:
    bandwidth: float = 700e6          # bytes/sec (paper default 700 MB/s)
    buffer_bytes: int = 620 << 20     # 40% of the microbenchmark working set
    prefetch_pages: int = 8           # per-scan readahead (in-order mode)
    segment_pages: int = 2            # pages pinned per CPU burst
    evict_batch_pages: int = 16       # paper: evictions amortised in groups
    sample_interval: float = 1.0      # sharing-potential sampling period
    record_trace: bool = False
    max_sim_time: float = 3e5
    # PBM bucket timeline resolution (paper: 100ms). Must be well below a
    # typical query duration or every page lands in bucket 0 — scale it
    # down together with the workload in reduced-scale runs.
    pbm_time_slice: float = 0.1


@dataclass
class EngineResult:
    policy: str
    stream_times: List[float]
    query_latencies: List[float]
    total_io_bytes: int
    total_hits: int
    total_loads: int
    sim_time: float
    total_evictions: int = 0
    sharing_samples: List[Dict[int, int]] = field(default_factory=list)
    trace: List[PageId] = field(default_factory=list)
    page_sizes: Dict[PageId, int] = field(default_factory=dict)

    @property
    def avg_stream_time(self) -> float:
        return sum(self.stream_times) / max(1, len(self.stream_times))

    @property
    def io_gb(self) -> float:
        return self.total_io_bytes / 1e9


# event kinds
_IO_DONE = 0
_CPU_DONE = 1
_SAMPLE = 2


class Engine:
    def __init__(
        self,
        db: Database,
        policy: Optional[Policy],
        config: EngineConfig,
        cooperative: bool = False,
    ) -> None:
        self.db = db
        self.cfg = config
        self.cooperative = cooperative
        self.pool = BufferPool(config.buffer_bytes)
        self.policy = policy
        if policy is not None:
            policy.attach(self.pool, 0.0)
        self.abm: Optional[ABM] = ABM(db, self.pool) if cooperative else None

        self._events: List[Tuple[float, int, int, object]] = []
        self._seq = itertools.count()
        self.now = 0.0
        # streams
        self._streams: List[List[ScanSpec]] = []
        self._stream_pos: List[int] = []
        self._stream_start: List[float] = []
        self._stream_done_t: List[Optional[float]] = []
        self._active: Dict[int, ScanState] = {}   # scan_id -> state
        self._scan_stream: Dict[int, int] = {}
        self._scan_running: Set[int] = set()      # has a CPU event in flight
        self._scan_pinned: Dict[int, List[Page]] = {}
        self._query_start: Dict[int, float] = {}
        self.query_latencies: List[float] = []
        # in-order I/O queue
        self._io_queue: List[Tuple[int, Page]] = []   # (seq, page) FIFO
        self._io_queued: Dict[PageId, Set[int]] = {}  # pid -> waiting scan ids
        self._io_busy = False
        self._blocked_on: Dict[PageId, Set[int]] = {}
        self._starved: Set[int] = set()               # cooperative mode
        # metrics
        self._interest_count: Dict[PageId, int] = {}
        self.sharing_samples: List[Dict[int, int]] = []
        self.trace: List[PageId] = []
        self._page_sizes: Dict[PageId, int] = {}

    # ------------------------------------------------------------- plumbing
    def _push(self, t: float, kind: int, payload: object) -> None:
        heapq.heappush(self._events, (t, kind, next(self._seq), payload))

    def add_stream(self, specs: Sequence[ScanSpec]) -> int:
        sid = len(self._streams)
        self._streams.append(list(specs))
        self._stream_pos.append(0)
        self._stream_start.append(0.0)
        self._stream_done_t.append(None)
        return sid

    # ------------------------------------------------------------------ run
    def run(self) -> EngineResult:
        for sid in range(len(self._streams)):
            self._submit_next(sid)
        if self.cfg.sample_interval > 0:
            self._push(self.cfg.sample_interval, _SAMPLE, None)
        self._kick_io()
        while self._events:
            t, kind, _, payload = heapq.heappop(self._events)
            if t > self.cfg.max_sim_time:
                raise RuntimeError("simulation exceeded max_sim_time (livelock?)")
            self.now = t
            if kind == _IO_DONE:
                self._on_io_done(payload)
            elif kind == _CPU_DONE:
                self._on_cpu_done(payload)
            elif kind == _SAMPLE:
                self._on_sample()
            if self._all_done():
                break
        stream_times = [
            (d if d is not None else self.now) - s
            for s, d in zip(self._stream_start, self._stream_done_t)
        ]
        return EngineResult(
            policy=(self.abm.name if self.abm else self.policy.name),
            stream_times=stream_times,
            query_latencies=self.query_latencies,
            total_io_bytes=self.pool.total_loaded_bytes,
            total_hits=self.pool.total_hits,
            total_loads=self.pool.total_loads,
            sim_time=self.now,
            total_evictions=self.pool.total_evictions,
            sharing_samples=self.sharing_samples,
            trace=self.trace,
            page_sizes=self._page_sizes,
        )

    def _all_done(self) -> bool:
        return not self._active and all(
            p >= len(s) for p, s in zip(self._stream_pos, self._streams)
        )

    # ------------------------------------------------------ stream lifecycle
    def _submit_next(self, stream: int) -> None:
        pos = self._stream_pos[stream]
        if pos >= len(self._streams[stream]):
            if self._stream_done_t[stream] is None and not any(
                st for st in self._active.values() if self._scan_stream[st.scan_id] == stream
            ):
                self._stream_done_t[stream] = self.now
            return
        self._stream_pos[stream] = pos + 1
        spec = self._streams[stream][pos]
        scan = ScanState(spec, self.db)
        scan.start_time = self.now
        self._active[scan.scan_id] = scan
        self._scan_stream[scan.scan_id] = stream
        self._query_start[scan.scan_id] = self.now
        for _, p in scan.plan:
            self._interest_count[p.pid] = self._interest_count.get(p.pid, 0) + 1
            self._page_sizes.setdefault(p.pid, p.size_bytes)
        if self.cooperative:
            assert self.abm is not None
            self.abm.register(scan, self.now)
            self._try_consume_chunk(scan)
        else:
            assert self.policy is not None
            self.policy.register_scan(scan, self.now)
            self._try_run(scan)
        self._kick_io()

    def _finish_scan(self, scan: ScanState) -> None:
        scan.done = True
        scan.finish_time = self.now
        self.query_latencies.append(self.now - self._query_start[scan.scan_id])
        if self.cooperative:
            self.abm.unregister(scan, self.now)
            self._starved.discard(scan.scan_id)
        else:
            self.policy.unregister_scan(scan, self.now)
        stream = self._scan_stream[scan.scan_id]
        del self._active[scan.scan_id]
        self._submit_next(stream)

    # ==================================================== in-order mode =====
    def _try_run(self, scan: ScanState) -> None:
        if scan.done or scan.scan_id in self._scan_running:
            return
        plan = scan.plan_full
        n = len(plan)
        i = scan.plan_idx
        if i >= n and scan.virt_pos >= scan.total_tuples:
            self._finish_scan(scan)
            return
        # One forward walk: consume while resident, stop at the first miss or
        # once the segment budget is exhausted at a strictly later trigger
        # (pages sharing one trigger are taken together or not at all).
        taken: List[Page] = []
        k = i
        t_end = scan.total_tuples
        blocking: Optional[Page] = None
        while k < n:
            trg, _, page = plan[k]
            if not self.pool.is_resident(page):
                t_end = trg
                blocking = page
                break
            if len(taken) >= self.cfg.segment_pages and trg > plan[k - 1][0]:
                t_end = trg
                break
            taken.append(page)
            k += 1
        # never consume a page whose trigger is at/after the segment end
        while taken and plan[k - 1][0] >= t_end:
            k -= 1
            taken.pop()
        if t_end <= scan.virt_pos:
            assert blocking is not None
            self._block_on(scan, blocking)
            return
        pinned: List[Page] = []
        for page in taken:
            self.pool.pin(page)
            pinned.append(page)
        self._scan_pinned[scan.scan_id] = pinned
        self._scan_running.add(scan.scan_id)
        rate = scan.spec.tuple_rate
        throttle = getattr(self.policy, "throttle_factor", None)
        if throttle is not None:
            rate *= throttle(scan, self.now)  # Attach&Throttle (paper §5)
        dt = (t_end - scan.virt_pos) / max(rate, 1e-9)
        self._push(self.now + dt, _CPU_DONE, (scan.scan_id, k, t_end))
        # readahead for the *next* misses
        self._issue_prefetch(scan, k)

    def _block_on(self, scan: ScanState, page: Page) -> None:
        self._blocked_on.setdefault(page.pid, set()).add(scan.scan_id)
        self._request_page(scan, page)
        self._issue_prefetch(scan, scan.plan_idx + 1)
        self._kick_io()

    def _issue_prefetch(self, scan: ScanState, from_idx: int) -> None:
        upto = min(len(scan.plan), from_idx + self.cfg.prefetch_pages)
        for j in range(from_idx, upto):
            page = scan.plan[j][1]
            if not self.pool.is_resident(page):
                self._request_page(scan, page)
        self._kick_io()

    def _request_page(self, scan: ScanState, page: Page) -> None:
        if self.pool.is_resident(page):
            self.pool.total_hits += 1
            return
        waiters = self._io_queued.get(page.pid)
        if waiters is not None:
            waiters.add(scan.scan_id)
            return
        self._io_queued[page.pid] = {scan.scan_id}
        self._io_queue.append((next(self._seq), page))

    def _on_cpu_done(self, payload: Tuple[int, int, int]) -> None:
        scan_id, new_idx, t_end = payload
        scan = self._active.get(scan_id)
        self._scan_running.discard(scan_id)
        if scan is None:
            return
        if self.cooperative:
            self._on_cpu_done_coop(scan, new_idx)  # new_idx carries chunk_id
            return
        for page in self._scan_pinned.pop(scan_id, []):
            self.pool.unpin(page)
        # consume pages passed
        for j in range(scan.plan_idx, new_idx):
            trigger, page = scan.plan[j]
            if self.cfg.record_trace:
                self.trace.append(page.pid)
            c = self._interest_count.get(page.pid, 0)
            if c > 0:
                self._interest_count[page.pid] = c - 1
            self.policy.on_consumed(scan, page, self.now)
        scan.plan_idx = new_idx
        scan.virt_pos = t_end
        scan.report_position(self.now)
        self.policy.report_position(scan, self.now)
        if scan.plan_idx >= len(scan.plan) and scan.virt_pos >= scan.total_tuples:
            self._finish_scan(scan)
        else:
            self._try_run(scan)
        self._kick_io()

    # ------------------------------------------------------------- I/O path
    def _kick_io(self) -> None:
        if self._io_busy:
            return
        if self.cooperative:
            self._kick_io_coop()
            return
        requeued = 0
        while self._io_queue:
            _, page = self._io_queue.pop(0)
            waiters = self._io_queued.pop(page.pid, set())
            if self.pool.is_resident(page):
                continue  # already loaded meanwhile
            if not any(w in self._active for w in waiters):
                continue  # everyone who wanted it is gone
            need = page.size_bytes
            if self.pool.free_bytes < need:
                batch = max(need, self.cfg.evict_batch_pages * page.size_bytes)
                batch = min(batch, self.pool.capacity_bytes)
                victims = self.policy.choose_victims(batch, set(), self.now)
                freed = self.pool.free_bytes + sum(v.size_bytes for v in victims)
                if freed < need:
                    # cannot make room now (pins): requeue and stall
                    self._io_queued[page.pid] = waiters
                    self._io_queue.append((next(self._seq), page))
                    requeued += 1
                    if requeued >= len(self._io_queue):
                        return  # full pass without progress; wait for unpin
                    continue
                for v in victims:
                    self.pool.evict(v)
            self._io_busy = True
            dt = page.size_bytes / self.cfg.bandwidth
            # payload carries the pages: _kick_io may be re-entered from the
            # wake path before this event is handled, so no shared slot.
            self._push(self.now + dt, _IO_DONE, [page])
            return

    def _on_io_done(self, payload: object) -> None:
        self._io_busy = False
        if self.cooperative:
            self._on_io_done_coop(payload)
            return
        for page in payload:  # type: ignore[union-attr]
            self.pool.admit(page)
            self.policy.on_loaded(page, self.now)
            # sorted: wake order must not depend on absolute scan-id values
            # (set iteration order over ints does), or results drift with
            # the global id counter
            for sid in sorted(self._blocked_on.pop(page.pid, set())):
                scan = self._active.get(sid)
                if scan is not None:
                    self._try_run(scan)
        self._kick_io()

    # =================================================== cooperative mode ===
    def _try_consume_chunk(self, scan: ScanState) -> None:
        if scan.done or scan.scan_id in self._scan_running:
            return
        assert self.abm is not None
        if not scan.chunks_remaining:
            self._finish_scan(scan)
            return
        cid = self.abm.get_chunk(scan, self.now)
        if cid is None:
            self._starved.add(scan.scan_id)
            return
        self._starved.discard(scan.scan_id)
        self.abm.pin_chunk(scan, cid)
        self._scan_running.add(scan.scan_id)
        tuples = max(1, scan.tuples_in_chunk(cid))
        dt = tuples / max(scan.spec.tuple_rate, 1e-9)
        self._push(self.now + dt, _CPU_DONE, (scan.scan_id, cid, -1))

    def _kick_io_coop(self) -> None:
        assert self.abm is not None
        decision = self.abm.next_load(self.now, self._starved)
        if decision is None:
            return
        for v in decision.evict:
            self.pool.evict(v)
        self.abm.in_flight.add(decision.chunk)
        self._io_busy = True
        dt = decision.bytes / self.cfg.bandwidth
        self._push(self.now + dt, _IO_DONE, decision)

    def _on_io_done_coop(self, decision: LoadDecision) -> None:
        assert self.abm is not None
        for page in decision.pages:
            self.pool.admit(page)
        self.abm.in_flight.discard(decision.chunk)
        for scan in list(self._active.values()):
            if scan.scan_id in self._starved:
                self._try_consume_chunk(scan)
        self._kick_io()

    def _on_cpu_done_coop(self, scan: ScanState, chunk_id: int) -> None:
        assert self.abm is not None
        self.abm.consume_chunk(scan, chunk_id, self.now)
        # account consumed pages (trace + interest)
        key = (scan.table.name, chunk_id)
        for page in self.abm.chunk_pages_for_columns(key, scan.spec.columns):
            if self.cfg.record_trace:
                self.trace.append(page.pid)
            c = self._interest_count.get(page.pid, 0)
            if c > 0:
                self._interest_count[page.pid] = c - 1
        tuples = scan.tuples_in_chunk(chunk_id)
        scan.virt_pos += tuples
        scan.report_position(self.now)
        if not scan.chunks_remaining:
            self._finish_scan(scan)
        else:
            self._try_consume_chunk(scan)
        self._kick_io()

    # --------------------------------------------------------------- sampling
    def _on_sample(self) -> None:
        hist: Dict[int, int] = {}
        for pid, cnt in self._interest_count.items():
            if cnt > 0:
                size = self._page_sizes.get(pid, 0)
                hist[cnt] = hist.get(cnt, 0) + size
        self.sharing_samples.append(hist)
        if not self._all_done():
            self._push(self.now + self.cfg.sample_interval, _SAMPLE, None)


def run_workload(
    db: Database,
    streams: Sequence[Sequence[ScanSpec]],
    policy_name: str,
    config: EngineConfig,
    policy_factory: Optional[Callable[[], Policy]] = None,
) -> EngineResult:
    """Build an engine for ``policy_name`` and run the streams to
    completion.  Names resolve through ``repro_torch.core.policy_registry`` —
    the single policy table shared with the array backend; unknown names
    fail there with the registered-name list.  ``policy_factory``
    overrides the registry's construction (custom/parameterised
    policies)."""
    from . import policy_registry

    if policy_factory is not None:
        cooperative = policy_registry.get(policy_name).cooperative \
            if policy_name in policy_registry.names() else False
        policy: Optional[Policy] = policy_factory()
    else:
        policy, cooperative = policy_registry.event_policy(
            policy_name, config)
    eng = Engine(db, policy, config, cooperative=cooperative)
    for s in streams:
        eng.add_stream(s)
    return eng.run()
