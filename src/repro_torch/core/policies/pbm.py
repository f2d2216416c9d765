"""Predictive Buffer Management — faithful implementation of paper §3 + Fig. 9.

PBM approximates Belady's OPT by *estimating the time of next consumption* of
every page from the disclosed page sets and observed positions/speeds of the
registered scans:

    PageNextConsumption(page) =
        min over (scan, tuples_behind) registered on the page of
            (tuples_behind - scan.tuples_consumed) / scan.speed

Pages are kept in a **bucketed timeline** rather than an exact priority queue
(the paper found a binary heap too expensive under concurrency):

* ``n_groups`` groups of ``m`` buckets; every bucket in group ``g`` spans
  ``2**g`` time slices, so ``n*m`` buckets cover an exponentially long
  horizon with O(1) ``TimeToBucketNumber``.
* A trailing **not-requested** bucket holds resident pages no active scan
  wants; it is kept in LRU order (paper's PBM/LRU hybrid for that bucket).
* Every ``time_slice`` the timeline shifts left one slice
  (``RefreshRequestedBuckets``): a bucket moves when ``slices_done`` is
  divisible by its length; a bucket shifted past position 0 is *spilled* —
  its pages get their priority recalculated and re-pushed (this is how
  stale speed estimates self-correct).
* Eviction pops from the not-requested bucket first, then from the
  highest-numbered (furthest-future) bucket — the Belady rule under
  estimation.

Deviations from the paper, recorded: (i) bucket collisions during shifting
are merged (the paper's pseudocode is ambiguous there; merging only blurs
priorities within one group transition, exactly the imprecision the bucket
design already accepts); (ii) eviction batching (>=16 pages) lives in the
engine so every policy is amortised identically.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional, Set, TYPE_CHECKING

from ..pages import Page, PageId
from .base import Policy

if TYPE_CHECKING:  # pragma: no cover
    from ..scans import ScanState

NOT_REQUESTED = -2
UNBUCKETED = -1


class _PageMeta:
    __slots__ = ("page", "consuming_scans", "bucket")

    def __init__(self, page: Page):
        self.page = page
        # scan_id -> tuples_behind (virtual tuples before consumption starts)
        self.consuming_scans: Dict[int, int] = {}
        self.bucket: int = UNBUCKETED


class PBMPolicy(Policy):
    name = "pbm"

    def __init__(
        self,
        time_slice: float = 0.1,   # paper example: 100 ms
        n_groups: int = 10,
        buckets_per_group: int = 4,
    ) -> None:
        super().__init__()
        self.time_slice = float(time_slice)
        self.n_groups = int(n_groups)
        self.m = int(buckets_per_group)
        self.nb = self.n_groups * self.m
        # requested buckets: index 0 = imminent, nb-1 = furthest future
        self.buckets: List["OrderedDict[PageId, Page]"] = [
            OrderedDict() for _ in range(self.nb)
        ]
        self.not_requested: "OrderedDict[PageId, Page]" = OrderedDict()  # LRU order
        self._meta: Dict[PageId, _PageMeta] = {}
        self._scans: Dict[int, "ScanState"] = {}
        self._scan_pages: Dict[int, List[Page]] = {}
        self._slices_done = 0      # slices since attach
        self._epoch = 0.0

    # ------------------------------------------------------------------ util
    def attach(self, pool, now: float = 0.0) -> None:  # noqa: D401
        super().attach(pool, now)
        self._epoch = now

    def _m(self, page: Page) -> _PageMeta:
        meta = self._meta.get(page.pid)
        if meta is None:
            meta = self._meta[page.pid] = _PageMeta(page)
        return meta

    def _bucket_len_slices(self, i: int) -> int:
        return 1 << (i // self.m)

    def time_to_bucket(self, dt: float) -> int:
        """O(1) TimeToBucketNumber (paper Fig. 10 geometry)."""
        if dt <= 0:
            return 0
        s = dt / self.time_slice
        # group g covers slice offsets [m*(2^g - 1), m*(2^(g+1) - 1))
        g = int(math.log2(s / self.m + 1.0))
        if g >= self.n_groups:
            return self.nb - 1
        start = self.m * ((1 << g) - 1)
        idx = int((s - start) / (1 << g))
        return min(self.nb - 1, g * self.m + idx)

    # --------------------------------------------------- Fig. 9 core functions
    def page_next_consumption(self, page: Page, now: float) -> Optional[float]:
        meta = self._meta.get(page.pid)
        if meta is None or not meta.consuming_scans:
            return None
        nearest: Optional[float] = None
        for sid, tuples_behind in meta.consuming_scans.items():
            scan = self._scans.get(sid)
            if scan is None:
                continue
            speed = max(scan.speed, 1e-6)
            nxt = (tuples_behind - scan.virt_pos) / speed
            if nxt < 0:
                nxt = 0.0
            if nearest is None or nxt < nearest:
                nearest = nxt
        return nearest

    def _bucket_remove(self, meta: _PageMeta) -> None:
        if meta.bucket == NOT_REQUESTED:
            self.not_requested.pop(meta.page.pid, None)
        elif meta.bucket >= 0:
            self.buckets[meta.bucket].pop(meta.page.pid, None)
        meta.bucket = UNBUCKETED

    def page_push(self, page: Page, now: float) -> None:
        """Recalculate a resident page's priority and (re)bucket it."""
        assert self.pool is not None
        meta = self._m(page)
        self._bucket_remove(meta)
        if not self.pool.is_resident(page):
            return
        nxt = self.page_next_consumption(page, now)
        if nxt is None:
            self.not_requested[page.pid] = page   # MRU end
            meta.bucket = NOT_REQUESTED
        else:
            b = self.time_to_bucket(nxt)
            self.buckets[b][page.pid] = page
            meta.bucket = b

    def refresh_requested_buckets(self, now: float) -> None:
        """Shift the timeline left; recalc pages spilled past position 0."""
        target = int((now - self._epoch) / self.time_slice)
        if target <= self._slices_done:
            return
        steps = target - self._slices_done
        if steps > 2 * self.nb * (1 << (self.n_groups - 1)):
            # long idle period: rebuild instead of stepping
            self._slices_done = target
            for b in list(self.buckets):
                for page in list(b.values()):
                    self.page_push(page, now)
            return
        for _ in range(steps):
            self._slices_done += 1
            spill: List[Page] = []
            new: List[Optional["OrderedDict[PageId, Page]"]] = [None] * self.nb
            for i in range(self.nb):
                moved = (self._slices_done % self._bucket_len_slices(i)) == 0
                dest = i - 1 if moved else i
                if dest < 0:
                    spill.extend(self.buckets[i].values())
                    continue
                if new[dest] is None:
                    new[dest] = self.buckets[i]
                else:
                    new[dest].update(self.buckets[i])  # merge on collision
            self.buckets = [b if b is not None else OrderedDict() for b in new]
            # fix meta.bucket for everything that moved
            for i, b in enumerate(self.buckets):
                for pid in b:
                    self._meta[pid].bucket = i
            for page in spill:
                self._meta[page.pid].bucket = UNBUCKETED
                self.page_push(page, now)

    # ------------------------------------------------------- policy interface
    def register_scan(self, scan: "ScanState", now: float) -> None:
        self._scans[scan.scan_id] = scan
        pages: List[Page] = []
        for trigger, page in scan.plan:
            meta = self._m(page)
            meta.consuming_scans[scan.scan_id] = trigger
            pages.append(page)
            if self.pool is not None and self.pool.is_resident(page):
                self.page_push(page, now)
        self._scan_pages[scan.scan_id] = pages

    def unregister_scan(self, scan: "ScanState", now: float) -> None:
        for page in self._scan_pages.pop(scan.scan_id, []):
            meta = self._meta.get(page.pid)
            if meta is None:
                continue
            if meta.consuming_scans.pop(scan.scan_id, None) is not None:
                if self.pool is not None and self.pool.is_resident(page):
                    self.page_push(page, now)
        self._scans.pop(scan.scan_id, None)

    def report_position(self, scan: "ScanState", now: float) -> None:
        # speed EWMA is maintained on the ScanState; the timeline self-corrects
        # through bucket refresh + spill recalculation.
        self.refresh_requested_buckets(now)

    def on_loaded(self, page: Page, now: float) -> None:
        self.refresh_requested_buckets(now)
        self.page_push(page, now)

    def on_consumed(self, scan: "ScanState", page: Page, now: float) -> None:
        meta = self._meta.get(page.pid)
        if meta is not None:
            meta.consuming_scans.pop(scan.scan_id, None)
        self.page_push(page, now)

    def choose_victims(
        self, bytes_needed: int, protected: Set[PageId], now: float
    ) -> List[Page]:
        assert self.pool is not None
        self.refresh_requested_buckets(now)
        victims: List[Page] = []
        freed = self.pool.free_bytes

        def try_take(bucket: "OrderedDict[PageId, Page]") -> None:
            nonlocal freed
            for pid in list(bucket.keys()):
                if freed >= bytes_needed:
                    return
                page = bucket[pid]
                if pid in protected or self.pool.is_pinned(page):
                    continue
                bucket.pop(pid)
                self._meta[pid].bucket = UNBUCKETED
                victims.append(page)
                freed += page.size_bytes

        try_take(self.not_requested)              # LRU order (front = oldest)
        i = self.nb - 1
        while freed < bytes_needed and i >= 0:    # furthest future first
            try_take(self.buckets[i])
            i -= 1
        return victims
