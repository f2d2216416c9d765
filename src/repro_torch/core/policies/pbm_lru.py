"""PBM/LRU with counter-rotating buckets — the paper's §3 future work, built.

Basic PBM treats every page without an active scan as strictly colder than
any requested page; frequently-reused small-table (dimension) pages get
evicted between the short queries that love them.  The paper sketches the
fix: **two** bucket timelines,

* the PBM buckets (registered scans), shifting *left* as time passes, and
* LRU buckets (no active scan), placed by a *history-based* estimate of next
  consumption and shifting *right* (aging),

with eviction taking the furthest-future bucket of either set, preferring
the LRU side at equal range.  The history estimate is the paper's own
suggestion: keep the timestamps of the last ``k`` uses and take the average
gap as the predicted re-reference distance.

This is a beyond-paper deliverable: the paper explicitly leaves it
unimplemented ("We leave implementation of this algorithm as future work").
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Set, TYPE_CHECKING

from ..pages import Page, PageId
from .pbm import PBMPolicy, NOT_REQUESTED, UNBUCKETED

if TYPE_CHECKING:  # pragma: no cover
    from ..scans import ScanState

_HISTORY = 4  # paper: "timestamps of the last four uses"


class PBMLRUPolicy(PBMPolicy):
    name = "pbm_lru"

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        # mirror timeline for unrequested pages (aging moves them right)
        self.lru_buckets: List["OrderedDict[PageId, Page]"] = [
            OrderedDict() for _ in range(self.nb)
        ]
        self._lru_pos: Dict[PageId, int] = {}
        self._history: Dict[PageId, Deque[float]] = {}
        self._lru_slices_done = 0

    # ---- history-based next-consumption estimate ---------------------------
    def _history_estimate(self, pid: PageId, now: float) -> Optional[float]:
        h = self._history.get(pid)
        if not h or len(h) < 2:
            return None
        gaps = [b - a for a, b in zip(h, list(h)[1:])]
        avg = sum(gaps) / len(gaps)
        since = now - h[-1]
        return max(0.0, avg - since)

    def _record_use(self, pid: PageId, now: float) -> None:
        h = self._history.setdefault(pid, deque(maxlen=_HISTORY))
        h.append(now)

    # ---- override the "not requested" path ---------------------------------
    def page_push(self, page: Page, now: float) -> None:
        assert self.pool is not None
        meta = self._m(page)
        # remove from LRU mirror if present
        pos = self._lru_pos.pop(page.pid, None)
        if pos is not None:
            self.lru_buckets[pos].pop(page.pid, None)
        self._bucket_remove(meta)
        if not self.pool.is_resident(page):
            return
        nxt = self.page_next_consumption(page, now)
        if nxt is not None:
            b = self.time_to_bucket(nxt)
            self.buckets[b][page.pid] = page
            meta.bucket = b
            return
        est = self._history_estimate(page.pid, now)
        if est is None:
            self.not_requested[page.pid] = page  # no history: plain LRU tail
            meta.bucket = NOT_REQUESTED
        else:
            b = self.time_to_bucket(est)
            self.lru_buckets[b][page.pid] = page
            self._lru_pos[page.pid] = b
            meta.bucket = UNBUCKETED  # tracked by the mirror instead

    def on_consumed(self, scan: "ScanState", page: Page, now: float) -> None:
        self._record_use(page.pid, now)
        super().on_consumed(scan, page, now)

    def refresh_requested_buckets(self, now: float) -> None:
        before = self._slices_done
        super().refresh_requested_buckets(now)
        steps = self._slices_done - before
        # counter-rotation: age the LRU mirror to the *right*
        for _ in range(steps):
            self._lru_slices_done += 1
            for i in range(self.nb - 1, -1, -1):
                if self._lru_slices_done % self._bucket_len_slices(i) != 0:
                    continue
                src = self.lru_buckets[i]
                if not src:
                    continue
                if i == self.nb - 1:
                    continue  # oldest stays (next eviction candidates)
                self.lru_buckets[i + 1].update(src)
                for pid in src:
                    self._lru_pos[pid] = i + 1
                self.lru_buckets[i] = OrderedDict()

    def choose_victims(
        self, bytes_needed: int, protected: Set[PageId], now: float
    ) -> List[Page]:
        assert self.pool is not None
        self.refresh_requested_buckets(now)
        victims: List[Page] = []
        freed = self.pool.free_bytes

        def take(bucket: "OrderedDict[PageId, Page]", lru_side: bool) -> None:
            nonlocal freed
            for pid in list(bucket.keys()):
                if freed >= bytes_needed:
                    return
                page = bucket[pid]
                if pid in protected or self.pool.is_pinned(page):
                    continue
                bucket.pop(pid)
                if lru_side:
                    self._lru_pos.pop(pid, None)
                else:
                    self._meta[pid].bucket = UNBUCKETED
                victims.append(page)
                freed += page.size_bytes

        take(self.not_requested, lru_side=False)
        # walk both timelines from the far-future end, LRU side first
        i = self.nb - 1
        while freed < bytes_needed and i >= 0:
            take(self.lru_buckets[i], lru_side=True)
            if freed < bytes_needed:
                take(self.buckets[i], lru_side=False)
            i -= 1
        return victims
