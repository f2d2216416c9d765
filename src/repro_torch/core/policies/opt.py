"""OPT / Belady: the perfect-oracle bound (paper §3, §4 "OPT simulator").

Two artefacts, matching how the paper uses OPT:

* :class:`OraclePolicy` — an engine policy that evicts the resident page
  whose *exact* next consumption is furthest in the future.  Because
  in-order scans are deterministic, the distance of every registered scan to
  every page is exactly known — this is OPT restricted to the knowledge the
  paper grants it (registered queries only, no future queries), i.e. PBM
  with a perfect speed/position oracle.  Order of requests is preserved, so
  like the paper's OPT it bounds *order-preserving* policies and can lose to
  CScans (paper's "food for thought" footnote).

* :func:`simulate_belady` — the classic trace-driven Belady simulator: given
  a reference string (e.g. captured from a PBM engine run, exactly as the
  paper does) and a capacity, replay optimal eviction and report miss volume.
  Used for the paper's I/O-volume numbers and for optimality property tests.
"""

from __future__ import annotations

import heapq
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple, TYPE_CHECKING

from ..pages import Page, PageId
from .base import Policy

if TYPE_CHECKING:  # pragma: no cover
    from ..scans import ScanState


class OraclePolicy(Policy):
    """Belady eviction with exact next-consumption distances (time units)."""

    name = "opt"

    def __init__(self) -> None:
        super().__init__()
        self._page_scans: Dict[PageId, Dict[int, int]] = {}  # pid -> {scan: trigger}
        self._scans: Dict[int, "ScanState"] = {}
        self._lru: "OrderedDict[PageId, Page]" = OrderedDict()  # unreferenced pages

    def register_scan(self, scan: "ScanState", now: float) -> None:
        self._scans[scan.scan_id] = scan
        for trigger, page in scan.plan:
            self._page_scans.setdefault(page.pid, {})[scan.scan_id] = trigger

    def unregister_scan(self, scan: "ScanState", now: float) -> None:
        self._scans.pop(scan.scan_id, None)
        for _, page in scan.plan:
            d = self._page_scans.get(page.pid)
            if d is not None:
                d.pop(scan.scan_id, None)

    def on_loaded(self, page: Page, now: float) -> None:
        self._lru.pop(page.pid, None)
        self._lru[page.pid] = page

    def on_consumed(self, scan: "ScanState", page: Page, now: float) -> None:
        d = self._page_scans.get(page.pid)
        if d is not None:
            d.pop(scan.scan_id, None)
        self._lru.pop(page.pid, None)
        self._lru[page.pid] = page

    def _next_use(self, pid: PageId) -> Optional[float]:
        """Exact seconds until next consumption; None if unreferenced."""
        d = self._page_scans.get(pid)
        if not d:
            return None
        best: Optional[float] = None
        for sid, trigger in d.items():
            scan = self._scans.get(sid)
            if scan is None:
                continue
            dist = max(0, trigger - scan.virt_pos)
            t = dist / max(scan.spec.tuple_rate, 1e-9)
            if best is None or t < best:
                best = t
        return best

    def choose_victims(
        self, bytes_needed: int, protected: Set[PageId], now: float
    ) -> List[Page]:
        assert self.pool is not None
        victims: List[Page] = []
        freed = self.pool.free_bytes
        # 1. unreferenced pages in LRU order
        for pid in list(self._lru.keys()):
            if freed >= bytes_needed:
                break
            page = self.pool.resident.get(pid)
            if page is None:
                self._lru.pop(pid, None)
                continue
            if self._next_use(pid) is not None:
                self._lru.pop(pid, None)  # referenced again: not in LRU set
                continue
            if pid in protected or self.pool.is_pinned(page):
                continue
            victims.append(page)
            self._lru.pop(pid, None)
            freed += page.size_bytes
        if freed >= bytes_needed:
            return victims
        # 2. Belady: furthest exact next use first
        scored: List[Tuple[float, PageId, Page]] = []
        chosen = {v.pid for v in victims}
        for pid, page in self.pool.resident.items():
            if pid in protected or pid in chosen or self.pool.is_pinned(page):
                continue
            nxt = self._next_use(pid)
            scored.append((nxt if nxt is not None else float("inf"), pid, page))
        scored.sort(key=lambda t: (-t[0], repr(t[1])))
        for _, _pid, page in scored:
            if freed >= bytes_needed:
                break
            victims.append(page)
            freed += page.size_bytes
        return victims


def simulate_belady(
    trace: Sequence[PageId],
    capacity_pages: Optional[int] = None,
    page_sizes: Optional[Dict[PageId, int]] = None,
    capacity_bytes: Optional[int] = None,
) -> Tuple[int, int]:
    """Replay Belady's MIN on a reference trace.

    Returns ``(misses, missed_bytes)``.  With ``capacity_pages`` all pages
    count 1; with ``capacity_bytes`` + ``page_sizes`` eviction frees bytes.
    """
    if (capacity_pages is None) == (capacity_bytes is None):
        raise ValueError("give exactly one of capacity_pages / capacity_bytes")
    sizes = page_sizes or {}

    # next-use index lists per page (ascending); consumed from the front
    next_use: Dict[PageId, List[int]] = {}
    for i, pid in enumerate(trace):
        next_use.setdefault(pid, []).append(i)
    cursor: Dict[PageId, int] = {pid: 0 for pid in next_use}

    resident: Set[PageId] = set()
    used = 0
    cap = capacity_pages if capacity_pages is not None else capacity_bytes
    misses = 0
    missed_bytes = 0
    # lazy max-heap of (-next_use_index, key, pid); stale entries skipped
    heap: List[Tuple[int, str, PageId]] = []

    def size_of(pid: PageId) -> int:
        return 1 if capacity_pages is not None else sizes.get(pid, 1)

    def nxt_idx(pid: PageId, after: int) -> int:
        lst = next_use[pid]
        c = cursor[pid]
        while c < len(lst) and lst[c] <= after:
            c += 1
        cursor[pid] = c
        return lst[c] if c < len(lst) else 1 << 60

    for i, pid in enumerate(trace):
        sz = size_of(pid)
        if pid in resident:
            pass
        else:
            misses += 1
            missed_bytes += sz if capacity_bytes is not None else sizes.get(pid, 0)
            while used + sz > cap and resident:
                while heap:
                    negidx, _, vic = heapq.heappop(heap)
                    if vic in resident and -negidx == nxt_idx(vic, i):
                        break
                else:
                    vic = next(iter(resident))
                resident.discard(vic)
                used -= size_of(vic)
            if used + sz <= cap:
                resident.add(pid)
                used += sz
        if pid in resident:
            heapq.heappush(heap, (-nxt_idx(pid, i), repr(pid), pid))
    return misses, missed_bytes
