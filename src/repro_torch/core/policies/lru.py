"""LRU and MRU baselines — the "naive buffer management" of the paper.

LRU is the traditional default the paper benchmarks against; MRU is included
because classic DBMS buffer work (Chou & DeWitt) preferred MRU for looping
sequential scans — our benchmarks let you check that folklore against PBM.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Set, TYPE_CHECKING

from ..pages import Page, PageId
from .base import Policy

if TYPE_CHECKING:  # pragma: no cover
    from ..scans import ScanState


class LRUPolicy(Policy):
    name = "lru"

    def __init__(self) -> None:
        super().__init__()
        # OrderedDict as recency list: least-recently-used at the front.
        self._recency: "OrderedDict[PageId, Page]" = OrderedDict()

    def _touch(self, page: Page) -> None:
        self._recency.pop(page.pid, None)
        self._recency[page.pid] = page

    def on_loaded(self, page: Page, now: float) -> None:
        self._touch(page)

    def on_consumed(self, scan: "ScanState", page: Page, now: float) -> None:
        self._touch(page)

    def choose_victims(
        self, bytes_needed: int, protected: Set[PageId], now: float
    ) -> List[Page]:
        assert self.pool is not None
        victims: List[Page] = []
        freed = self.pool.free_bytes
        for pid in list(self._recency.keys()):
            if freed >= bytes_needed:
                break
            page = self.pool.resident.get(pid)
            if page is None:
                self._recency.pop(pid, None)  # stale entry
                continue
            if pid in protected or self.pool.is_pinned(page):
                continue
            victims.append(page)
            freed += page.size_bytes
        for v in victims:
            self._recency.pop(v.pid, None)
        return victims


class MRUPolicy(LRUPolicy):
    name = "mru"

    def choose_victims(
        self, bytes_needed: int, protected: Set[PageId], now: float
    ) -> List[Page]:
        assert self.pool is not None
        victims: List[Page] = []
        freed = self.pool.free_bytes
        for pid in reversed(list(self._recency.keys())):
            if freed >= bytes_needed:
                break
            page = self.pool.resident.get(pid)
            if page is None:
                self._recency.pop(pid, None)
                continue
            if pid in protected or self.pool.is_pinned(page):
                continue
            victims.append(page)
            freed += page.size_bytes
        for v in victims:
            self._recency.pop(v.pid, None)
        return victims
