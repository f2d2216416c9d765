"""Buffer pool and the policy interface shared by LRU/PBM/OPT (+ serving tier).

In-order policies (LRU, MRU, PBM, OPT oracle) plug into the engine through
this interface: the *engine* decides the request order (physical scan order +
prefetch); the *policy* decides eviction and maintains whatever metadata it
needs via the notification hooks.  Cooperative Scans instead take over the
loading decisions themselves (``cscan.py``), mirroring the paper's
architectural distinction between Fig. 1/3 (Scan + buffer manager) and
Fig. 2 (ABM).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, TYPE_CHECKING

from ..pages import Page, PageId

if TYPE_CHECKING:  # pragma: no cover
    from ..scans import ScanState


class BufferPool:
    """Fixed-capacity page pool; residency + pin accounting."""

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = int(capacity_bytes)
        self.used_bytes = 0
        self.resident: Dict[PageId, Page] = {}
        self.pinned: Dict[PageId, int] = {}
        self.total_loaded_bytes = 0   # lifetime I/O volume (the paper metric)
        self.total_loads = 0
        self.total_hits = 0
        self.total_evictions = 0

    def is_resident(self, page: Page) -> bool:
        return page.pid in self.resident

    def has_space(self, nbytes: int) -> bool:
        return self.used_bytes + nbytes <= self.capacity_bytes

    def admit(self, page: Page) -> None:
        if page.pid in self.resident:
            return
        if not self.has_space(page.size_bytes):
            raise RuntimeError(
                f"admit without space: {page.pid} needs {page.size_bytes}, "
                f"free={self.capacity_bytes - self.used_bytes}"
            )
        self.resident[page.pid] = page
        self.used_bytes += page.size_bytes
        self.total_loaded_bytes += page.size_bytes
        self.total_loads += 1

    def evict(self, page: Page) -> None:
        if self.pinned.get(page.pid, 0) > 0:
            raise RuntimeError(f"evicting pinned page {page.pid}")
        p = self.resident.pop(page.pid, None)
        if p is not None:
            self.used_bytes -= p.size_bytes
            self.total_evictions += 1

    def pin(self, page: Page) -> None:
        self.pinned[page.pid] = self.pinned.get(page.pid, 0) + 1

    def unpin(self, page: Page) -> None:
        n = self.pinned.get(page.pid, 0) - 1
        if n <= 0:
            self.pinned.pop(page.pid, None)
        else:
            self.pinned[page.pid] = n

    def is_pinned(self, page: Page) -> bool:
        return self.pinned.get(page.pid, 0) > 0

    @property
    def free_bytes(self) -> int:
        return self.capacity_bytes - self.used_bytes


class Policy:
    """Eviction-policy interface for in-order scans."""

    name = "base"

    def __init__(self) -> None:
        self.pool: Optional[BufferPool] = None

    def attach(self, pool: BufferPool, now: float = 0.0) -> None:
        self.pool = pool

    # -- scan lifecycle (PBM Fig. 3: Register/Report/Unregister) -------------
    def register_scan(self, scan: "ScanState", now: float) -> None:  # noqa: D401
        pass

    def unregister_scan(self, scan: "ScanState", now: float) -> None:
        pass

    def report_position(self, scan: "ScanState", now: float) -> None:
        pass

    # -- page lifecycle -------------------------------------------------------
    def on_loaded(self, page: Page, now: float) -> None:
        pass

    def on_consumed(self, scan: "ScanState", page: Page, now: float) -> None:
        pass

    # -- the actual decision --------------------------------------------------
    def choose_victims(
        self, bytes_needed: int, protected: Set[PageId], now: float
    ) -> List[Page]:
        """Pick resident pages to evict so ``bytes_needed`` fits.

        Must return pages summing to >= bytes_needed - pool.free_bytes (or as
        many as it can); engine raises if the policy cannot make room.
        """
        raise NotImplementedError
