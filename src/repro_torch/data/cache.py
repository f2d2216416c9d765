"""Host page cache for the data pipeline, managed by the paper's policies.

Concurrent training/eval streams disclose their page access plans up front
(RegisterScan), report positions as they consume, and the cache evicts by
PBM / LRU / OPT — a live (wall-clock-driven) deployment of
``repro_torch.core``, not a simulation.  A copy of ``repro.data.cache``:
``clock`` (default the wall clock) is what a test injects to replay one
run in both packages.  The metric mirrors the paper: bytes re-read from slow
storage (cache miss volume) under concurrent streams.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.pages import PageId
from ..core.policies.base import BufferPool, Policy
from ..core.policies.lru import LRUPolicy
from ..core.policies.opt import OraclePolicy
from ..core.policies.pbm import PBMPolicy
from ..core.scans import ScanSpec, ScanState

from .dataset import PAGE_TOKENS, DatasetSpec, generate_page, make_dataset_db


def make_policy(name: str) -> Policy:
    return {
        "lru": LRUPolicy,
        "pbm": PBMPolicy,
        "opt": OraclePolicy,
    }[name]()


class HostPageCache:
    """Capacity-bounded page cache front-ending slow shard storage."""

    def __init__(
        self,
        spec: DatasetSpec,
        capacity_pages: int,
        policy: str = "pbm",
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        self.spec = spec
        self.db = make_dataset_db(spec)
        self.table = self.db.tables[spec.name]
        self.pool = BufferPool(
            capacity_bytes=capacity_pages * PAGE_TOKENS * 4
        )
        self.policy = make_policy(policy)
        self._clock = clock or time.monotonic
        self._t0 = self._clock()
        self.policy.attach(self.pool, 0.0)
        self._data: Dict[PageId, np.ndarray] = {}   # resident page payloads
        self.miss_pages = 0
        self.hit_pages = 0
        self._scans: Dict[int, ScanState] = {}

    def _now(self) -> float:
        return self._clock() - self._t0

    # ---- stream lifecycle (paper Fig. 3 API) --------------------------------
    def register_stream(
        self, shard_order: List[int], start_page: int = 0, end_page: Optional[int] = None
    ) -> int:
        """A stream discloses its full page plan: shards in order, pages
        sequential within each shard.  Returns a stream id."""
        end = end_page if end_page is not None else self.spec.pages_per_shard
        ranges = []
        cols = tuple(f"shard{s}" for s in shard_order)
        # one ScanState per shard keeps plans sequential per column; we fold
        # them into a single virtual scan over concatenated shard ranges.
        lo = start_page * PAGE_TOKENS
        hi = end * PAGE_TOKENS
        spec = ScanSpec(
            table=self.spec.name,
            columns=cols,
            ranges=((lo, hi),),
            tuple_rate=1.0,
        )
        scan = ScanState(spec, self.db)
        self._scans[scan.scan_id] = scan
        self.policy.register_scan(scan, self._now())
        return scan.scan_id

    def unregister_stream(self, stream_id: int) -> None:
        scan = self._scans.pop(stream_id, None)
        if scan is not None:
            self.policy.unregister_scan(scan, self._now())

    def report_position(self, stream_id: int, tokens_consumed: int) -> None:
        scan = self._scans.get(stream_id)
        if scan is None:
            return
        scan.virt_pos = tokens_consumed * len(scan.spec.columns)
        scan.report_position(self._now())
        self.policy.report_position(scan, self._now())

    # ---- the read path -------------------------------------------------------
    def get_page(self, stream_id: int, shard: int, page: int) -> np.ndarray:
        col = self.table.columns[f"shard{shard}"]
        pobj = col.pages[page]
        now = self._now()
        if self.pool.is_resident(pobj):
            self.hit_pages += 1
        else:
            self.miss_pages += 1
            need = pobj.size_bytes
            if self.pool.free_bytes < need:
                victims = self.policy.choose_victims(need, set(), now)
                for v in victims:
                    self.pool.evict(v)
                    self._data.pop(v.pid, None)
            self.pool.admit(pobj)
            self._data[pobj.pid] = generate_page(self.spec, shard, page)
            self.policy.on_loaded(pobj, now)
        scan = self._scans.get(stream_id)
        if scan is not None:
            self.policy.on_consumed(scan, pobj, now)
        return self._data[pobj.pid]

    @property
    def miss_bytes(self) -> int:
        return self.miss_pages * PAGE_TOKENS * 4
