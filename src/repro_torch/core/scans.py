"""Scan operators and their registration metadata (paper §2-3).

Two operator flavours exist, mirroring the paper:

* :class:`ScanSpec` / :class:`ScanState` — an **in-order** range scan.  Under
  LRU/PBM/OPT the scan issues page requests in physical order; the policy
  only decides eviction.  PBM receives ``register/report/unregister`` calls
  (paper Fig. 3) and estimates per-scan speed.
* Cooperative scans (CScan) reuse the same spec but consume **chunks
  out-of-order** as delivered by ABM (see ``policies/cscan.py``); the engine
  drives that protocol.

A scan over multiple ranges/columns is linearised into *virtual tuple
positions* (cumulative tuples over its ranges).  The **access plan** is the
sorted list of (trigger_virtual_tuple, page): the page must be resident
before the cursor crosses its trigger.  ``tuples_behind`` as used by PBM's
``RegisterScan`` (paper Fig. 9) is exactly the trigger.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .pages import Database, Page, Table

_scan_ids = itertools.count()


@dataclass
class ScanSpec:
    """Static description of a range scan: what data it will consume."""

    table: str
    columns: Tuple[str, ...]
    ranges: Tuple[Tuple[int, int], ...]  # half-open tuple ranges, sorted
    tuple_rate: float = 50e6             # tuples/sec of CPU processing
    stream: int = 0
    in_order_required: bool = False      # paper §2.3: order-preserving CScan

    @property
    def total_tuples(self) -> int:
        return sum(b - a for a, b in self.ranges)


class ScanState:
    """Runtime state of one scan operator inside the engine."""

    def __init__(self, spec: ScanSpec, db: Database):
        self.spec = spec
        self.scan_id = next(_scan_ids)
        self.table: Table = db.tables[spec.table]
        # ---- access plan (in-order mode) ----
        # (trigger, page): page must be resident before cursor crosses trigger
        self.plan: List[Tuple[int, Page]] = []
        # (trigger, end, page): cursor in [trigger, end) means page is in use
        self.plan_full: List[Tuple[int, int, Page]] = []
        base = 0
        for (a, b) in spec.ranges:
            for col in spec.columns:
                for p in self.table.columns[col].pages_for_range(a, b):
                    trigger = base + max(0, p.first_tuple - a)
                    end = base + min(b - a, p.last_tuple - a)
                    self.plan_full.append((trigger, max(end, trigger + 1), p))
            base += b - a
        self.plan_full.sort(
            key=lambda tp: (tp[0], tp[2].pid.column, tp[2].pid.index)
        )
        self.plan = [(t, p) for t, _, p in self.plan_full]
        self.total_tuples = spec.total_tuples
        self.unique_pages: Set[Page] = {p for _, p in self.plan}
        # ---- chunk interest (cooperative mode) ----
        self.chunks: Set[int] = set()
        for (a, b) in spec.ranges:
            self.chunks.update(self.table.chunks_for_range(a, b))
        self.chunks_remaining: Set[int] = set(self.chunks)
        # ---- cursor ----
        self.virt_pos: int = 0           # virtual tuples consumed so far
        self.plan_idx: int = 0           # next page in plan not yet consumed
        self.done: bool = False
        self.start_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        # ---- speed tracking (PBM) ----
        self.speed: float = spec.tuple_rate      # tuples/sec estimate (EWMA)
        self._last_report: Optional[Tuple[float, int]] = None

    # ---- helpers -----------------------------------------------------------
    def pages_with_trigger_in(self, lo: int, hi: int) -> List[Page]:
        """Pages whose trigger lies in [lo, hi) — prefetch window lookups."""
        out = []
        i = self.plan_idx
        while i < len(self.plan) and self.plan[i][0] < hi:
            if self.plan[i][0] >= lo:
                out.append(self.plan[i][1])
            i += 1
        return out

    def next_needed(self) -> Optional[Tuple[int, Page]]:
        if self.plan_idx < len(self.plan):
            return self.plan[self.plan_idx]
        return None

    def report_position(self, now: float, ewma: float = 0.3) -> None:
        """Update the EWMA speed estimate (PBM's ReportScanPosition)."""
        if self._last_report is not None:
            t0, p0 = self._last_report
            dt = now - t0
            if dt > 1e-9 and self.virt_pos > p0:
                inst = (self.virt_pos - p0) / dt
                self.speed = ewma * inst + (1 - ewma) * self.speed
        self._last_report = (now, self.virt_pos)

    def tuples_in_chunk(self, chunk_id: int) -> int:
        """Tuples of this scan's ranges that fall inside ``chunk_id``."""
        clo, chi = self.table.chunk_range(chunk_id)
        total = 0
        for (a, b) in self.spec.ranges:
            total += max(0, min(b, chi) - max(a, clo))
        return total

    def __repr__(self) -> str:
        return (
            f"Scan#{self.scan_id}({self.spec.table} cols={len(self.spec.columns)} "
            f"pos={self.virt_pos}/{self.total_tuples})"
        )
