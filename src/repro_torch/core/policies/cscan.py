"""Cooperative Scans: the Active Buffer Manager (paper §2, after [Zukowski 07]).

ABM inverts the control flow of buffer management: loading decisions are
taken *globally* by ABM, not by individual scans.  CScan operators register
their data interest up front, then repeatedly ask ABM for *any* chunk of
their range that is ready (out-of-order, chunk-at-a-time delivery).  Four
relevance functions drive the scheduling (paper §2):

* ``QueryRelevance``  — which CScan to serve next: prioritise *starved*
  queries (no available cached chunk) and *short* queries.
* ``LoadRelevance``   — which chunk to load for it: favour chunks that many
  other CScans are interested in (maximise buffer reuse); shared chunks
  (snapshot common prefix, §2.1) get a bonus over local chunks.
* ``UseRelevance``    — which cached chunk the CScan should consume next:
  chunks *fewest* CScans are interested in, so they become evictable early.
* ``KeepRelevance``   — which chunk to evict: fewest interested CScans; a
  chunk is only evicted if it scores *lower* than the LoadRelevance of the
  chunk that wants its space.

Decisions are chunk-granular: a chunk is a logical tuple range that maps to
a different page set per column (``Table.chunk_pages``).  A chunk is
*available* to a CScan when all pages of the CScan's columns are resident.

A CScan may demand in-order delivery (``spec.in_order_required``) and then
degrades to a drop-in Scan replacement (paper §2.3).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple, TYPE_CHECKING

from ..pages import Database, Page, PageId, Table
from .base import BufferPool

if TYPE_CHECKING:  # pragma: no cover
    from ..scans import ScanState

ChunkKey = Tuple[str, int]  # (table, chunk_id)


@dataclass
class LoadDecision:
    chunk: ChunkKey
    pages: List[Page]          # non-resident pages to fetch
    bytes: int
    evict: List[Page]          # pages to drop first (whole victim chunks)


class ABM:
    """Active Buffer Manager: global chunk scheduling for CScan operators."""

    name = "cscan"

    def __init__(
        self,
        db: Database,
        pool: BufferPool,
        shared_chunks: Optional[Set[ChunkKey]] = None,
        starved_bonus: float = 1e9,
        shared_bonus: float = 0.5,
    ) -> None:
        self.db = db
        self.pool = pool
        self.shared_chunks = shared_chunks or set()
        self.starved_bonus = starved_bonus
        self.shared_bonus = shared_bonus
        # chunk -> scans that still need it (not yet consumed by them)
        self.interest: Dict[ChunkKey, Set[int]] = {}
        self._scans: Dict[int, "ScanState"] = {}
        # page -> owning chunk (by first_tuple); chunk -> pages per column
        self._page_chunk: Dict[PageId, ChunkKey] = {}
        self._chunk_pages: Dict[ChunkKey, Dict[str, List[Page]]] = {}
        self.in_flight: Set[ChunkKey] = set()
        self.pinned_chunks: Dict[ChunkKey, int] = {}

    # ------------------------------------------------------------- plumbing
    def _ensure_chunk_meta(self, table: Table, chunk_id: int) -> ChunkKey:
        key = (table.name, chunk_id)
        if key in self._chunk_pages:
            return key
        per_col: Dict[str, List[Page]] = {}
        lo, hi = table.chunk_range(chunk_id)
        for cname, col in table.columns.items():
            pages = [
                p
                for p in col.pages_for_range(lo, hi)
                if lo <= p.first_tuple < hi  # unique chunk ownership
            ]
            per_col[cname] = pages
            for p in pages:
                self._page_chunk[p.pid] = key
        self._chunk_pages[key] = per_col
        return key

    def chunk_pages_for_columns(
        self, key: ChunkKey, columns: Sequence[str]
    ) -> List[Page]:
        per_col = self._chunk_pages[key]
        out: List[Page] = []
        for c in columns:
            out.extend(per_col.get(c, []))
        return out

    def _interested_scans(self, key: ChunkKey) -> List["ScanState"]:
        return [
            self._scans[sid]
            for sid in self.interest.get(key, ())
            if sid in self._scans
        ]

    def _union_columns(self, key: ChunkKey) -> List[str]:
        cols: List[str] = []
        seen = set()
        for s in self._interested_scans(key):
            for c in s.spec.columns:
                if c not in seen:
                    seen.add(c)
                    cols.append(c)
        return cols

    def available_for(self, scan: "ScanState", chunk_id: int) -> bool:
        key = (scan.table.name, chunk_id)
        return all(self.pool.is_resident(p)
                   for p in self.chunk_pages_for_columns(key, scan.spec.columns))

    # ---------------------------------------------------------- registration
    def register(self, scan: "ScanState", now: float) -> None:
        self._scans[scan.scan_id] = scan
        for cid in scan.chunks_remaining:
            key = self._ensure_chunk_meta(scan.table, cid)
            self.interest.setdefault(key, set()).add(scan.scan_id)

    def unregister(self, scan: "ScanState", now: float) -> None:
        for cid in set(scan.chunks):
            key = (scan.table.name, cid)
            s = self.interest.get(key)
            if s is not None:
                s.discard(scan.scan_id)
        self._scans.pop(scan.scan_id, None)

    # ---------------------------------------------- relevance functions (§2)
    def query_relevance(self, scan: "ScanState", starved: bool) -> float:
        rel = -float(len(scan.chunks_remaining))       # short queries first
        if starved:
            rel += self.starved_bonus                  # starved queries first
        return rel

    def load_relevance(self, key: ChunkKey) -> float:
        rel = float(len(self.interest.get(key, ())))
        if key in self.shared_chunks:
            rel += self.shared_bonus                   # shared chunks early
        return rel

    def use_relevance(self, key: ChunkKey, scan: "ScanState") -> float:
        others = len(self.interest.get(key, ())) - 1
        return -float(others)                          # rare chunks first

    def keep_relevance(self, key: ChunkKey) -> float:
        rel = float(len(self.interest.get(key, ())))
        if key in self.shared_chunks:
            rel += self.shared_bonus
        return rel

    # --------------------------------------------------------- GetChunk path
    def get_chunk(self, scan: "ScanState", now: float) -> Optional[int]:
        """Pick the cached chunk the CScan should consume next (UseRelevance)."""
        if scan.spec.in_order_required:
            if not scan.chunks_remaining:
                return None
            nxt = min(scan.chunks_remaining)
            return nxt if self.available_for(scan, nxt) else None
        best: Optional[int] = None
        best_rel = -float("inf")
        for cid in scan.chunks_remaining:
            if not self.available_for(scan, cid):
                continue
            rel = self.use_relevance((scan.table.name, cid), scan)
            if rel > best_rel or (rel == best_rel and (best is None or cid < best)):
                best, best_rel = cid, rel
        return best

    def pin_chunk(self, scan: "ScanState", chunk_id: int) -> None:
        key = (scan.table.name, chunk_id)
        self.pinned_chunks[key] = self.pinned_chunks.get(key, 0) + 1
        for p in self.chunk_pages_for_columns(key, scan.spec.columns):
            self.pool.pin(p)

    def consume_chunk(self, scan: "ScanState", chunk_id: int, now: float) -> None:
        key = (scan.table.name, chunk_id)
        n = self.pinned_chunks.get(key, 0) - 1
        if n <= 0:
            self.pinned_chunks.pop(key, None)
        else:
            self.pinned_chunks[key] = n
        for p in self.chunk_pages_for_columns(key, scan.spec.columns):
            self.pool.unpin(p)
        scan.chunks_remaining.discard(chunk_id)
        s = self.interest.get(key)
        if s is not None:
            s.discard(scan.scan_id)

    # --------------------------------------------------------- loading path
    def _load_candidates(self, scan: "ScanState") -> List[ChunkKey]:
        if scan.spec.in_order_required:
            pend = [
                cid
                for cid in sorted(scan.chunks_remaining)
                if (scan.table.name, cid) not in self.in_flight
                and not self.available_for(scan, cid)
            ]
            return [(scan.table.name, pend[0])] if pend else []
        return [
            (scan.table.name, cid)
            for cid in scan.chunks_remaining
            if (scan.table.name, cid) not in self.in_flight
            and not self.available_for(scan, cid)
        ]

    def next_load(
        self, now: float, starved: Set[int], max_queries: int = 8
    ) -> Optional[LoadDecision]:
        """ABM main-loop decision: (query, chunk) to load next, with evictions."""
        cands = [
            (self.query_relevance(s, s.scan_id in starved), -s.scan_id, s)
            for s in self._scans.values()
            if s.chunks_remaining
        ]
        cands.sort(key=lambda t: (-t[0], t[1]))
        for _, _, scan in cands[:max_queries]:
            chunk_keys = self._load_candidates(scan)
            if not chunk_keys:
                continue
            chunk_keys.sort(
                key=lambda k: (-self.load_relevance(k), k[1])
            )
            key = chunk_keys[0]
            pages = [
                p
                for p in self.chunk_pages_for_columns(key, self._union_columns(key))
                if not self.pool.is_resident(p)
            ]
            if not pages:  # resident for union already (race) -> nothing to do
                continue
            need = sum(p.size_bytes for p in pages)
            evict = self._plan_eviction(key, need)
            if evict is None:
                continue  # cannot make room for this chunk; try next query
            return LoadDecision(chunk=key, pages=pages, bytes=need, evict=evict)
        return None

    def _plan_eviction(self, for_chunk: ChunkKey, need: int) -> Optional[List[Page]]:
        free = self.pool.free_bytes
        if free >= need:
            return []
        load_rel = self.load_relevance(for_chunk)
        # victim chunks: resident, unpinned, not in flight, lower relevance
        victims: List[Tuple[float, ChunkKey, List[Page], int]] = []
        for key, per_col in self._chunk_pages.items():
            if key == for_chunk or key in self.in_flight:
                continue
            if self.pinned_chunks.get(key, 0) > 0:
                continue
            resident = [
                p
                for pages in per_col.values()
                for p in pages
                if self.pool.is_resident(p) and not self.pool.is_pinned(p)
            ]
            if not resident:
                continue
            keep = self.keep_relevance(key)
            if keep >= load_rel:
                continue  # paper rule: only evict if Keep < Load
            victims.append((keep, key, resident, sum(p.size_bytes for p in resident)))
        victims.sort(key=lambda t: (t[0], t[1]))
        out: List[Page] = []
        for _keep, _key, pages, nbytes in victims:
            if free >= need:
                break
            out.extend(pages)
            free += nbytes
        return out if free >= need else None
