"""Append snapshots and shared/local chunk detection (paper §2.1, Figs 5-7).

Bulk appends bypass PDTs: a storage snapshot is an array of page references
per column; appending creates new pages and a new (transaction-local)
snapshot sharing a prefix with its parent.  Commit promotes the local
snapshot to *master*.  Concurrent appenders conflict: only one can commit
(the paper proves all live snapshots share a single common prefix chain).

ABM exploits this: chunks made purely of pages that belong to >= 2 live
snapshots are **shared** (high reuse potential, load early / keep longer);
chunks whose pages belong to only one snapshot are **local** (load late,
use once).  A PDT *checkpoint* creates a brand-new page set — snapshots of
different table versions share nothing and are registered as distinct
tables inside ABM (cases (i)-(iv) in the paper).

The ML-side analogue is prompt-prefix sharing in the paged KV cache:
requests sharing a system-prompt prefix are transactions whose "snapshots"
share a page prefix; see ``repro_torch.serving.kv_cache``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

_snapshot_ids = itertools.count()


@dataclass
class Snapshot:
    """A storage snapshot: ordered page-id lists, one per column."""

    table: str
    pages: Dict[str, List[int]]  # column -> ordered page identifiers
    version: int = 0             # bumped by checkpoints (disjoint page sets)
    sid: int = field(default_factory=lambda: next(_snapshot_ids))

    def append(self, new_pages: Dict[str, List[int]]) -> "Snapshot":
        """Transaction-local snapshot: shares this one's prefix + new pages."""
        merged = {c: list(ps) for c, ps in self.pages.items()}
        for c, ps in new_pages.items():
            merged.setdefault(c, []).extend(ps)
        return Snapshot(table=self.table, pages=merged, version=self.version)

    def n_chunks(self, tuples_per_chunk_pages: int = 1) -> int:
        # Chunk granularity derived from the shortest column page list so a
        # chunk is well defined across all columns.
        return max(len(ps) for ps in self.pages.values()) if self.pages else 0

    def is_prefix_of(self, other: "Snapshot") -> bool:
        if self.version != other.version:
            return False
        for c, ps in self.pages.items():
            ops = other.pages.get(c, [])
            if len(ps) > len(ops) or ops[: len(ps)] != ps:
                return False
        return True

    def common_prefix_len(self, other: "Snapshot") -> Dict[str, int]:
        """Per-column length of the longest common page prefix."""
        if self.version != other.version:
            return {c: 0 for c in self.pages}
        out = {}
        for c, ps in self.pages.items():
            ops = other.pages.get(c, [])
            n = 0
            for a, b in zip(ps, ops):
                if a != b:
                    break
                n += 1
            out[c] = n
        return out


class SnapshotManager:
    """Tracks the master snapshot and commit conflicts for one table."""

    def __init__(self, master: Snapshot):
        self.master = master
        self._master_at_start: Dict[int, int] = {}  # txn -> master sid at start

    def begin(self, txn: int) -> Snapshot:
        self._master_at_start[txn] = self.master.sid
        return self.master

    def commit(self, txn: int, snapshot: Snapshot) -> bool:
        """Commit txn's (possibly appended) snapshot.

        Returns False (abort) if another appender committed since txn began —
        the paper: "only one of the concurrent transactions that applied
        Appends to its snapshot can commit".
        """
        started_on = self._master_at_start.pop(txn, None)
        if started_on is None:
            raise ValueError(f"unknown transaction {txn}")
        if snapshot.sid == self.master.sid or snapshot.version != self.master.version:
            # read-only txn, or checkpoint happened: nothing to promote
            return snapshot.sid == self.master.sid
        if started_on != self.master.sid:
            return False  # conflicting appender committed first -> abort
        self.master = snapshot
        return True

    def checkpoint(self, new_pages: Dict[str, List[int]]) -> Snapshot:
        """PDT checkpoint: brand-new page set, new version (paper Fig. 7)."""
        self.master = Snapshot(
            table=self.master.table,
            pages=new_pages,
            version=self.master.version + 1,
        )
        return self.master


def classify_chunks(
    live_snapshots: Sequence[Snapshot],
    chunk_pages: int = 1,
) -> Tuple[Set[int], Dict[int, Set[int]]]:
    """Shared/local chunk classification over live snapshots of one version.

    Returns ``(shared, local_by_snapshot)`` where chunk index ``i`` covers
    page positions ``[i*chunk_pages, (i+1)*chunk_pages)`` of every column.
    A chunk is **shared** iff *all* its pages in *all* columns belong to the
    snapshots of >= 2 live transactions (paper: "even after appending a
    single value to a table, its last chunk becomes local").
    """
    shared: Set[int] = set()
    local: Dict[int, Set[int]] = {}
    if not live_snapshots:
        return shared, local
    by_version: Dict[int, List[Snapshot]] = {}
    for s in live_snapshots:
        by_version.setdefault(s.version, []).append(s)

    for _version, snaps in by_version.items():
        # Longest prefix (in pages, per column) present in >= 2 snapshots.
        if len(snaps) >= 2:
            best: Optional[Dict[str, int]] = None
            for i in range(len(snaps)):
                for j in range(i + 1, len(snaps)):
                    cp = snaps[i].common_prefix_len(snaps[j])
                    score = min(cp.values()) if cp else 0
                    if best is None or score > (min(best.values()) if best else 0):
                        best = cp
            prefix = best or {}
        else:
            prefix = {c: 0 for c in snaps[0].pages}

        min_prefix_pages = min(prefix.values()) if prefix else 0
        n_shared_chunks = min_prefix_pages // chunk_pages
        shared.update(range(n_shared_chunks))
        for s in snaps:
            max_pages = max((len(ps) for ps in s.pages.values()), default=0)
            n_chunks = (max_pages + chunk_pages - 1) // chunk_pages
            local[s.sid] = set(range(n_shared_chunks, n_chunks))
    return shared, local
