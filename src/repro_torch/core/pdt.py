"""PDT-lite: positional delta trees and SID/RID translation (paper §2.1).

Vectorwise handles updates with in-memory Positional Delta Trees; scans read
stale columnar data and merge PDT differences on the fly.  The paper's CScan
integration hinges on translating between

* **SID** (Stable ID) — 0-based dense enumeration of tuples in stable storage,
* **RID** (Row ID)    — 0-based dense enumeration of the *visible* stream
  (after applying inserts/deletes).

Key properties reproduced here, straight from the paper:

* RID→SID is **not injective** (all inserts anchored before a stable tuple map
  to that tuple's SID), hence two inverse variants exist:
  ``sid_to_rid_low`` and ``sid_to_rid_high``.
* For a *deleted* stable tuple there is no RID that maps to its SID, yet its
  SID still translates: "the lowest RID that translates into a SID higher
  than the one of the deleted tuple".
* Chunks are SID ranges; ABM works purely on SIDs.  A delivered chunk's SID
  range is widened to a RID range via (low, high) translation and must be
  **trimmed** against RID ranges already produced, because neighbouring
  chunks' RID ranges may overlap (out-of-order delivery!).  This is
  :class:`CScanMergeState`.

The structure here is list+bisect rather than an actual counted B-tree; the
translation semantics (which is what the paper's correctness depends on) are
identical, and the engine/test layers only rely on those semantics.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class PDT:
    """Positional delta tree over a stable table of ``n_stable`` tuples.

    Inserts are anchored to the SID of the first stable tuple that follows
    them (anchor ``n_stable`` = append at end).  Deletes mark stable SIDs.
    Modifications patch stable tuples in place (no positional effect).
    """

    def __init__(self, n_stable: int):
        self.n_stable = n_stable
        self._ins_keys: List[int] = []      # sorted anchor SIDs with inserts
        self._ins_counts: Dict[int, int] = {}
        self._ins_values: Dict[int, List[object]] = {}
        self._del_keys: List[int] = []      # sorted deleted SIDs
        self._mods: Dict[int, object] = {}

    # ---- update API --------------------------------------------------------
    def insert(self, anchor_sid: int, value: object = None) -> None:
        if not (0 <= anchor_sid <= self.n_stable):
            raise ValueError(f"anchor sid {anchor_sid} out of range")
        if anchor_sid not in self._ins_counts:
            bisect.insort(self._ins_keys, anchor_sid)
            self._ins_counts[anchor_sid] = 0
            self._ins_values[anchor_sid] = []
        self._ins_counts[anchor_sid] += 1
        self._ins_values[anchor_sid].append(value)

    def delete(self, sid: int) -> None:
        if not (0 <= sid < self.n_stable):
            raise ValueError(f"sid {sid} out of range")
        i = bisect.bisect_left(self._del_keys, sid)
        if i < len(self._del_keys) and self._del_keys[i] == sid:
            return  # idempotent
        self._del_keys.insert(i, sid)

    def modify(self, sid: int, value: object) -> None:
        if not (0 <= sid < self.n_stable):
            raise ValueError(f"sid {sid} out of range")
        self._mods[sid] = value

    def is_deleted(self, sid: int) -> bool:
        i = bisect.bisect_left(self._del_keys, sid)
        return i < len(self._del_keys) and self._del_keys[i] == sid

    # ---- running deltas ----------------------------------------------------
    def _inserts_before(self, sid: int) -> int:
        """Total insert count with anchor < sid."""
        i = bisect.bisect_left(self._ins_keys, sid)
        return sum(self._ins_counts[k] for k in self._ins_keys[:i])

    def _inserts_at(self, sid: int) -> int:
        return self._ins_counts.get(sid, 0)

    def _deletes_before(self, sid: int) -> int:
        return bisect.bisect_left(self._del_keys, sid)

    @property
    def n_visible(self) -> int:
        total_ins = sum(self._ins_counts.values())
        return self.n_stable + total_ins - len(self._del_keys)

    # ---- SID/RID translation (paper Fig. 4) ---------------------------------
    def sid_to_rid_low(self, sid: int) -> int:
        """Lowest RID that maps to ``sid`` (blue arrows in paper Fig. 4)."""
        if not (0 <= sid <= self.n_stable):
            raise ValueError(f"sid {sid} out of range")
        return sid + self._inserts_before(sid) - self._deletes_before(sid)

    def sid_to_rid_high(self, sid: int) -> int:
        """Highest RID that maps to ``sid`` (red arrows in paper Fig. 4).

        For a deleted tuple with no inserts anchored at it this equals
        ``sid_to_rid_low`` — the lowest RID of a *higher* SID, per the paper.
        """
        low = self.sid_to_rid_low(sid)
        at = self._inserts_at(sid)
        if sid < self.n_stable and not self.is_deleted(sid):
            return low + at  # inserts first, then the stable tuple itself
        if at > 0:
            return low + at - 1
        return low

    def rid_to_sid(self, rid: int) -> int:
        """Translate a visible RID to its SID (anchor SID for inserts)."""
        if not (0 <= rid < self.n_visible):
            raise ValueError(f"rid {rid} out of range (n_visible={self.n_visible})")
        # Largest sid with sid_to_rid_low(sid) <= rid; low is monotone in sid.
        lo, hi = 0, self.n_stable
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.sid_to_rid_low(mid) <= rid:
                lo = mid
            else:
                hi = mid - 1
        return lo

    # ---- stacking (snapshot isolation, paper §2.1) ---------------------------
    def stacked_on(self) -> "PDT":
        """A fresh private PDT layered on this one's *visible* stream.

        Vectorwise stacks differences-on-differences: the topmost, smallest
        PDT is private to a snapshot.  The child treats this PDT's visible
        stream as its stable storage.
        """
        return PDT(self.n_visible)


@dataclass
class CScanMergeState:
    """Tracks RID ranges already produced by an out-of-order CScan.

    ABM delivers chunks (SID ranges) out of order.  Each delivered SID range
    widens to [sid_to_rid_low(lo), sid_to_rid_high(hi-1)] and *may overlap*
    the RID range of an adjacent, already-delivered chunk; the overlap must
    be trimmed so no tuple is produced twice (paper §2.1).
    """

    produced: List[Tuple[int, int]] = field(default_factory=list)  # sorted, disjoint

    def deliver_chunk(self, pdt: PDT, sid_lo: int, sid_hi: int) -> List[Tuple[int, int]]:
        """Return the trimmed, novel RID sub-ranges for chunk [sid_lo, sid_hi)."""
        if sid_hi <= sid_lo:
            return []
        rid_lo = pdt.sid_to_rid_low(sid_lo)
        rid_hi = pdt.sid_to_rid_high(max(sid_lo, sid_hi - 1)) + 1  # half-open
        # a trailing deleted tuple "translates" past the visible stream:
        # clamp to it (the paper's widening is about overlap, not overrun)
        rid_hi = min(rid_hi, pdt.n_visible)
        rid_lo = min(rid_lo, rid_hi)
        novel = self._subtract(rid_lo, rid_hi)
        for r in novel:
            self._add(r)
        return novel

    def _subtract(self, lo: int, hi: int) -> List[Tuple[int, int]]:
        out = []
        cur = lo
        for plo, phi in self.produced:
            if phi <= cur:
                continue
            if plo >= hi:
                break
            if plo > cur:
                out.append((cur, min(plo, hi)))
            cur = max(cur, phi)
            if cur >= hi:
                break
        if cur < hi:
            out.append((cur, hi))
        return [r for r in out if r[1] > r[0]]

    def _add(self, r: Tuple[int, int]) -> None:
        lo, hi = r
        i = bisect.bisect_left(self.produced, (lo, hi))
        self.produced.insert(i, (lo, hi))
        # coalesce
        merged: List[Tuple[int, int]] = []
        for a, b in self.produced:
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        self.produced = merged

    @property
    def produced_count(self) -> int:
        return sum(b - a for a, b in self.produced)
