"""PBM Attach & Throttle — the paper's §5 improvement direction, built.

PBM's one weak spot (paper Fig. 11) is extreme memory pressure with high
sharing potential: in-order scans scattered across the table cannot reuse
each other's pages.  The paper sketches the remedy: bring circular-scan
*attach* semantics and DB2-style *throttling* into PBM —

* **Attach**: a starting scan whose range overlaps an already-running scan
  is ordered to start near that scan's current position (we rotate its page
  request order: [pos, end) then [start, pos)), so the pair shares every
  page load from then on.  Order within a query no longer matters to PBM's
  estimates — both sub-ranges are registered with correct triggers.
* **Throttle**: PBM tracks ``next_consumption_evict`` — the estimated
  next-consumption time of recently evicted pages.  A scan whose freshly
  consumed pages would be re-consumed (by a trailing scan) *just after* that
  horizon is slowed down, letting the trailing scan catch up so the pages
  are reused before eviction.  We expose the throttle factor to the engine
  via ``throttle_factor(scan)``; the engine multiplies the scan's CPU rate.

This is a beyond-paper deliverable (the paper only outlines it); the
mechanism doubles as the serving-side straggler/group scheduler.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, TYPE_CHECKING

from ..pages import Page, PageId
from .pbm import PBMPolicy

if TYPE_CHECKING:  # pragma: no cover
    from ..scans import ScanState


class AttachThrottlePBM(PBMPolicy):
    name = "attach"

    def __init__(
        self,
        *args,
        attach: bool = True,
        throttle: bool = True,
        throttle_slowdown: float = 0.5,
        evict_horizon_ewma: float = 0.2,
        **kwargs,
    ) -> None:
        super().__init__(*args, **kwargs)
        self.attach_enabled = attach
        self.throttle_enabled = throttle
        self.throttle_slowdown = throttle_slowdown
        self._h_alpha = evict_horizon_ewma
        self.next_consumption_evict: Optional[float] = None  # EWMA horizon
        self._throttled: Set[int] = set()

    # ------------------------------------------------------------- attach --
    def register_scan(self, scan: "ScanState", now: float) -> None:
        if self.attach_enabled and not scan.spec.in_order_required:
            peer = self._best_peer(scan)
            if peer is not None:
                self._rotate_plan(scan, peer.virt_pos)
        super().register_scan(scan, now)

    def _best_peer(self, scan: "ScanState") -> Optional["ScanState"]:
        """Running scan on the same table with maximal overlapping remainder."""
        best, best_overlap = None, 0
        mine = {p.pid for p in scan.unique_pages}
        for other in self._scans.values():
            if other.spec.table != scan.spec.table or other.done:
                continue
            rest = {p.pid for _, p in other.plan[other.plan_idx:]}
            ov = len(mine & rest)
            if ov > best_overlap:
                best, best_overlap = other, ov
        # only attach when a useful fraction of the scan is shared
        if best is not None and best_overlap >= max(8, len(mine) // 8):
            return best
        return None

    def _rotate_plan(self, scan: "ScanState", peer_virt: int) -> None:
        """Rotate the access plan to start at the peer's position.

        Both halves keep correct trigger/end offsets in the *rotated* virtual
        timeline so PBM's tuples_behind bookkeeping stays exact.
        """
        plan = scan.plan_full
        if not plan:
            return
        total = scan.total_tuples
        # find split: first entry with trigger >= peer position (clamped)
        split_virt = min(max(0, peer_virt), total - 1)
        k = 0
        while k < len(plan) and plan[k][0] < split_virt:
            k += 1
        if k == 0 or k >= len(plan):
            return
        head, tail = plan[:k], plan[k:]
        base = tail[0][0]
        rotated = [
            (t - base, e - base, p) for (t, e, p) in tail
        ] + [
            (t + (total - base), e + (total - base), p) for (t, e, p) in head
        ]
        scan.plan_full = rotated
        scan.plan = [(t, p) for t, _, p in rotated]
        scan.plan_idx = 0

    # ------------------------------------------------------------ throttle --
    def choose_victims(
        self, bytes_needed: int, protected: Set[PageId], now: float
    ) -> List[Page]:
        victims = super().choose_victims(bytes_needed, protected, now)
        if self.throttle_enabled:
            for v in victims:
                nxt = self.page_next_consumption(v, now)
                if nxt is None:
                    continue
                if self.next_consumption_evict is None:
                    self.next_consumption_evict = nxt
                else:
                    self.next_consumption_evict = (
                        self._h_alpha * nxt
                        + (1 - self._h_alpha) * self.next_consumption_evict
                    )
        return victims

    def throttle_factor(self, scan: "ScanState", now: float) -> float:
        """CPU-rate multiplier for ``scan`` (engine hook).

        Throttle when pages this scan just consumed will be needed by a
        trailing scan *later than* the eviction horizon: slowing this scan
        down pulls the trailing scan's next-consumption estimates below the
        horizon, so the shared pages survive until reuse.
        """
        if not self.throttle_enabled or self.next_consumption_evict is None:
            return 1.0
        horizon = self.next_consumption_evict
        nxt = scan.next_needed()
        if nxt is None:
            return 1.0
        # trailing scans on my recent pages
        for _, page in scan.plan[max(0, scan.plan_idx - 4): scan.plan_idx]:
            meta = self._meta.get(page.pid)
            if meta is None:
                continue
            for sid, trig in meta.consuming_scans.items():
                other = self._scans.get(sid)
                if other is None or sid == scan.scan_id:
                    continue
                eta = (trig - other.virt_pos) / max(other.speed, 1e-6)
                if 0 < eta and eta > horizon:
                    self._throttled.add(scan.scan_id)
                    return self.throttle_slowdown
        self._throttled.discard(scan.scan_id)
        return 1.0
