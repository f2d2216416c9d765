"""Static description of a range scan (paper §2-3).

Own copy of what the workload compiler needs from the JAX package's
``repro.core.scans``: :class:`ScanSpec`, the data a query contributes to
the compiled workload (table, column set, tuple range, CPU rate).  The
runtime ``ScanState`` of the event engine belongs to the event-engine
slice of the port and is not here yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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
