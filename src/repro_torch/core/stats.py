"""Result aggregation: the paper's metrics + sharing-potential analysis."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from .engine import EngineResult


@dataclass
class SharingPotential:
    """Time-integrated bytes by number of interested scans (Figs 17/18)."""

    by_count: Dict[int, float]  # interest count -> avg bytes over samples

    @property
    def reusable_fraction(self) -> float:
        """Fraction of in-demand data wanted by >= 2 scans."""
        total = sum(self.by_count.values())
        if total <= 0:
            return 0.0
        multi = sum(v for k, v in self.by_count.items() if k >= 2)
        return multi / total


def sharing_potential(result: EngineResult) -> SharingPotential:
    acc: Dict[int, float] = {}
    n = max(1, len(result.sharing_samples))
    for sample in result.sharing_samples:
        for k, v in sample.items():
            kk = min(k, 4)  # paper buckets: 1, 2, 3, 4+
            acc[kk] = acc.get(kk, 0.0) + v / n
    return SharingPotential(by_count=dict(sorted(acc.items())))


def summarize(results: Sequence[EngineResult]) -> List[Dict[str, object]]:
    rows = []
    for r in results:
        rows.append(
            {
                "policy": r.policy,
                "avg_stream_time_s": round(r.avg_stream_time, 3),
                "total_io_gb": round(r.io_gb, 3),
                "loads": r.total_loads,
                "hits": r.total_hits,
                "sim_time_s": round(r.sim_time, 3),
            }
        )
    return rows
