"""The traced window: one short prefix sweep under ``torch.profiler``,
reduced to the device's operations and the host's activity around them.

Only ``--trace 1`` runs take it, in their fresh process before the timed
window (late in a process that has made many launches the profiler has
been seen to lose kernels).
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

#: host events a gap's label is looked for among, back from the gap
_LOOK_BACK = 64


@dataclass
class Trace:
    """A profiled window: its wall seconds, the macro-steps it ran, and the
    device's and the host's events as ``(name, start_ns, end_ns)``."""

    window_s: float
    steps: int
    device: List[Tuple[str, int, int]] = field(default_factory=list)
    host: List[Tuple[str, int, int]] = field(default_factory=list)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the device's intervals)."""
        busy, end = 0, None
        for _n, s, e in self.device:
            if end is None or s >= end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def device_ops(self, n: int = 10) -> List[list]:
        """The device's operations with the most time, summed by name."""
        by: Dict[str, int] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle gaps summed by what the host was doing at
        each gap's middle: the innermost host event around it."""
        starts = [h[1] for h in self.host]
        by: Dict[str, int] = {}
        end = None
        for _name, s, e in self.device:
            if end is not None and s > end:
                mid = (s + end) // 2
                label = "host: between profiled calls"
                i = bisect.bisect_right(starts, mid) - 1
                for j in range(i, max(-1, i - _LOOK_BACK), -1):
                    if self.host[j][2] >= mid:
                        label = self.host[j][0]
                        break
                by[label] = by.get(label, 0) + (s - end)
            end = e if end is None else max(end, e)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in top]


def profile(fn: Callable[[], int]) -> Trace:
    """``fn()`` (which runs the window, ends in a synchronise and returns
    its macro-steps) once under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = fn()
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), int(e.start_ns()), int(e.end_ns()))
        (dev if e.device_type() == DeviceType.CUDA else host).append(row)
    dev.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    del prof
    return Trace(window_s=window_s, steps=steps, device=dev, host=host)
