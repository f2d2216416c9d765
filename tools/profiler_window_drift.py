"""How ``torch.profiler``'s count of a fixed kernel's launches holds up as a
process ages, opens window after window and launches many small kernels.

    python3 tools/profiler_window_drift.py [--seconds 180] [--every 20]
                                           [--burst 40] [--reps 20]
    python3 tools/profiler_window_drift.py --after-busy 14 [--busy 10]

One process launches one fixed CUDA kernel (an in-place add on 2**20
floats).  Each probe opens three profiler windows on ``--reps`` calls:

* ``stepped``: ``chip_smoke.cuda_kernel_times``' window, a warm-up step
  and a counted step, each starting with a 0.1 s sleep;
* ``padded``: one window whose calls start ``PAD_S[0]`` after it opens and
  end ``PAD_S[1]`` before it closes;
* ``offset``: CPU and CUDA activity, the calls inside a ``record_function``
  range entered after a synchronize: the first kernel's start less the
  range's start on the profiler's time line (``offset_ms``).  A kernel
  starts after its launch, so a negative offset is the profiler placing
  device activity earlier than the host's clock saw it; a window drops
  device events that it places outside itself.

First ``--burst`` probes back to back (does the number of windows in a
process matter?), then one every ``--every`` seconds until the process is
``--seconds`` old, the host launching small kernels in between as the
simulator's steps do (does the process's age, or what it launched?).  One
JSON object a probe, then a summary with the offset's least-squares slope
in ms per 100 s of age; the card's name and power limit first.

``--after-busy N`` runs instead N padded windows, each after ``--busy``
seconds of small launches, every other one after an empty profiler
session (``primed``), each with its count and where its first and last
kernel fell, in ms from the window's opening; then how many of each kind
lost kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = time.time()
#: seconds from a padded window's opening to its first call, and from its
#: last call to its closing
PAD_S = (1.0, 0.2)


def padded_window(fn, reps: int, primed: bool = False) -> dict:
    """A padded window, after an empty profiler session when ``primed``:
    launches a call, and the first and last kernel's start in ms from the
    window's opening."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if primed:
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
    before, after = PAD_S
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(before)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(after)
    starts = sorted(e.time_range.start / 1e3 for e in prof.events()
                    if e.device_type.name == "CUDA" and "add" in e.name)
    return {"per_call": len(starts) / reps,
            "first_ms": starts[0] if starts else None,
            "last_ms": starts[-1] if starts else None}


def offset_ms(fn, reps: int) -> float:
    """The first kernel's start less the enclosing range's start, ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.2)
        with record_function("calls"):
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
        time.sleep(0.2)
    events = prof.events()
    calls = [e for e in events if e.name == "calls"]
    kernels = [e.time_range.start for e in events
               if e.device_type.name == "CUDA" and "add" in e.name]
    if not calls or not kernels:
        return float("nan")
    return (min(kernels) - calls[0].time_range.start) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=180.0)
    ap.add_argument("--every", type=float, default=20.0)
    ap.add_argument("--burst", type=int, default=40)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--after-busy", type=int, default=0,
                    help="instead: this many windows, each after --busy "
                         "seconds of small launches, plain and primed in "
                         "turns")
    ap.add_argument("--busy", type=float, default=5.0)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        print("profiler_window_drift: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(json.dumps({"gpu": cs.nvidia_smi_line()}), flush=True)
    dev = torch.device("cuda")
    x = torch.zeros(1 << 20, device=dev)
    small = torch.zeros(64, device=dev)

    def fn():
        x.add_(1.0)

    def probe(kind: str) -> dict:
        stepped = cs.cuda_kernels_per_call(fn, args.reps)
        row = {"kind": kind, "age_s": time.time() - T0,
               "stepped": sum(v for k, v in stepped.items() if "add" in k),
               "padded": padded_window(fn, args.reps)["per_call"],
               "offset_ms": offset_ms(fn, args.reps)}
        print(json.dumps(row), flush=True)
        return row

    def busy(seconds: float) -> None:      # host-bound small launches
        t_end = time.time() + seconds
        while time.time() < t_end:
            for _ in range(200):
                small.mul_(0.5).add_(1.0)
            torch.cuda.synchronize()

    if args.after_busy:
        rows = []
        for n in range(args.after_busy):
            busy(args.busy)
            primed = bool(n % 2)
            row = {"kind": "primed" if primed else "padded",
                   "age_s": time.time() - T0,
                   **padded_window(fn, args.reps, primed)}
            print(json.dumps(row), flush=True)
            rows.append(row)
        print(json.dumps({kind: sum(r["per_call"] != 1.0 for r in rows
                                    if r["kind"] == kind)
                          for kind in ("padded", "primed")}), flush=True)
        return 0

    rows = [probe("burst") for _ in range(args.burst)]
    while time.time() - T0 < args.seconds:
        busy(args.every)
        rows.append(probe("aged"))
    ok = [r for r in rows if r["offset_ms"] == r["offset_ms"]]
    n = len(ok)
    mx = sum(r["age_s"] for r in ok) / n
    my = sum(r["offset_ms"] for r in ok) / n
    sxx = sum((r["age_s"] - mx) ** 2 for r in ok)
    slope = sum((r["age_s"] - mx) * (r["offset_ms"] - my) for r in ok) / sxx
    print(json.dumps({
        "probes": len(rows), "offset_ms_per_100s": 100.0 * slope,
        "offset_ms_first": ok[0]["offset_ms"],
        "offset_ms_last": ok[-1]["offset_ms"],
        "stepped_not_whole": sum(r["stepped"] != 1.0 for r in rows),
        "padded_not_whole": sum(r["padded"] != 1.0 for r in rows)}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
