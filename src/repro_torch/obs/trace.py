"""Flight recorder: host-side macro-step traces in Chrome/Perfetto JSON.

Counterpart of the JAX package's ``repro.obs.trace``.  The carried
counters (:mod:`repro_torch.obs.counters`) answer *how much*; the flight
recorder answers *when*.  A :class:`TraceSession` drives the same step
pair the runner uses (``make_step`` cheap + refresh) over ONE lane, with
the runner's loop conditions evaluated on the host, so every macro-step
boundary is observable: per step it records the jump reason (``fine`` /
``jump`` / ``refresh``), the simulated interval, grants, evictions (the
residency diff — the ground truth the eviction counter must agree with)
and the pending request-queue depth.  ``to_chrome()`` serialises the
records as a Chrome ``traceEvents`` JSON that Perfetto renders directly:
one duration track of macro-steps plus counter tracks for queue depth and
pool occupancy.

This is the diagnostic tier — one lane, its state read back to the host
after every macro-step — not the sweep tier.  Results are step for step
those of the runner: the same final state, and an ``eviction_total()``
equal to the runner's ``evictions`` counter.  (The residency diff counts
``prev & ~new``; it equals the evictions because a page cannot be evicted
and loaded again within one step.)

CLI::

    python -m repro_torch.obs.trace --scale 0.1 --frac 0.4 --policy pbm \\
        --out trace_micro.perfetto.json --manifest run_manifest.json \\
        --device cuda
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import manifest as manifest_mod


class TraceSession:
    """Host-looped recorder over the simulator's step pair (one lane)."""

    def __init__(self, spec, *, bandwidth_ref: float = 700e6,
                 time_slice: float = 0.1, prefetch_pages: int = 8,
                 policies: Optional[Sequence] = None,
                 step_pages: float = 1.0, stepper: str = "horizon",
                 h_max: float = 8.0, h_io: float = 3.0,
                 max_events: int = 100_000, device="cuda"):
        from ..core.array_sim import sim as _sim
        from ..core.array_sim.convert import resolve_device

        self._sim = _sim
        self.device = resolve_device(device)
        self.spec = spec
        self.stepper = stepper
        self.pols = _sim.resolve_policies(policies)
        self.dt = (float(step_pages) * float(np.max(spec.page_size))
                   / float(bandwidth_ref))
        kw = dict(policies=self.pols, stepper=stepper, h_max=h_max,
                  h_io=h_io, device=self.device)
        self._cheap = _sim.make_step(spec, self.dt, time_slice,
                                     prefetch_pages, refresh=False, **kw)
        self._full = _sim.make_step(spec, self.dt, time_slice,
                                    prefetch_pages, refresh=True, **kw)
        self.n_inner = self._cheap.n_inner
        self._page_size = np.asarray(spec.page_size)
        self.max_events = max_events
        self.events: List[dict] = []

    # ------------------------------------------------------------- record --
    def _snap(self, st) -> tuple:
        """What a record reads of one state, on the host: the clock (f32),
        the load counter, the residency and the pending-queue depth."""
        return (st.t[0].cpu().numpy(), int(st.loads[0]),
                st.resident[0].cpu().numpy(),
                int((st.req_step[0] != self._sim._REQ_NONE).sum()))

    def _record(self, kind: str, planned_h: int, prev, new) -> None:
        if len(self.events) >= self.max_events:
            return
        t0, loads0, res0, _ = prev
        t1, loads1, res1, pend = new
        self.events.append({
            "ts": float(t0),
            "dur": float(t1 - t0),
            "kind": kind,
            "h": int(planned_h),
            "loads": loads1 - loads0,
            "evicted": int(np.sum(res0 & ~res1)),
            "pending": pend,
            "resident_bytes": float(np.sum(self._page_size * res1)),
        })

    # ---------------------------------------------------------------- run --
    def run(self, cfg, max_slices: int = 80_000):
        """Drive the workload of ``cfg`` (one lane) to completion, recording
        every macro-step.  Returns the final :class:`SimState` — the one
        the runner produces for the same config."""
        sim = self._sim
        cfg = sim._lanes(cfg)
        if cfg.policy.shape[0] != 1:
            raise ValueError("TraceSession records one lane: pass one config")
        lc = self._cheap.lane_consts(cfg)
        state = sim.init_state(self.spec, self.pols, lanes=1,
                               device=self.device)
        self.events = []

        def running(st) -> bool:
            return bool(((st.stream_done_t < 0).any(dim=1)
                         & (st.t < cfg.max_time)
                         & (st.slices_done < max_slices))[0])

        def step(fn, kind, h, carry, snap):
            carry = fn(carry, cfg, None, lc)
            new = self._snap(carry[0])
            self._record(kind, h, snap, new)
            return carry, new

        snap = self._snap(state)
        if self.stepper == "fixed":
            carry = (state, self._cheap.query_view(state.qidx, state.pos))
            while running(carry[0]):
                for _ in range(self.n_inner - 1):
                    carry, snap = step(self._cheap, "fine", 1, carry, snap)
                carry, snap = step(self._full, "refresh", 1, carry, snap)
            return carry[0]

        view0 = self._cheap.query_view(state.qidx, state.pos)
        win0 = self._cheap.window(view0)
        i32 = dict(dtype=torch.int32, device=self.device)
        carry = (state, view0, win0,
                 self._cheap.adv_limit(win0, state.resident),
                 torch.zeros(1, dtype=torch.float32, device=self.device),
                 torch.full((1,), self.n_inner, **i32), torch.ones(1, **i32))
        while running(carry[0]):
            # the runner's inner loop: macro-jump while the slice has
            # budget and the planned jump falls short of the boundary,
            # then the refresh step absorbs the tail
            while True:
                rem, next_h = (int(v) for v in torch.cat(carry[5:7]).cpu())
                if not (rem > 1 and next_h < rem):
                    break
                h = min(next_h, rem - 1)
                carry, snap = step(self._cheap, "jump" if h > 1 else "fine",
                                   h, carry, snap)
            carry, snap = step(self._full, "refresh", rem, carry, snap)
        return carry[0]

    # ------------------------------------------------------------ exports --
    def eviction_total(self) -> int:
        """Evictions reconstructed from the per-step residency diffs — the
        number the event engine's ``total_evictions`` must match."""
        return sum(e["evicted"] for e in self.events)

    def to_chrome(self, pid: int = 0) -> dict:
        """Chrome ``traceEvents`` JSON (Perfetto-loadable): macro-steps as
        duration events (1 sim second = 1 trace ms), queue depth and pool
        occupancy as counter tracks."""
        scale = 1e3  # sim seconds -> trace microseconds / 1000
        evs: List[dict] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": f"array_sim [{self.stepper}]"}},
            {"ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
             "args": {"name": "macro-steps"}},
        ]
        for e in self.events:
            ts = e["ts"] * scale
            evs.append({
                "ph": "X", "pid": pid, "tid": 0, "name": e["kind"],
                "ts": ts, "dur": max(e["dur"] * scale, 0.001),
                "args": {"fine_steps": e["h"], "loads": e["loads"],
                         "evicted": e["evicted"],
                         "pending": e["pending"]},
            })
            evs.append({"ph": "C", "pid": pid, "name": "io_queue",
                        "ts": ts, "args": {"pending": e["pending"]}})
            evs.append({"ph": "C", "pid": pid, "name": "pool",
                        "ts": ts,
                        "args": {"resident_mb":
                                 round(e["resident_bytes"] / 1e6, 3)}})
        return {"traceEvents": evs, "displayTimeUnit": "ms"}


def serving_events_to_chrome(events: Sequence[dict],
                             label: str = "serving") -> dict:
    """Chrome trace of ``ServingEngine`` structured events (one instant
    event per admit / preempt / resume / prefetch; 1 engine step = 1 ms)."""
    evs: List[dict] = [
        {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
         "args": {"name": f"ServingEngine [{label}]"}},
    ]
    for e in events:
        args = {k: v for k, v in e.items() if k not in ("step", "kind")}
        evs.append({
            "ph": "i", "s": "g", "pid": 1, "tid": 0,
            "name": e["kind"], "ts": e["step"] * 1e3, "args": args,
        })
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


# ------------------------------------------------------------------- CLI --

def _build_point(scale: float, n_streams: int, queries: int, seed: int,
                 frac: float):
    from ..core.array_sim import build_spec
    from ..core.workload import (
        make_lineitem_db, micro_accessed_bytes, micro_streams,
    )

    db = make_lineitem_db(scale_tuples=max(1, int(6_001_215 * scale)))
    streams = micro_streams(db, n_streams=n_streams,
                            queries_per_stream=queries, seed=seed)
    spec = build_spec(db, streams)
    cap = max(1 << 22, int(frac * micro_accessed_bytes(db)))
    return spec, cap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Record one micro-workload lane as a Perfetto trace")
    ap.add_argument("--scale", type=float, default=0.1,
                    help="lineitem scale fraction (default 0.1)")
    ap.add_argument("--frac", type=float, default=0.4,
                    help="buffer fraction of the working set (default 0.4)")
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--policy", default="pbm")
    ap.add_argument("--stepper", default="horizon",
                    choices=["fixed", "horizon"])
    ap.add_argument("--out", default="trace_micro.perfetto.json")
    ap.add_argument("--manifest", default=None,
                    help="also write a run manifest JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    args = ap.parse_args(argv)

    from ..core.array_sim import make_config

    spec, cap = _build_point(args.scale, args.streams, args.queries,
                             args.seed, args.frac)
    sess = TraceSession(spec, policies=(args.policy,),
                        stepper=args.stepper, device=args.device)
    cfg = make_config(spec, cap, 700e6, args.policy, device=sess.device)
    state = sess.run(cfg)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(sess.to_chrome(), f)
    print(f"wrote {args.out}: {len(sess.events)} macro-steps, "
          f"{sess.eviction_total()} evictions, "
          f"sim_time={float(state.t[0]):.2f}s")
    if args.manifest:
        man = manifest_mod.collect(
            spec=spec, stepper=args.stepper, sanitize=False,
            device=sess.device, policy=args.policy, buffer_frac=args.frac,
            scale=args.scale, macro_steps=len(sess.events),
            evictions=sess.eviction_total(),
        )
        with open(args.manifest, "w", encoding="utf-8") as f:
            json.dump(man, f, indent=2)
        print(f"wrote {args.manifest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
