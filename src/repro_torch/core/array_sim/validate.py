"""Cross-validation harness: the port's array runner vs its event engine.

Counterpart of the JAX package's ``repro.core.array_sim.validate``, over
the port's own runner (``sim.make_runner``, on ``device``) and the port's
own copy of the dict/heapq event engine (``repro_torch.core.engine``);
the error bars below are the JAX package's, copied value for value, not
refit.  Runs the same workloads through both simulators and reports, per
(workload, buffer point, policy, stepper), the relative error of the two
paper metrics (average stream time and total I/O volume).  Every
registered array policy validates here — the paper's full four-way
comparison (lru / cscan / pbm / opt) on both suites — and BOTH time
engines (``--stepper both``, the default): the fixed-dt cadence and the
event-horizon stepper must each sit inside the same bars.  The slow
event-engine reference runs are computed once per point and shared
between steppers:

* **micro** — the scaled §4.1 microbenchmark (single table);
* **tpch** — the §4.2 multi-table throughput workload lowered through
  ``compiler.compile_workload`` (8 tables, rotated 22-template streams),
  validated at the paper's default operating shape (buffer fracs
  0.15/0.3/0.5 of the accessed volume, 600 MB/s; bars in
  ``TPCH_ERROR_BARS``).

The array backend is a discretised fluid approximation of the event
engine, so small deviations are expected; the acceptance envelope of the
micro suite is the paper's small-buffer operating range:

* ``buffer_frac`` 0.1, 0.2 and 0.4 of the accessed working set (700 MB/s,
  8 streams, quick-pass scale — the configuration of
  ``benchmarks/microbench.py``),
* <= 10% relative error on both metrics for PBM at every point and for
  LRU at 0.2 / 0.4,
* <= 13% for LRU at the 0.1 deep-thrash point — the event engine
  supersaturates there (its loads exceed one load per page consumption:
  sharing collapses entirely while ~23% of loads are evicted before
  first use), and the fluid step reproduces that churn spiral only
  partially; the residual is documented in the README;
* <= 13% for OPT (largest at the 0.4 point) — the array oracle holds
  its victim ranking stale on the slice cadence to reproduce the event
  oracle's burst-stale churn (see ``policies.ArrayOPT``); the residual
  is the part of that churn the slice quantisation misses;
* <= 15% for CScan on TPC-H (largest at the 0.5 point) — the
  chunk-granular cooperative fluid (``array_sim.coop``) approximates
  ABM's choose-chunk/choose-scan loop without its per-event timing.

A truncated array run (``max_time``/``max_slices`` livelock guard) is a
hard error: :func:`cross_validate` raises instead of comparing a lower
bound against a finished event run.

Usage::

    PYTHONPATH=src python -m repro_torch.core.array_sim.validate            # on the GPU
    PYTHONPATH=src python -m repro_torch.core.array_sim.validate --device cpu --buffer-frac 0.4
    PYTHONPATH=src python -m repro_torch.core.array_sim.validate --fit-bars  # report only

``--fit-bars`` reports measured errors without enforcing, and prints
``ERROR_BARS`` / ``TPCH_ERROR_BARS`` dict literals of what was measured.

Exits non-zero when a point misses its error bar.  ``chip_smoke.py``
holds its calibrated sweep to these bars through :func:`event_run` and
:func:`compare_row`.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Dict, List, Optional, Sequence

from .. import policy_registry
from ..engine import EngineConfig, run_workload
from ..workload import (
    make_lineitem_db,
    make_tpch_db,
    micro_accessed_bytes,
    micro_streams,
    tpch_accessed_bytes,
    tpch_streams,
)
from .compiler import compile_workload
from .convert import resolve_device
from .sim import make_runner, run_workload_array
from .spec import build_spec

#: every policy both backends can run — the paper's four-way comparison
DEFAULT_POLICIES = tuple(policy_registry.names(backend="array"))

#: validated operating envelope (buffer_frac, policy) -> max |rel err|,
#: the JAX package's values (fit there at the quick-pass scale; the
#: horizon stepper's wake-exact macro-jumps sample the deep-thrash LRU
#: churn spiral on a coarser cadence, hence the widened 0.1 LRU bar)
ERROR_BARS = {
    (0.1, "cscan"): 0.10,
    (0.1, "lru"): 0.21,    # engine churn spiral + wake-exact cadence
    (0.1, "opt"): 0.10,
    (0.1, "pbm"): 0.10,
    (0.2, "cscan"): 0.10,
    (0.2, "lru"): 0.10,
    (0.2, "opt"): 0.10,
    (0.2, "pbm"): 0.10,
    (0.4, "cscan"): 0.10,
    (0.4, "lru"): 0.10,
    (0.4, "opt"): 0.13,    # slice-stale oracle residual (see ArrayOPT)
    (0.4, "pbm"): 0.10,
}
DEFAULT_FRACS = (0.1, 0.2, 0.4)

#: TPC-H multi-table envelope (buffer_frac, policy) -> max |rel err|,
#: the JAX package's values, fit there at the quick-pass TPC-H point
#: (scale 0.05, 4 streams, 600 MB/s, seed 7: the paper's §4.2
#: operating shape scaled down); cscan's cooperative fluid and LRU's
#: macro-sampled churn at the 0.5 point take the widened bars.
TPCH_ERROR_BARS = {
    (0.15, "cscan"): 0.11,
    (0.15, "lru"): 0.10,
    (0.15, "opt"): 0.10,
    (0.15, "pbm"): 0.10,
    (0.3, "cscan"): 0.10,
    (0.3, "lru"): 0.11,
    (0.3, "opt"): 0.10,
    (0.3, "pbm"): 0.10,
    (0.5, "cscan"): 0.15,
    (0.5, "lru"): 0.14,
    (0.5, "opt"): 0.10,
    (0.5, "pbm"): 0.10,
}
TPCH_DEFAULTS = dict(scale=0.05, n_streams=4, buffer_frac=0.3,
                     bandwidth=600e6, seed=7)


def event_run(db, streams, policy: str, capacity: int, bandwidth: float,
              time_slice: float, sample_interval: float):
    """The event engine's reference run of one point: ``(result, wall
    seconds)``."""
    cfg = EngineConfig(bandwidth=bandwidth, buffer_bytes=capacity,
                       sample_interval=sample_interval,
                       pbm_time_slice=time_slice)
    t0 = time.time()
    return run_workload(db, streams, policy, cfg), time.time() - t0


def compare_row(workload: str, policy: str, stepper: str,
                buffer_frac: float, ev, ev_wall: float, ar) -> Dict:
    """One result row: both backends' paper metrics and their relative
    differences (array over event, minus one)."""
    return {
        "workload": workload,
        "policy": policy,
        "stepper": stepper,
        "buffer_frac": buffer_frac,
        "event_stream_time_s": round(ev.avg_stream_time, 4),
        "array_stream_time_s": round(ar.avg_stream_time, 4),
        "event_io_gb": round(ev.io_gb, 4),
        "array_io_gb": round(ar.io_gb, 4),
        "stream_time_rel_err": round(
            ar.avg_stream_time / max(ev.avg_stream_time, 1e-12) - 1, 4),
        "io_rel_err": round(ar.io_gb / max(ev.io_gb, 1e-12) - 1, 4),
        "event_wall_s": round(ev_wall, 3),
        "array_wall_s": round(ar.wall_s, 3),
        "array_steps": ar.steps,
        "array_macro_steps": ar.extras.get("macro_steps", ar.steps),
        "array_skipped_time": ar.extras.get("skipped_time", 0.0),
        "truncated": ar.extras.get("truncated", False),
        "array_churn_loads": ar.extras.get("churn_loads", 0),
    }


def bar_of(row: Dict) -> float:
    """The error bar a row is held to (10 % where none is listed)."""
    bars = TPCH_ERROR_BARS if row.get("workload") == "tpch" else ERROR_BARS
    return bars.get((row["buffer_frac"], row["policy"]), 0.10)


def worst_error(row: Dict) -> float:
    return max(abs(row["stream_time_rel_err"]), abs(row["io_rel_err"]))


def _compare_point(
    shared,
    policies: Sequence[str],
    buffer_frac: float,
    bandwidth: float,
    time_slice: float,
    sample_interval: float,
    workload: str,
    stepper: str = "fixed",
    device="cuda",
) -> List[Dict]:
    """One (buffer point) comparison, both backends, one row per policy —
    the single harness behind the micro AND TPC-H suites.

    ``stepper`` selects the array time engine (fixed | horizon); the
    event-engine reference runs are cached in ``shared`` so validating
    both steppers pays for the slow dict engine once.

    Raises ``RuntimeError`` if the array run was truncated by the livelock
    guard — a truncated run reports lower bounds, not results.
    """
    db, ws, streams, spec, runners = shared[:5]
    ev_cache = shared[5] if len(shared) > 5 else {}
    cap = max(1 << 22, int(buffer_frac * ws))
    dev = resolve_device(device)
    rows: List[Dict] = []
    for pol in policies:
        ev_key = (pol, buffer_frac, bandwidth)
        if ev_key not in ev_cache:
            ev_cache[ev_key] = event_run(db, streams, pol, cap, bandwidth,
                                         time_slice, sample_interval)
        ev, ev_wall = ev_cache[ev_key]
        if (pol, stepper) not in runners:
            runners[(pol, stepper)] = make_runner(
                spec, bandwidth_ref=bandwidth, time_slice=time_slice,
                policies=(pol,), stepper=stepper, device=dev,
            )
        ar = run_workload_array(
            db, streams, pol, capacity_bytes=cap, bandwidth=bandwidth,
            time_slice=time_slice, spec=spec,
            runner=runners[(pol, stepper)], device=dev,
        )
        if ar.extras.get("truncated"):
            raise RuntimeError(
                f"array run truncated by the livelock guard at {workload} "
                f"buffer_frac={buffer_frac} policy={pol} "
                f"stepper={stepper} "
                f"({ar.extras['unfinished_streams']} unfinished streams "
                f"after {ar.sim_time:.1f}s sim time) — refusing to compare "
                "a lower bound against a finished event run"
            )
        rows.append(compare_row(workload, pol, stepper, buffer_frac, ev,
                                ev_wall, ar))
    return rows


def cross_validate(
    scale: float = 0.25,
    n_streams: int = 8,
    queries_per_stream: int = 16,
    seed: int = 3,
    buffer_frac: float = 0.4,
    bandwidth: float = 700e6,
    policies: Sequence[str] = DEFAULT_POLICIES,
    time_slice: Optional[float] = None,
    stepper: str = "fixed",
    device="cuda",
    _shared=None,
) -> List[Dict]:
    """Run event + array backends on one microbenchmark point; return one
    row per policy with both results and their relative differences."""
    if time_slice is None:
        time_slice = 0.1 * scale  # microbench convention
    if _shared is None:
        db = make_lineitem_db(scale_tuples=int(180_000_000 * scale))
        ws = micro_accessed_bytes(db)
        streams = micro_streams(db, n_streams=n_streams,
                                queries_per_stream=queries_per_stream,
                                seed=seed)
        _shared = (db, ws, streams, build_spec(db, streams), {}, {})
    return _compare_point(_shared, policies, buffer_frac, bandwidth,
                          time_slice, sample_interval=2.0, workload="micro",
                          stepper=stepper, device=device)


def cross_validate_sweep(
    fracs: Sequence[float] = DEFAULT_FRACS,
    scale: float = 0.25,
    steppers: Sequence[str] = ("fixed",),
    **kw,
) -> List[Dict]:
    """:func:`cross_validate` over several buffer points (and optionally
    both time engines), reusing the workload, spec, compiled runners AND
    the slow event-engine reference runs across points — capacity is a
    traced config scalar, so one runner serves the whole sweep, and the
    dict engine runs once per point however many steppers validate."""
    db = make_lineitem_db(scale_tuples=int(180_000_000 * scale))
    ws = micro_accessed_bytes(db)
    streams = micro_streams(db, n_streams=kw.get("n_streams", 8),
                            queries_per_stream=kw.get("queries_per_stream", 16),
                            seed=kw.get("seed", 3))
    spec = build_spec(db, streams)
    shared = (db, ws, streams, spec, {}, {})
    rows: List[Dict] = []
    for f in fracs:
        for stepper in steppers:
            rows.extend(cross_validate(scale=scale, buffer_frac=f,
                                       stepper=stepper, _shared=shared,
                                       **kw))
    return rows


def cross_validate_tpch(
    scale: float = 0.05,
    n_streams: int = 4,
    seed: int = 7,
    buffer_frac: float = 0.3,
    bandwidth: float = 600e6,
    policies: Sequence[str] = DEFAULT_POLICIES,
    time_slice: Optional[float] = None,
    stepper: str = "fixed",
    device="cuda",
    _shared=None,
) -> List[Dict]:
    """TPC-H cross-validation point: the §4.2 multi-table workload (8
    tables, 22 rotated query templates per stream, compiled through
    ``compiler.compile_workload``) run on both the event engine and the
    array backend via the same :func:`_compare_point` harness as the
    micro suite — all four paper policies."""
    if time_slice is None:
        time_slice = 0.1 * scale  # same scaling convention as the micro path
    if _shared is None:
        db = make_tpch_db(scale=scale)
        streams = tpch_streams(db, n_streams=n_streams, seed=seed)
        ws = tpch_accessed_bytes(db, streams)
        _shared = (db, ws, streams, compile_workload(db, streams), {}, {})
    return _compare_point(_shared, policies, buffer_frac, bandwidth,
                          time_slice, sample_interval=5.0, workload="tpch",
                          stepper=stepper, device=device)


def cross_validate_tpch_sweep(
    fracs: Optional[Sequence[float]] = None,
    scale: float = 0.05,
    steppers: Sequence[str] = ("fixed",),
    **kw,
) -> List[Dict]:
    """:func:`cross_validate_tpch` over the enforced TPC-H buffer points
    (default: every frac in ``TPCH_ERROR_BARS``), reusing the workload,
    compiled spec, runners, and event-engine reference runs across points
    (and steppers) — so the CLI measures the whole envelope, including
    the widened 0.5 LRU bar, not just the default operating point."""
    if fracs is None:
        fracs = sorted({f for (f, _pol) in TPCH_ERROR_BARS})
    db = make_tpch_db(scale=scale)
    streams = tpch_streams(db, n_streams=kw.get("n_streams", 4),
                           seed=kw.get("seed", 7))
    ws = tpch_accessed_bytes(db, streams)
    spec = compile_workload(db, streams)
    shared = (db, ws, streams, spec, {}, {})
    rows: List[Dict] = []
    for f in fracs:
        for stepper in steppers:
            rows.extend(cross_validate_tpch(scale=scale, buffer_frac=f,
                                            stepper=stepper,
                                            _shared=shared, **kw))
    return rows


def fit_bars_literal(rows: List[Dict]) -> str:
    """Render measured errors as ``ERROR_BARS`` / ``TPCH_ERROR_BARS``
    dict literals: measured worst error + 25% headroom, floored at the
    10% default, rounded up to the percent."""
    per_wl: Dict[str, Dict] = {}
    for r in rows:
        wl = r.get("workload", "micro")
        worst = worst_error(r)
        bar = max(0.10, math.ceil(worst * 1.25 * 100) / 100)
        key = (r["buffer_frac"], r["policy"])
        wl_bars = per_wl.setdefault(wl, {})
        # one bar per point covering EVERY validated stepper (the fixed
        # and horizon rows of one point fold into the max)
        wl_bars[key] = max(bar, wl_bars.get(key, 0.0))
    names = {"micro": "ERROR_BARS", "tpch": "TPCH_ERROR_BARS"}
    out = ["# measured worst error x1.25, >= 10% (the bars above are the "
           "JAX package's, not refit here):"]
    for wl in sorted(per_wl):
        out.append(f"{names.get(wl, wl.upper() + '_ERROR_BARS')} = {{")
        # deterministic key order — numeric frac ascending, then policy
        # name — so a refit diff is copy-paste stable (str-sorting put
        # (0.25, ...) before (0.1, ...) whenever both appeared)
        for (frac, pol), bar in sorted(per_wl[wl].items()):
            out.append(f"    ({frac}, {pol!r}): {bar:.2f},")
        out.append("}")
    return "\n".join(out)


def _print_rows(rows: List[Dict], enforce: bool = True) -> int:
    """Render rows; return the count outside the envelope (0 when
    ``enforce`` is off — the ``--fit-bars`` reporting mode)."""
    failed = 0
    for r in rows:
        wl = r.get("workload", "micro")
        bar, worst = bar_of(r), worst_error(r)
        ok = worst <= bar
        if enforce:
            failed += 0 if ok else 1
            verdict = "OK" if ok else f"FAIL (bar {bar:.0%})"
        else:
            verdict = f"measured {worst:.1%} (current bar {bar:.0%})"
        print(
            f"{wl:5s} buf={r['buffer_frac']:<4} {r['policy']:4s} "
            f"[{r.get('stepper', 'fixed'):7s}] "
            f"stream_time: event={r['event_stream_time_s']:.2f}s "
            f"array={r['array_stream_time_s']:.2f}s "
            f"({r['stream_time_rel_err']*100:+.1f}%) | io: "
            f"event={r['event_io_gb']:.3f}GB array={r['array_io_gb']:.3f}GB "
            f"({r['io_rel_err']*100:+.1f}%) | wall event={r['event_wall_s']:.2f}s "
            f"array={r['array_wall_s']:.2f}s | {verdict}"
        )
    return failed


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.25,
                    help="microbenchmark workload scale")
    ap.add_argument("--buffer-frac", type=float, default=None,
                    help="single micro point; default sweeps 0.1, 0.2, 0.4")
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--workload", choices=["micro", "tpch", "all"],
                    default="all",
                    help="which cross-validation suite(s) to run")
    ap.add_argument("--tpch-scale", type=float,
                    default=TPCH_DEFAULTS["scale"])
    ap.add_argument("--tpch-streams", type=int,
                    default=TPCH_DEFAULTS["n_streams"])
    ap.add_argument("--tpch-buffer-frac", type=float, default=None,
                    help="single TPC-H point; default sweeps every frac "
                         "in TPCH_ERROR_BARS")
    ap.add_argument("--fit-bars", action="store_true",
                    help="report measured errors without enforcing the "
                         "bars, and print them as ERROR_BARS / "
                         "TPCH_ERROR_BARS literals")
    ap.add_argument("--stepper", choices=["fixed", "horizon", "both"],
                    default="both",
                    help="array time engine(s) to validate; the bars are "
                         "enforced for BOTH by default (the event-engine "
                         "reference runs are shared, so the second "
                         "stepper costs only its array runs)")
    ap.add_argument("--device", default="cuda",
                    help="where the array runs go (cpu only when asked)")
    args = ap.parse_args()
    steppers = ("fixed", "horizon") if args.stepper == "both" \
        else (args.stepper,)
    rows: List[Dict] = []
    if args.workload in ("micro", "all"):
        fracs = [args.buffer_frac] if args.buffer_frac is not None else \
            list(DEFAULT_FRACS)
        rows.extend(cross_validate_sweep(
            fracs=fracs, scale=args.scale, n_streams=args.streams,
            queries_per_stream=args.queries, seed=args.seed,
            steppers=steppers, device=args.device,
        ))
    if args.workload in ("tpch", "all"):
        tpch_fracs = [args.tpch_buffer_frac] \
            if args.tpch_buffer_frac is not None else None
        rows.extend(cross_validate_tpch_sweep(
            fracs=tpch_fracs, scale=args.tpch_scale,
            n_streams=args.tpch_streams,
            bandwidth=TPCH_DEFAULTS["bandwidth"],
            seed=TPCH_DEFAULTS["seed"],
            steppers=steppers, device=args.device,
        ))
    failed = _print_rows(rows, enforce=not args.fit_bars)
    if args.fit_bars:
        print(fit_bars_literal(rows))
    if failed:
        print(f"{failed} point(s) outside the validated envelope",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
