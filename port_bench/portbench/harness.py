"""One run of one cell: set-up, the timed window (``--trace 0``) or the
traced window and then the timed one (``--trace 1``), the check against
the plain reference, and the result line.

The window runs prefix sweeps back to back: every lane of the cell from
t = 0 to the prefix time ``T`` (:func:`workloads.prefix_time`), each sweep
one call of the program's runner ending in a synchronise.  It runs from
the first timed sweep's start to the end of the last sweep that the
window's ``seconds`` hold (at least one).  Set-up is everything before it:
imports, the kernels' build (found in the checkout's build directory after
the first run), the workload's generation and ``compile_workload``, the
runner and its configs, and one warm sweep cut at the traffic's
``short_sim_s``, which captures every graph variant the window replays (the
configs differ from the window's in ``max_time`` alone, so the runner
replays the same graphs).  The traced window is a sweep cut there too.

After the window, with the peak memory read and the program's state
freed, the reference steps the same sweep eagerly on the same device
(:mod:`portbench.check`); its time counts in neither set-up nor window.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import signal
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

from . import cells, check, program, trace as tracing, workloads

#: top-level module names that may not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: seconds the warm sweep (it captures the graphs) may take before the run
#: counts it as an answer that never came
WARM_DEADLINE_S = 150.0
#: a timed sweep may take this many times the warm one's wall a simulated
#: second (at least ``MIN_DEADLINE_S``) before it counts as never coming
DEADLINE_FACTOR, MIN_DEADLINE_S = 4.0, 30.0


class NoChip(RuntimeError):
    """The run cannot measure here: no card, or fewer than the cell asks."""


class Overrun(RuntimeError):
    """A sweep did not end within its deadline."""


@dataclass
class Prefix:
    """One prefix sweep of the window."""

    wall_s: float
    steps: int                 # the runner's macro-steps (cheap + refresh)
    state: object = None       # the final state until the check reads it
    lanes: List[check.LaneResult] = field(default_factory=list)


@dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py``)."""

    cell: cells.Cell
    lanes: int
    pages: int
    device_kind: str
    setup_s: float
    window_s: float = 0.0
    prefixes: List[Prefix] = field(default_factory=list)
    trace: Optional[tracing.Trace] = None


def forbidden_modules() -> List[str]:
    """The forbidden top-level names among the loaded modules."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@contextmanager
def deadline(seconds: float):
    """Raise :class:`Overrun` in this thread after ``seconds``."""
    def on_alarm(signum, frame):
        raise Overrun(f"a sweep ran past its deadline of {seconds:.0f} s")
    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _environment(root: Path) -> None:
    """Every cache of the program at a fixed path inside the checkout."""
    cache = root / ".port_bench_cache"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(
        root / "src" / "repro_torch" / "kernels" / "_build")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def _import_program(root: Path) -> None:
    """Import the program from the checkout's ``src``, and nowhere else."""
    src = root / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise ImportError(f"the program is not in this checkout ({src})")
    sys.path.insert(0, str(src))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parent != (src / "repro_torch").resolve():
        raise ImportError(f"repro_torch came from {repro_torch.__file__}, "
                          f"not from {src}")


def _graphs(sweep) -> int:
    """The CUDA graphs the runner has captured (0 on the CPU): a diagnostic
    that the window captured none."""
    return sum(len(r.graphs) for r in getattr(sweep.runner, "_replays", {}).values())


def _sweep_once(sweep, cfgs, seconds: float) -> Prefix:
    t0 = time.perf_counter()
    with deadline(seconds):
        state, stats = sweep.run(cfgs)
        _sync(sweep.device)
    wall = time.perf_counter() - t0
    return Prefix(wall_s=wall,
                  steps=stats["cheap_steps"] + stats["refresh_steps"], state=state)


def execute(root: Path, cell_name: str, seed: int, seconds: float,
            traced: bool, t0: float, device: str = "cuda",
            warm_deadline_s: float = WARM_DEADLINE_S,
            here: Path = cells.HERE) -> dict:
    """One run; returns the result line's object.  Raises :class:`NoChip`
    on a CUDA device that is missing.  ``here`` is the benchmark's folder
    (its traffic, limits and metrics)."""
    cell = cells.load(root, cell_name, here)
    if cell.traffic["stepper"] != "horizon" or not cell.config["wake_exact"]:
        raise ValueError(f"{cell_name}: the reference runs the horizon stepper "
                         "with wake_exact only")
    _environment(root)
    import torch
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoChip(f"{cell_name} needs {cell.chips} CUDA device(s); "
                         f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
                         f"device_count() = {torch.cuda.device_count()}")
        device = "cuda:0"
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    torch.set_num_threads(2)
    _import_program(root)

    # ---------------------------------------------------------- set-up --
    marks = {"imports": time.time() - t0}
    work = workloads.generate(cell.config, seed)
    T = workloads.prefix_time(cell.config, cell.traffic, work)
    marks["generate"] = time.time() - t0
    sweep = program.Sweep(cell.config, cell.traffic, work, device)
    cfgs = sweep.configs(T)
    marks["compile_and_runner"] = time.time() - t0
    L = len(sweep.lanes)
    run = Run(cell=cell, lanes=L, pages=int(sweep.spec.n_pages),
              device_kind=kind, setup_s=0.0)
    checks = {}
    overrun = None
    short = min(T, float(cell.traffic["short_sim_s"]))
    scfgs = sweep.configs(short)
    try:
        warm = _sweep_once(sweep, scfgs, warm_deadline_s)
        run.setup_s = time.time() - t0
        graphs = _graphs(sweep)
        marks["warm_sweep"] = run.setup_s
        print(f"set-up {run.setup_s:.3f} s (ends of its parts: "
              + ", ".join(f"{k} {v:.3f}" for k, v in marks.items())
              + f"), P = {run.pages}, L = {L}, T = {T:.6f} s, warm sweep "
              f"{warm.wall_s:.3f} s, {warm.steps} macro-steps",
              file=sys.stderr, flush=True)
        limit_s = max(MIN_DEADLINE_S, DEADLINE_FACTOR * warm.wall_s * T / short)
        del warm
        if traced:
            def window() -> int:
                return _sweep_once(sweep, scfgs, limit_s).steps
            run.trace = tracing.profile(window)
        # ------------------------------------------------------ window --
        start = time.perf_counter()
        while True:
            p = _sweep_once(sweep, cfgs, limit_s)
            run.prefixes.append(p)
            elapsed = time.perf_counter() - start
            if elapsed + p.wall_s > seconds:
                break
        run.window_s = elapsed
        print("sweeps (wall s, macro-steps): " + ", ".join(
            f"{p.wall_s:.4f} {p.steps}" for p in run.prefixes)
            + f"; graphs captured in set-up {graphs}, after the window "
            f"{_graphs(sweep)}", file=sys.stderr)
    except Overrun as e:
        overrun = str(e)
        print(f"overrun: {e}", file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(device) if kind != "cpu" else 0

    # ----------------------------------------------------------- check --
    for p in run.prefixes:
        p.lanes = check.answers(p.state, work)
        p.state = None
    del sweep, cfgs, scfgs
    gc.collect()
    if kind != "cpu":
        torch.cuda.empty_cache()
    attempted = L * (len(run.prefixes) + (1 if overrun else 0))
    failed = L if overrun else 0
    lanes = program.lanes(cell.traffic)
    if run.prefixes:
        t_ref = time.time()
        want = check.reference_answers(cell.config, work, lanes, T, device)
        _sync(device)
        limit = {k: cell.limits[k]["limit"] for k in check.NUMBERS}
        worst = {k: (0.0, "") for k in check.NUMBERS}
        short = 0.0
        for k, p in enumerate(run.prefixes):
            g = check.gaps(p.lanes, want)
            for i in range(L):
                late = max(0.0, T - p.lanes[i].sim_s)
                if late > 0.0 or any(g[n][i] > limit[n] for n in check.NUMBERS):
                    failed += 1
                for n in check.NUMBERS:
                    if g[n][i] > worst[n][0]:
                        worst[n] = (g[n][i], "%s@%s, sweep %d" % (*lanes[i], k))
                short = max(short, late)
        print(f"reference {time.time() - t_ref:.3f} s; lanes (policy@fraction: "
              "tuples, bytes loaded, end; the reference's): " + "; ".join(
                  f"{p}@{f}: {r.tuples!r} {r.io_bytes!r} {r.sim_s!r}, "
                  f"{w.tuples!r} {w.io_bytes!r} {w.sim_s!r}"
                  for (p, f), r, w in zip(lanes, run.prefixes[0].lanes, want)),
              file=sys.stderr)
        for name, (value, where) in worst.items():
            checks[name] = {"value": value, "limit": limit[name], "worst": where}
        checks["short_s"] = {"value": short, "limit": 0.0}
    if overrun:
        checks["overrun"] = {"value": 1, "limit": 0}
    correct = (overrun is None and bool(run.prefixes) and failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    # --------------------------------------------------------- metrics --
    metrics = {}
    if run.prefixes:
        for m in (cell.per_layer if traced else cell.end_to_end):
            v = cells.reader(m["name"], here)(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    for k, c in checks.items():
        extra = f" ({c['worst']})" if "worst" in c else ""
        print(f"check {k} {c['value']!r} limit {c['limit']!r}{extra}",
              file=sys.stderr)
    return out


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    if not (root / "BENCHMARK.json").is_file():
        print("run from the checkout's root: no BENCHMARK.json here",
              file=sys.stderr)
        return 2
    try:
        out = execute(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), t0)
    except NoChip as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"no result: the process loaded {bad}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
