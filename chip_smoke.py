#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the batched buffer-pool simulator (LRU /
PBM / OPT lanes, event-horizon stepper) — end to end on the card, builds
the hand-written CUDA kernels from the sources in this checkout, and
holds each kernel equal to its plain PyTorch version on the card.  It
imports nothing of JAX and nothing of the JAX package.

One JSON object per phase, one per line:

1. ``env``            torch / CUDA / nvcc versions, the card and its power limit
2. ``build``          compile the kernel library, seconds
3. ``kernels_fuzz``   every kernel against its plain version on the fuzz
                      shapes of the CPU tests (outputs must be EQUAL)
4. ``sim_small``      a tiny sweep on ``cuda`` and, asked for explicitly, on
                      ``cpu``: the two must agree
5. ``sim_calibrated`` micro workload, scale 0.25, 18 lanes = {lru, pbm, opt} x
                      buffer fractions {0.1 .. 1.0}, to completion
6. ``sim_full``       the same sweep at scale 1.0 (the paper's size: 180 M
                      tuples, P = 3072); to completion if the time limit
                      allows, else cut at a stated ``max_slices`` and
                      reported as truncated
7. ``tpch_probe``     a few slices of the TPC-H workload (P = 8832), only to
                      give the kernels that shape with real keys and sizes
8. ``kernels``        every kernel against its plain version on inputs
                      captured from phases 5-7, and its time (CUDA events,
                      median of 30 launches) beside the plain version's, one
                      PyTorch sort + cumsum as yardstick, and its bound

then the card's name and power limit as ``nvidia-smi`` prints them, then
``{"ok": true, "device": {...}}`` as the last line.  Any failed phase ends
the run with a non-zero exit code and no ``ok`` line; so does a machine
without a GPU, or a directory that holds this script and nothing else of
the repository.

``--phases a,b`` runs a subset (no ``ok`` line, exit code 3): that is for
development, the check is the run without arguments.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

TIME_LIMIT_S = 1200.0          # the whole script, kernel build included
TARGET_S = 560.0               # aim to finish in about half of it
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside the tensor cores
SOURCE = "src/repro_torch/kernels/csrc/pbm_timeline.cu"
REPLACES = {
    "batched_evict": "src/repro/kernels/pbm_timeline.py:316",
    "fifo_grant": "src/repro/kernels/pbm_timeline.py:269",
    "wake_solve": "src/repro/kernels/pbm_timeline.py:367",
}
POLICIES = ("lru", "pbm", "opt")
FRACS = (0.1, 0.2, 0.4, 0.6, 0.8, 1.0)
T0 = time.time()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, why: str) -> None:
    emit({"phase": phase, "ok": False, "error": why})
    raise SystemExit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


# --------------------------------------------------------------- kernels ----

def _to_dev(case, fields, dev):
    import numpy as np
    import torch
    return [torch.from_numpy(np.ascontiguousarray(case[f])).to(dev)
            for f in fields]


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _compare(got, want):
    """(mismatching elements, max abs difference) over all outputs."""
    bad, err = 0, 0.0
    for g, w in zip(_as_tuple(got), _as_tuple(want)):
        bad += int((g != w).sum())
        err = max(err, float((g.double() - w.double()).abs().max())
                  if g.numel() else 0.0)
    return bad, err


def kernel_fns():
    from repro_torch.kernels import ops, ref
    return {
        "batched_evict": (ops.batched_evict, ref.batched_evict_ref),
        "fifo_grant": (ops.fifo_grant, ref.fifo_grant_ref),
        "wake_solve": (ops.wake_solve, ref.wake_solve_ref),
    }


def phase_kernels_fuzz(dev) -> None:
    from repro_torch.kernels import cases
    fns = kernel_fns()
    out = {"phase": "kernels_fuzz", "device": str(dev), "tolerance": 0}
    for name, make in cases.CASES.items():
        kernel, plain = fns[name]
        n_cases = bad = 0
        err = 0.0
        for case in make():
            args = _to_dev(case, cases.TENSOR_FIELDS[name], dev)
            got = kernel(*args, **case["static"])
            b, e = _compare(got, plain(*args, **case["static"]))
            if b:
                emit({"phase": "kernels_fuzz", "kernel": name,
                      "case": case["name"], "mismatches": b})
            bad += b
            err = max(err, e)
            n_cases += 1
        out[name] = {"cases": n_cases, "mismatches": bad, "max_abs_err": err}
    out["ok"] = all(out[k]["mismatches"] == 0 for k in fns)
    emit(out)
    if not out["ok"]:
        fail("kernels_fuzz", "a kernel disagrees with its plain version")


class Recorder:
    """Keeps a sample of the inputs the simulator hands to each kernel:
    wraps the three functions of ``repro_torch.kernels.ops`` (which the
    step calls through the module) while a run is captured.  Every
    ``STRIDE``-th call is cloned; ``seconds`` is the host time that took,
    which the sweep's wall time includes."""

    STRIDE, CAP = 97, 12

    def __init__(self):
        self.samples = {}      # (kernel, P) -> [(args, static), ...]
        self._calls = {}
        self.seconds = 0.0

    def __enter__(self):
        from repro_torch.kernels import ops
        self._ops = ops
        self._orig = {n: getattr(ops, n) for n in REPLACES}
        for name, fn in self._orig.items():
            setattr(ops, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self._ops, name, fn)

    def _wrap(self, name, fn):
        def wrapped(*args, **static):
            i = self._calls[name] = self._calls.get(name, 0) + 1
            if i % self.STRIDE == 0:
                t0 = time.perf_counter()
                got = self.samples.setdefault((name, args[0].shape[1]), [])
                if len(got) >= self.CAP:    # keep the run covered: thin out
                    del got[::2]
                got.append(([a.clone() for a in args], dict(static)))
                self.seconds += time.perf_counter() - t0
            return fn(*args, **static)
        return wrapped


def _work(name, args) -> int:
    """How much a captured input asks of its kernel (pages taking part)."""
    if name == "batched_evict":
        _key, _sizes, evictable, need = args
        return int((evictable & (need > 0).unsqueeze(1)).sum())
    return int((args[0] >= 0).sum())


def _time_ms(fn, dev, n: int = 30, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _library_call(name, args):
    """One PyTorch sort + cumsum over (L, P): what a library would spend on
    the ordering and the byte prefix that each kernel needs.  A yardstick
    only; the port never calls it."""
    import torch
    key, sizes = args[0], args[1]

    def call():
        order = torch.sort(key, dim=1, descending=True, stable=True)[1]
        return torch.cumsum(
            sizes.expand_as(key).gather(1, order).double(), dim=1)
    return call


def _bound_ms(name, args, outs):
    """Least time the card could take: every input read once and every
    output written once at the memory rate, against one comparison per
    page per level of a sort plus one add per page at the f32 rate."""
    import math
    nbytes = sum(t.numel() * t.element_size() for t in args)
    nbytes += sum(t.numel() * t.element_size() for t in _as_tuple(outs))
    L, P = args[0].shape
    n_ops = L * P * (max(1.0, math.log2(P)) + 1.0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(dev, recorder: Recorder, launches: dict, main_p: int) -> dict:
    """Kernel against plain version on the captured simulator inputs, and
    the timings.  ``main_p`` is the page count of the main path whose
    numbers go into the top-level keys of each kernel's entry."""
    import torch
    fns = kernel_fns()
    entries = []
    for name in REPLACES:
        kernel, plain = fns[name]
        bad, err, n_inputs = 0, 0.0, 0
        by_p = {}
        for (kname, P), samples in sorted(recorder.samples.items()):
            if kname != name:
                continue
            for args, static in samples:
                got = kernel(*args, **static)
                b, e = _compare(got, plain(*args, **static))
                bad, err, n_inputs = bad + b, max(err, e), n_inputs + 1
            args, static = max(samples, key=lambda s: _work(name, s[0]))
            outs = kernel(*args, **static)
            bound, bound_by = _bound_ms(name, args, outs)
            by_p[P] = {
                "L": int(args[0].shape[0]), "P": int(P), **static,
                "pages_taking_part": _work(name, args),
                "ms": _time_ms(lambda: kernel(*args, **static), dev),
                "plain_ms": _time_ms(lambda: plain(*args, **static), dev),
                "library_ms": _time_ms(_library_call(name, args), dev),
                "bound_ms": bound, "bound_by": bound_by,
            }
        if main_p not in by_p:
            fail("kernels", f"{name}: no input captured at P={main_p}")
        main = by_p[main_p]
        entry = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "mismatches": bad, "inputs_compared": n_inputs,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shapes": list(by_p.values()),
        }
        if name == "batched_evict":
            # the integer-key instantiation: the simulator's policies all
            # give f32 scores, so it is timed on the main path's input with
            # the score's bits read as an integer key
            args, static = max(recorder.samples[(name, main_p)],
                               key=lambda s: _work(name, s[0]))
            ikey = args[0].clamp(min=0.0).view(torch.int32)
            iargs = [ikey, *args[1:]]
            b, e = _compare(kernel(*iargs, **static), plain(*iargs, **static))
            entry["i32_key"] = {
                "mismatches": b, "max_abs_err": e,
                "ms": _time_ms(lambda: kernel(*iargs, **static), dev),
                "plain_ms": _time_ms(lambda: plain(*iargs, **static), dev),
            }
            bad += b
            entry["mismatches"] = bad
        entries.append(entry)
    line = {"kernels": entries}
    if any(e["mismatches"] for e in entries):
        emit(line)
        fail("kernels", "a kernel disagrees with its plain version on the "
                        "simulator's inputs")
    return line


# ------------------------------------------------------------- simulator ----

def micro_workload(scale: float, n_streams: int, queries: int, seed: int = 3):
    from repro_torch.core.array_sim import compile_workload
    from repro_torch.core.workload import (
        make_lineitem_db, micro_accessed_bytes, micro_streams)
    db = make_lineitem_db(scale_tuples=int(180_000_000 * scale))
    streams = micro_streams(db, n_streams=n_streams,
                            queries_per_stream=queries, seed=seed)
    return compile_workload(db, streams), micro_accessed_bytes(db)


def sweep_configs(spec, ws, fracs, dev, bandwidth=700e6):
    from repro_torch.core.array_sim import make_config, stack_configs
    lanes = [(p, f) for p in POLICIES for f in fracs]
    cfgs = stack_configs([
        make_config(spec, int(f * ws), bandwidth, p, device=dev)
        for p, f in lanes])
    return lanes, cfgs


def lane_rows(lanes, results):
    return [{
        "policy": p, "frac": f,
        "avg_stream_time": r.avg_stream_time, "io_gb": r.io_gb,
        "loads": r.total_loads, "macro_steps": r.extras["macro_steps"],
        "skipped_time": r.extras["skipped_time"],
        "slices_done": r.extras["slices_done"],
        "truncated": r.extras["truncated"],
    } for (p, f), r in zip(lanes, results)]


def run_sweep_counted(spec, cfgs, dev, **runner_kw):
    """One stacked call through the port's entry points, with the kernels'
    launch counts set to 0 just before and read just after."""
    from repro_torch.core.array_sim import make_runner, run_sweep
    from repro_torch.kernels import ops
    runner = make_runner(spec, policies=POLICIES, device=dev, **runner_kw)
    ops.reset_launch_counts()
    t0 = time.time()
    results = run_sweep(spec, cfgs, runner=runner, device=dev)
    wall = time.time() - t0
    launches = ops.launch_counts()
    steps = runner.stats["cheap_steps"] + runner.stats["refresh_steps"]
    return results, wall, launches, steps, dict(runner.stats)


def phase_sim_small(dev) -> None:
    import torch
    scale, fracs = 0.03, (0.2, 0.4, 0.8)
    spec, ws = micro_workload(scale, 3, 3)
    kw = dict(time_slice=0.1 * scale)
    lanes, cfgs = sweep_configs(spec, ws, fracs, dev)
    on_dev, wall, launches, steps, _ = run_sweep_counted(spec, cfgs, dev, **kw)
    cpu = torch.device("cpu")   # asked for explicitly: a comparison
    _, cfgs_cpu = sweep_configs(spec, ws, fracs, cpu)
    on_cpu, _, _, _, _ = run_sweep_counted(spec, cfgs_cpu, cpu, **kw)
    rows, ok, all_equal = [], True, True
    for (p, f), a, b in zip(lanes, on_dev, on_cpu):
        tol = 0.12 if f < 0.4 else 0.05
        rel = {
            "avg_stream_time": a.avg_stream_time / b.avg_stream_time - 1.0,
            "total_io_bytes": a.total_io_bytes / b.total_io_bytes - 1.0,
            "total_loads": a.total_loads / b.total_loads - 1.0,
        }
        equal = all(v == 0.0 for v in rel.values()) and a.steps == b.steps
        all_equal &= equal
        lane_ok = (not a.extras["truncated"] and not b.extras["truncated"]
                   and all(abs(v) <= tol for v in rel.values()))
        ok &= lane_ok
        rows.append({"policy": p, "frac": f, "tolerance": tol, "rel": rel,
                     "equal": equal, "ok": lane_ok})
    emit({"phase": "sim_small", "P": spec.n_pages, "lanes": rows,
          "device_equals_cpu": all_equal, "wall_s": wall,
          "batched_steps": steps, "launches": launches, "ok": ok})
    if not ok:
        fail("sim_small", "the card and the CPU disagree beyond tolerance")


def phase_sim_micro(phase: str, scale: float, dev, recorder: Recorder,
                    max_slices=None):
    spec, ws = micro_workload(scale, n_streams=8, queries=16)
    lanes, cfgs = sweep_configs(spec, ws, FRACS, dev)
    kw = dict(time_slice=0.1 * scale, bandwidth_ref=700e6)
    if max_slices is not None:
        kw["max_slices"] = max_slices
    captured = recorder.seconds
    with recorder:
        results, wall, launches, steps, stats = run_sweep_counted(
            spec, cfgs, dev, **kw)
    captured = recorder.seconds - captured
    rows = lane_rows(lanes, results)
    truncated = any(r["truncated"] for r in rows)
    out = {
        "phase": phase, "scale": scale, "P": spec.n_pages,
        "S": spec.n_streams, "Q": spec.n_queries, "C": spec.n_cols,
        "L": len(lanes), "lanes": rows, "wall_s": wall,
        "capture_s": captured,      # part of wall_s: cloning kernel inputs
        "batched_steps": steps, **stats,
        "ms_per_macro_step": wall / max(1, steps) * 1e3,
        "launches": launches, "truncated": truncated,
        "max_slices": max_slices,
        "sim_seconds_covered": max(r.sim_time for r in results),
    }
    out["ok"] = all(v > 0 for v in launches.values())
    if max_slices is None:
        out["ok"] = out["ok"] and not truncated
    emit(out)
    if not out["ok"]:
        fail(phase, "a lane ended truncated or a kernel was never launched")
    return out


def phase_tpch_probe(dev, recorder: Recorder, max_slices: int = 16) -> None:
    """A few slices of the TPC-H throughput workload (8 tables, P = 8832):
    not a result, only real keys and page sizes at that page count for the
    kernels' comparison and timing."""
    from repro_torch.core.array_sim import compile_workload
    from repro_torch.core.workload import (
        make_tpch_db, tpch_accessed_bytes, tpch_streams)
    db = make_tpch_db(scale=1.0)
    streams = tpch_streams(db, n_streams=8, seed=7)
    spec = compile_workload(db, streams)
    ws = tpch_accessed_bytes(db, streams)
    _, cfgs = sweep_configs(spec, ws, FRACS, dev, bandwidth=600e6)
    with recorder:
        results, wall, launches, steps, _ = run_sweep_counted(
            spec, cfgs, dev, time_slice=0.1, bandwidth_ref=600e6,
            max_slices=max_slices)
    emit({"phase": "tpch_probe", "P": spec.n_pages, "C": spec.n_cols,
          "Q": spec.n_queries, "max_slices": max_slices, "truncated": True,
          "wall_s": wall, "batched_steps": steps,
          "ms_per_macro_step": wall / max(1, steps) * 1e3,
          "sim_seconds_covered": max(r.sim_time for r in results),
          "launches": launches, "ok": True})


# ------------------------------------------------------------------ main ----

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="",
                    help="comma-separated subset of the phases (development)")
    ap.add_argument("--full-max-slices", type=int, default=None,
                    help="cut sim_full at this many slices")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    from repro_torch.kernels import _build, pbm_timeline

    all_phases = ["env", "build", "kernels_fuzz", "sim_small",
                  "sim_calibrated", "sim_full", "tpch_probe", "kernels"]
    phases = [p for p in args.phases.split(",") if p] or all_phases
    unknown = set(phases) - set(all_phases)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; known: {all_phases}")

    if "env" in phases:
        env = {"phase": "env", "python": sys.version.split()[0],
               "torch": torch.__version__, "cuda_runtime": torch.version.cuda}
        env["nvcc"] = subprocess.run(
            [_build.find_nvcc(), "--version"], capture_output=True,
            text=True, check=True).stdout.strip().splitlines()[-2:]
        env["gpu"] = nvidia_smi_line()
        env["device_name"] = torch.cuda.get_device_name(0)
        emit(env)

    if "build" in phases:
        t0 = time.time()
        pbm_timeline.library(dev)
        out = {"phase": "build", "seconds": time.time() - t0,
               "nvcc_seconds": _build.build_seconds, "source": SOURCE,
               "flags": list(_build.NVCC_FLAGS)}
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        if os.path.exists(cuobjdump):
            lib = next(_build.build_dir().glob("libpbm_timeline_*.so"))
            res = subprocess.run([cuobjdump, "-res-usage", str(lib)],
                                 capture_output=True, text=True).stdout
            out["resource_usage"] = [
                ln.strip() for ln in res.splitlines() if "REG:" in ln]
        emit(out)

    if "kernels_fuzz" in phases:
        phase_kernels_fuzz(dev)
    if "sim_small" in phases:
        phase_sim_small(dev)

    recorder = Recorder()
    launches, main_p, calibrated = None, None, None
    if "sim_calibrated" in phases:
        calibrated = phase_sim_micro("sim_calibrated", 0.25, dev, recorder)
        launches, main_p = calibrated["launches"], calibrated["P"]
    if "sim_full" in phases:
        max_slices = args.full_max_slices
        if max_slices is None and calibrated is not None:
            # scale 1.0 takes roughly four times the macro-steps of scale
            # 0.25 at a similar cost per step: run it to its end only if
            # that fits what is left of the target
            budget = TARGET_S - (time.time() - T0) - 60.0
            predicted = 4.5 * calibrated["wall_s"]
            if predicted > budget:
                per_slice = (calibrated["batched_steps"]
                             / max(1, calibrated["refresh_steps"]))
                ms = calibrated["ms_per_macro_step"]
                max_slices = max(8, int(budget * 1e3 / (ms * 4.0 * per_slice)))
        full = phase_sim_micro("sim_full", 1.0, dev, recorder,
                               max_slices=max_slices)
        launches, main_p = full["launches"], full["P"]
    if "tpch_probe" in phases:
        phase_tpch_probe(dev, recorder)

    kernels_line = None
    if "kernels" in phases:
        if launches is None:
            fail("kernels", "needs sim_calibrated or sim_full in the same run")
        kernels_line = phase_kernels(dev, recorder, launches, main_p)

    emit({"phase": "total", "seconds": time.time() - T0,
          "time_limit_s": TIME_LIMIT_S})
    if kernels_line is not None:
        emit(kernels_line)
    if phases != all_phases:
        emit({"ok": False, "partial": True, "phases": phases,
              "device": str(dev)})
        return 3
    if any(e["launches"] <= 0 for e in kernels_line["kernels"]):
        fail("kernels", "a kernel of the main path was never launched")
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
