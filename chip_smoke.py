#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three paths end to end on the card — the batched
buffer-pool simulator (LRU / PBM / OPT / array-CScan lanes in one call,
the event-horizon and the fixed-dt stepper, held to the port's event
engine inside the JAX package's error bars), the
paged-KV serving path (page pool, policy driver, continuous-batching
engine, ``PagedTinyLM`` decoding through paged attention) and the model
stack's serving path (dense LM, Mamba2 hybrid and xLSTM at full width
through flash attention, the Mamba2 scan and the mLSTM) — builds the
hand-written CUDA kernels from the sources in this checkout, and holds
each kernel to its plain PyTorch version on the card.  It imports nothing
of JAX and nothing of the JAX package.

One JSON object per phase, one per line:

1. ``env``            torch / CUDA / nvcc versions, the card and its power limit
2. ``build``          compile the kernel libraries (one ``nvcc`` per source,
                      all at once), seconds; per kernel the registers,
                      stack and local memory that ``cuobjdump -res-usage``
                      reads from the library (and ptxas -v's lines for the
                      builds this run made), per library the SASS count of
                      HGMMA / HMMA / UTMALDG / UBLKCP / LDGSTS:
                      flash_attention must show HGMMA and UTMALDG,
                      paged_attention LDGSTS or UBLKCP, mamba2_scan and
                      mlstm HGMMA or HMMA, pbm_timeline no tensor-core
                      instruction; no kernel of those four libraries (mlstm's
                      f32 and bf16 kernels all listed), and none of
                      batched_evict (both key types), fifo_grant and
                      wake_solve, may have a stack frame or use local memory
3. ``kernels_fuzz``   every buffer-pool kernel against its plain version on
                      the fuzz shapes of the CPU tests (outputs must be EQUAL);
                      per kernel the lanes that took each path (nothing to
                      do, head selected, whole row sorted, and for
                      batched_evict every page a candidate: computed on the
                      host), each path at least once
4. ``paged_fuzz``     paged attention against its plain version on its fuzz
                      cases, f32 and bf16 (atol = rtol = 3e-5 / 3e-2), and
                      in bf16 against the plain version on the inputs cast
                      to f32 (normwise relative error, over the output and
                      over each CTA's block, <= NORMWISE_TOL)
5. ``model_fuzz``     flash attention, the Mamba2 scan and the mLSTM against
                      their plain versions on their fuzz cases, f32 and bf16
                      (their bf16 also as in 4, each block a CTA's tile:
                      for the scans a 128-step chunk of one head)
6. ``sim_small``      a tiny sweep of the four policies on ``cuda`` and,
                      asked for explicitly, on ``cpu``, under both
                      steppers: the two must agree
7. ``serve_small``    ``TinyConfig()`` with the same weights on ``cuda`` and,
                      asked for explicitly, on ``cpu``, at the serving
                      benchmark's default point under all four policies:
                      equal stats, token gaps and finish order, every
                      forward's logits within 1e-4
8. ``model_serve``    the model stack's serving path at the full widths of
                      qwen2_1_5b, zamba2_2_7b and xlstm_350m in bf16 (random
                      weights from seed 0): prefill of 4 x 4,096 tokens (and
                      1 x 32,768 for the attention families), 32 decode steps
                      at B = 8; then decode-vs-prefill in f32 on 16 tokens
9. ``sim_calibrated`` micro workload, scale 0.25, 24 lanes = {lru, pbm, opt,
                      cscan} x buffer fractions {0.1 .. 1.0}, horizon
                      stepper, to completion; its 12 lanes at 0.1 / 0.2 /
                      0.4 held to the port's event engine (run on the
                      host in worker processes meanwhile) within
                      ``validate.ERROR_BARS``
10. ``sim_fixed``     the fixed-dt stepper on the card at the same scale: the
                      lanes of those 12 that fit its time budget (cscan at
                      0.2 and 0.4 always), held to the same event runs
                      within the same bars; the line names the lanes left
                      out and why
11. ``serve_full``    ``PagedTinyLM`` at Qwen2-1.5B's attention widths and
                      depth (28 layers, d 1536, 12 query / 2 KV heads of 128,
                      vocabulary 151,936; random weights from a seed) at the
                      default point under ``pbm``, to completion
12. ``sim_full``      the same sweep at scale 1.0 (the paper's size: 180 M
                      tuples, P = 3072); to completion if the time limit
                      allows, else cut at a stated ``max_slices`` and
                      reported as truncated
13. ``tpch_probe``    a few slices of the TPC-H workload (P = 8832), only to
                      give the kernels that shape with real keys and sizes
14. ``kernels``       every kernel against its plain version on inputs
                      captured from phases 8-13, and its time per call
                      (``ms``: CUDA events around one call, median of up to
                      30) beside the plain version's, a PyTorch yardstick
                      and its bound; also ``device_ms`` and ``host_ms``
                      (``_queued_ms``: launches queued behind a sleep, the
                      device's time and the host's time to issue one);
                      the buffer-pool kernels with the lanes of the
                      captured inputs that took each path, by policy, and
                      the cooperative (cscan) lanes' rows also held to
                      the plain version on their own; the Mamba2 scan
                      and the mLSTM with the CUDA kernels one call launches
                      (profiler; each of their passes once, else the phase
                      fails); paged attention also at a deployment's batch
                      (B = 32, 1024-4096 tokens); B4's to B7's bf16 inputs
                      held to f32 as in 4

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
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

TIME_LIMIT_S = 1200.0          # the whole script, kernel build included
#: what the whole script aims at: the serving phases take ~100 s before
#: sim_full, so this is the first slice's 560 s plus that, to leave sim_full
#: the budget it had before them
TARGET_S = 680.0
#: kept for the phases after sim_full (tpch_probe, kernels), and for the
#: kernels phase's timing of the model-stack kernels
TAIL_S, MODEL_KERNELS_S = 60.0, 40.0
#: a scale-1.0 macro-step (P = 3072) over a scale-0.25 one (P = 768): 7.40
#: against 4.94 ms on an H100 80GB HBM3 at 700 W (sim_full and
#: sim_calibrated of one run of this script); sim_full's budget reads it
FULL_STEP_COST = 1.5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside the tensor cores
SOURCE = {
    "batched_evict": "src/repro_torch/kernels/csrc/pbm_timeline.cu",
    "fifo_grant": "src/repro_torch/kernels/csrc/pbm_timeline.cu",
    "wake_solve": "src/repro_torch/kernels/csrc/pbm_timeline.cu",
    "paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "mamba2_scan": "src/repro_torch/kernels/csrc/mamba2_scan.cu",
    "mlstm_chunked": "src/repro_torch/kernels/csrc/mlstm.cu",
}
REPLACES = {
    "batched_evict": "src/repro/kernels/pbm_timeline.py:316",
    "fifo_grant": "src/repro/kernels/pbm_timeline.py:269",
    "wake_solve": "src/repro/kernels/pbm_timeline.py:367",
    "paged_attention": "src/repro/kernels/paged_attention.py:94",
    "flash_attention": "src/repro/kernels/flash_attention.py:99",
    "mamba2_scan": "src/repro/kernels/mamba2_scan.py:80",
    "mlstm_chunked": "src/repro/kernels/mlstm.py:84",
}
MODEL_KERNELS = ("flash_attention", "mamba2_scan", "mlstm_chunked")
#: the model stack's serving path: three families at their full published
#: widths (src/repro_torch/configs), bf16, weights drawn on the card
MODEL_ARCHS = ("qwen2_1_5b", "zamba2_2_7b", "xlstm_350m")
#: prefill: B = 4 prompts of 4,096 tokens; the attention families also take
#: one sequence of prefill_32k's 32,768 tokens (one chip's share of it)
MODEL_PREFILL = ((4, 4096), (1, 32_768))
LONG_PREFILL_ARCHS = ("qwen2_1_5b", "zamba2_2_7b")
#: decode: 32 tokens at B = 8 from an empty cache of 4,096 positions
MODEL_DECODE = dict(batch=8, steps=32, cache=4096)
#: decode-vs-prefill in f32 at full width: the JAX model test's bar
DECODE_PREFILL_TOKENS, DECODE_PREFILL_TOL = 16, 2e-2
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
SIM_KERNELS = ("batched_evict", "fifo_grant", "wake_solve")
POLICIES = ("lru", "pbm", "opt", "cscan")
SERVING_POLICIES = ("lru", "cscan", "pbm", "opt")
#: benchmarks/serving_bench.py DEFAULT_POINT (copied: that module imports the
#: JAX package): the pool holds ~60 % of peak demand, half the requests share
#: a 64-token system prompt, one arrival per engine step
SERVE_POINT = dict(
    n_requests=32, pool_pages=28, page_size=16, prefix_len=64,
    share_ratio=0.5, max_batch=8, arrival_interval=1,
    gen_lo=16, gen_hi=160, seed=1,
)
#: PagedTinyLM's block at the attention widths and depth of
#: src/repro/configs/qwen2_1_5b.py (not Qwen2-1.5B: GELU MLP of 4 d, no
#: RoPE, norms or QKV bias)
QWEN2_1_5B_WIDTHS = dict(
    vocab=151936, d_model=1536, n_layers=28, n_heads=12, n_kv_heads=2,
    head_dim=128, page_size=16, n_pages=28,
)
FRACS = (0.1, 0.2, 0.4, 0.6, 0.8, 1.0)
#: the policy of each lane of every recorded sweep (``sweep_configs``)
LANE_POLICIES = tuple(p for p in POLICIES for _f in FRACS)
#: the buffer points held to the event engine (validate.DEFAULT_FRACS)
VALIDATED_FRACS = (0.1, 0.2, 0.4)
#: sim_fixed: lanes that always run, and the card time it aims at
FIXED_MUST = (("cscan", 0.2), ("cscan", 0.4))
FIXED_BUDGET_S = 60.0
#: worker processes for the event engine's reference runs (host, pure
#: Python, while the card runs the sweep)
EVENT_WORKERS = 4
CALIBRATED_SCALE = 0.25
T0 = time.time()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "at_s": time.time() - T0}   # seconds since the start
    print(json.dumps(obj), flush=True)


def fail(phase: str, why: str) -> None:
    emit({"phase": phase, "ok": False, "error": why})
    raise SystemExit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


# ----------------------------------------------------------------- build ----

#: SASS instructions that show which of the card's features a library uses:
#: warpgroup MMA, warp MMA, TMA tensor loads, bulk copies, cp.async
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "UBLKCP", "LDGSTS")
#: what each redesigned library must show (any one of the names)
SASS_REQUIRED = {"flash_attention": (("HGMMA",), ("UTMALDG",)),
                 "paged_attention": (("LDGSTS", "UBLKCP"),),
                 "mamba2_scan": (("HGMMA", "HMMA"),),
                 "mlstm": (("HMMA", "HGMMA"),)}
#: what a library must not show: the buffer-pool kernels sum whole byte
#: counts, which a tensor-core product would round
SASS_FORBIDDEN = {"pbm_timeline": ("HGMMA", "HMMA")}
#: kernels that must be listed, each with the number of its instantiations:
#: in a library outside SASS_REQUIRED the redesigned kernels, which alone
#: are held to no stack frame and no local memory (every kernel of a
#: SASS_REQUIRED library is); in mlstm the f32 and the bf16 path's kernels
NO_LOCAL_KERNELS = {"pbm_timeline": {"fifo_grant_kernel": 1,
                                     "wake_solve_kernel": 1,
                                     "batched_evict_kernel": 2},
                    "mlstm": {"mlstm_ffma": 1, "mlstm_scores_bf16": 1,
                              "mlstm_recur_bf16": 2}}


def _cuobjdump(flag: str, name: str) -> str:
    """``cuobjdump <flag>`` of the built library of ``name``."""
    from repro_torch.kernels import _build
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run(
        [cuobjdump, flag, str(_build.library_path(name))],
        capture_output=True, text=True, check=True).stdout


def sass_counts(name: str) -> dict:
    """Instructions of ``SASS_OPS`` in the built library of ``name``
    (``cuobjdump -sass``)."""
    counts = dict.fromkeys(SASS_OPS, 0)
    for line in _cuobjdump("-sass", name).splitlines():
        words = line.split("*/", 1)[-1].split()
        if words and words[0].startswith("@"):      # a predicate
            words = words[1:]
        op = words[0].split(".", 1)[0] if words else ""
        if op in counts:
            counts[op] += 1
    return counts


def resource_usage(name: str) -> list:
    """Per kernel of the built library of ``name``, its registers, stack
    frame, static shared memory and local memory as the binary records them
    (``cuobjdump -res-usage``): read from the library on disk, so a library
    that an earlier run built reports the same as a fresh build."""
    import re
    rows, kernel = [], None
    for line in _cuobjdump("-res-usage", name).splitlines():
        m = re.search(r"Function ([^\s:]+):", line)
        if m:
            kernel = m.group(1)
        if "REG:" in line:
            v = {k: int(n) for k, n in re.findall(r"(\w+):(\d+)", line)}
            rows.append({"kernel": kernel, "registers": v.get("REG"),
                         "stack_bytes": v.get("STACK"),
                         "shared_bytes": v.get("SHARED"),
                         "local_bytes": v.get("LOCAL")})
    return rows


def build_evidence_ok(usage: dict, sass: dict):
    """The redesigned kernels' libraries use the features their designs
    rest on and none they must not, and every kernel in them (in a library
    of ``NO_LOCAL_KERNELS`` outside ``SASS_REQUIRED``: each kernel named
    there) is listed by ``cuobjdump -res-usage`` with no stack frame and no
    local memory (no spill, no array in local memory).  A library or a
    named kernel (every instantiation) that is not listed fails."""
    for lib, groups in SASS_REQUIRED.items():
        for names in groups:
            if not any(sass.get(lib, {}).get(n, 0) for n in names):
                return False, f"{lib}: no {' / '.join(names)} in its SASS"
    for lib, names in SASS_FORBIDDEN.items():
        for op in names:
            if sass.get(lib, {}).get(op, 0):
                return False, f"{lib}: {op} in its SASS"
    gated = {lib: usage.get(lib, []) for lib in SASS_REQUIRED}
    for lib, kernels in NO_LOCAL_KERNELS.items():
        rows = usage.get(lib, [])
        for kernel, count in kernels.items():
            listed = sum(kernel in (row["kernel"] or "") for row in rows)
            if listed < count:
                return False, (f"{lib}: cuobjdump -res-usage lists {listed} "
                               f"of the {count} instantiations of {kernel}")
        if lib not in SASS_REQUIRED:
            gated[lib] = [row for row in rows
                          if any(k in (row["kernel"] or "") for k in kernels)]
    for lib, rows in gated.items():
        if not rows:
            return False, f"{lib}: cuobjdump -res-usage lists no kernel"
        for row in rows:
            if row["stack_bytes"] != 0 or row["local_bytes"] != 0:
                return False, f"{lib}: {row['kernel']} uses local memory"
    return True, ""


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
        "paged_attention": (ops.paged_attention, ref.paged_attention_ref),
    }


def path_counts(name, inputs) -> dict:
    """Lanes of the calls ``inputs`` (``[(args, static), ...]``) that took
    each path of ``name``'s kernel (``pbm_timeline.PATHS``: nothing to do,
    the head of the service order selected and sorted alone, the whole row
    sorted, and for batched_evict every page a candidate), computed on the
    host from the inputs as the kernel decides on the device."""
    from repro_torch.kernels.pbm_timeline import PATHS, lane_paths
    counts = {f"{path}_lanes": 0 for path in PATHS[name]}
    for args, static in inputs:
        for path in lane_paths(name, args, static):
            counts[f"{path}_lanes"] += 1
    return counts


def path_counts_by_policy(name, inputs) -> dict:
    """``path_counts`` split by the policy of each lane: every recorded
    sweep has the lanes of ``sweep_configs`` (``LANE_POLICIES``)."""
    from repro_torch.kernels.pbm_timeline import PATHS, lane_paths
    counts = {p: {f"{path}_lanes": 0 for path in PATHS[name]}
              for p in POLICIES}
    for args, static in inputs:
        if args[0].shape[0] != len(LANE_POLICIES):
            raise ValueError(f"{name}: a captured input has "
                             f"{args[0].shape[0]} lanes, not a sweep's "
                             f"{len(LANE_POLICIES)}")
        for pol, path in zip(LANE_POLICIES, lane_paths(name, args, static)):
            counts[pol][f"{path}_lanes"] += 1
    return counts


def lanes_of(args, lanes):
    """A captured input cut to ``lanes``: every tensor but the shared
    ``(P,)`` size row (the second argument of each buffer-pool kernel)."""
    return [a if i == 1 and a.dim() == 1 else a[lanes]
            for i, a in enumerate(args)]


def phase_kernels_fuzz(dev) -> None:
    from repro_torch.kernels import cases
    fns = kernel_fns()
    out = {"phase": "kernels_fuzz", "device": str(dev), "tolerance": 0}
    for name, make in cases.CASES.items():
        kernel, plain = fns[name]
        n_cases = bad = 0
        err = 0.0
        inputs = []
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
            inputs.append((args, case["static"]))
        out[name] = {"cases": n_cases, "mismatches": bad, "max_abs_err": err,
                     **path_counts(name, inputs)}
    out["ok"] = all(out[k]["mismatches"] == 0 for k in cases.CASES) and all(
        v > 0 for k in cases.CASES for key, v in out[k].items()
        if key.endswith("_lanes"))
    emit(out)
    if not out["ok"]:
        fail("kernels_fuzz", "a kernel disagrees with its plain version, or "
                             "a path of a buffer-pool kernel was not run")


class Recorder:
    """Keeps a sample of the inputs a path hands to each of ``names``
    (functions of ``repro_torch.kernels.ops``, which the simulator's step
    and the serving model call through the module) while a run is
    captured.  Every ``STRIDE``-th call is cloned, keyed by the kernel and
    its second input dimension (the page count of a simulator kernel);
    ``seconds`` is the host time that took, which the run's wall time
    includes.  With ``focus`` (lane indices of a sweep), a sampled call in
    which one of those lanes has work (``pbm_timeline.lane_paths``: not
    idle) is also kept in ``busy``: a sweep's cooperative lanes finish
    long before its slowest lane, and a sample spread over the whole run
    finds them idle."""

    STRIDE, CAP = 97, 12

    def __init__(self, names=SIM_KERNELS, focus=None):
        self.names = tuple(names)
        self.samples = {}      # (kernel, dim) -> [(args, static), ...]
        self.busy = {}         # the same, the focus lanes at work
        self.focus = focus
        self._calls = {}
        self.seconds = 0.0

    def __enter__(self):
        from repro_torch.kernels import ops
        self._ops = ops
        self._orig = {n: getattr(ops, n) for n in self.names}
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
                key = (name, args[0].shape[1])
                sample = ([a.clone() for a in args], dict(static))
                self._keep(self.samples.setdefault(key, []), sample)
                if self.focus is not None and self._focus_busy(name, sample):
                    self._keep(self.busy.setdefault(key, []), sample)
                self.seconds += time.perf_counter() - t0
            return fn(*args, **static)
        return wrapped

    def _keep(self, got, sample):
        if len(got) >= self.CAP:    # keep the run covered: thin out
            del got[::2]
        got.append(sample)

    def _focus_busy(self, name, sample) -> bool:
        from repro_torch.kernels.pbm_timeline import lane_paths
        paths = lane_paths(name, *sample)
        return any(paths[i] != "idle" for i in self.focus)


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


def _queued_ms(fn, n: int = 20):
    """``(device_ms, host_ms)`` per call of ``fn``: ``n`` calls queued
    behind a sleep kernel of ~10 ms, so that the events time the device
    alone, the gaps between launches included, while the host's clock
    times what issuing one call costs it (the wrapper's host time).
    ``_time_ms``, the per-call time of the ``ms`` keys, holds both: for a
    kernel of a few microseconds it reads the host's time."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    e0.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n, host * 1e3 / n


def _queued_row(kernel, library=None, n: int = 20) -> dict:
    """``_queued_ms`` of a kernel's call (``device_ms``, ``host_ms``) and,
    where there is one, of the library call (``library_device_ms``)."""
    dev_ms, host_ms = _queued_ms(kernel, n)
    row = {"device_ms": dev_ms, "host_ms": host_ms}
    if library is not None:
        row["library_device_ms"] = _queued_ms(library, n)[0]
    return row


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


def sim_kernel_entries(dev, recorder: Recorder, launches: dict,
                       main_p: int, by_phase: dict) -> list:
    """Buffer-pool kernels against their plain versions on the captured
    simulator inputs, and the timings.  ``main_p`` is the page count of the
    main path (``launches``: its counts) whose numbers go into the
    top-level keys of each kernel's entry; ``by_phase`` holds every
    simulator phase's counts."""
    import torch
    fns = kernel_fns()
    entries = []
    for name in SIM_KERNELS:
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
                **_queued_row(lambda: kernel(*args, **static),
                              _library_call(name, args)),
                "bound_ms": bound, "bound_by": bound_by,
            }
            by_p[P]["paths"] = path_counts(name, samples)   # every input at P
        if main_p not in by_p:
            fail("kernels", f"{name}: no input captured at P={main_p}")
        main = by_p[main_p]
        entry = {
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_by_phase": {ph: c[name] for ph, c in by_phase.items()},
            "max_abs_err": err, "mismatches": bad, "inputs_compared": n_inputs,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "device_ms": main["device_ms"], "host_ms": main["host_ms"],
            "library_device_ms": main["library_device_ms"],
            "shapes": list(by_p.values()),
        }
        busy = [s for (kname, _), samples in recorder.busy.items()
                if kname == name for s in samples]
        for args, static in busy:     # the cooperative lanes at work
            b, e = _compare(kernel(*args, **static), plain(*args, **static))
            bad, err = bad + b, max(err, e)
        entry["inputs_compared"] += len(busy)
        entry["max_abs_err"] = err
        captured = [s for (kname, _), samples in recorder.samples.items()
                    if kname == name for s in samples] + busy
        entry["cscan_busy_inputs"] = len(busy)
        entry.update(path_counts(name, captured))   # every input, every P
        entry["lanes_by_policy"] = path_counts_by_policy(name, captured)
        # the cooperative lanes' rows alone: array-CScan's keys (interest
        # counts, heavily tied), its chunk queue and its Keep < Load mask
        coop = [i for i, p in enumerate(LANE_POLICIES) if p == "cscan"]
        lanes = torch.tensor(coop, device=dev)
        cb, ce = 0, 0.0
        for args, static in captured:
            sub = lanes_of(args, lanes)
            b, e = _compare(kernel(*sub, **static), plain(*sub, **static))
            cb, ce = cb + b, max(ce, e)
        entry["cscan_lanes"] = {"lanes": len(coop),
                                "inputs_compared": len(captured),
                                "mismatches": cb, "max_abs_err": ce}
        bad += cb
        entry["mismatches"] = bad
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
                **_queued_row(lambda: kernel(*iargs, **static)),
            }
            bad += b
            entry["mismatches"] = bad
        entries.append(entry)
    return entries


# ------------------------------------------------------- paged attention ----

def _outside(got, want, tol: float):
    """(elements outside atol = rtol = ``tol``, max abs difference): the
    criterion of ``numpy.allclose``; a non-finite element counts as
    outside."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    bad = int((~(diff <= tol + tol * w.abs())).sum())
    return bad, float(diff.max()) if diff.numel() else 0.0


def _paged_compare(got, want, dtype: str):
    from repro_torch.kernels import cases
    return _outside(got, want, cases.PAGED_TOL[dtype])


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


#: B4 and B5 on bf16 inputs against the plain version on the same inputs
#: cast to f32: the largest normwise relative error allowed,
#: ||got - want32|| / ||want32||.  bf16 output rounding alone is ~2e-3 and
#: P rounded to bf16 before P V adds ~3e-3; a dropped key tile, a wrong
#: scale or a skipped diagonal tile gives far more
NORMWISE_TOL = 1e-2


#: query rows of one block of B5's blockwise check: a CTA's query tile;
#: B6's chunk (a block's tile is a chunk of one head)
NORMWISE_BLOCK_T = 128
#: the model-stack kernels held to NORMWISE_TOL on bf16 inputs
NORMWISE_KERNELS = ("flash_attention", "mamba2_scan", "mlstm_chunked")


def _normwise(got, want32) -> float:
    g, w = got.double(), want32.double()
    return float((g - w).norm() / w.norm())


def _normwise_max_block(got, want32) -> float:
    """The largest normwise relative error over the blocks one CTA writes:
    (batch row, 128-query tile, head) of B5's (B, T, H, dh) output, (batch
    row, 128-step chunk, head) of B6's and B7's (B, T, H, P) ones (B7's
    CTA owns a P slice of one head over every chunk: the chunk is the finer
    cut), (sequence, head) rows of B4's (B, H, dh) one.  A fault confined
    to one block (one warpgroup's rows, one head, a tile's last chunk)
    shows there in full, where the global norm dilutes it by the square
    root of the block count."""
    import torch
    d = (got.double() - want32.double()).square()
    w = want32.double().square()
    if d.dim() == 4:
        B, T, H, dh = d.shape
        pad = -T % NORMWISE_BLOCK_T
        d = torch.nn.functional.pad(d, (0, 0, 0, 0, 0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, pad))
        d = d.view(B, -1, NORMWISE_BLOCK_T, H, dh).sum((2, 4))
        w = w.view(B, -1, NORMWISE_BLOCK_T, H, dh).sum((2, 4))
    else:
        d, w = d.sum(-1), w.sum(-1)
    ratio = torch.where(w > 0, (d / w.clamp(min=1e-300)).sqrt(),
                        torch.where(d > 0, float("inf"), 0.0))
    return float(ratio.max())


def _vs_f32(plain, got, args, static=None) -> dict:
    """``got`` (a kernel's bf16 output) against ``plain`` on ``args`` cast
    to f32: the normwise relative error over the whole output and its
    largest value over one CTA's blocks, beside the f32 output's rms."""
    args32 = [a.float() if a.is_floating_point() else a for a in args]
    want32 = plain(*args32, **(static or {}))
    return {"normwise_vs_f32": _normwise(got, want32),
            "normwise_vs_f32_max_block": _normwise_max_block(got, want32),
            "rms_want_f32": float(want32.square().mean().sqrt())}


def _max_nan(a: float, b: float) -> float:
    """``max`` that keeps a NaN, so that it fails the bar it is held to."""
    return float("nan") if a != a or b != b else max(a, b)


def _normwise_worst(row: dict) -> float:
    """The larger of ``_vs_f32``'s two normwise errors."""
    return _max_nan(row["normwise_vs_f32"], row["normwise_vs_f32_max_block"])


def phase_paged_fuzz(dev) -> None:
    from repro_torch.kernels import cases, ops, ref
    import torch
    out = {"phase": "paged_fuzz", "device": str(dev),
           "tolerance": cases.PAGED_TOL, "normwise_tolerance": NORMWISE_TOL}
    normwise = 0.0
    for case in cases.paged_cases():
        args = cases.paged_tensors(case, dev)
        got = ops.paged_attention(*args)
        torch.cuda.synchronize()
        b, e = _paged_compare(got, ref.paged_attention_ref(*args),
                              case["dtype"])
        nw = None
        if case["dtype"] == "bfloat16":
            nw = _vs_f32(ref.paged_attention_ref, got, args)
            normwise = _max_nan(normwise, _normwise_worst(nw))
        if b or (nw is not None and not _normwise_worst(nw) <= NORMWISE_TOL):
            emit({"phase": "paged_fuzz", "case": case["name"],
                  "mismatches": b, "max_abs_err": e, "normwise": nw})
        row = out.setdefault(case["dtype"], {"cases": 0, "mismatches": 0,
                                             "max_abs_err": 0.0})
        row["cases"] += 1
        row["mismatches"] += b
        row["max_abs_err"] = max(row["max_abs_err"], e)
    out["bfloat16"]["max_normwise_vs_f32"] = normwise   # global or block
    out["ok"] = (all(out[d]["mismatches"] == 0 for d in cases.PAGED_TOL)
                 and normwise <= NORMWISE_TOL)
    emit(out)
    if not out["ok"]:
        fail("paged_fuzz", "paged attention disagrees with its plain version")


def _paged_work(args):
    """(pages read, positions attended) of one paged-attention call: the
    pages that hold a position below each sequence's length (the whole
    table for a length of 0), and those positions."""
    _q, _kp, _vp, pt, sl = args
    ps, pps = args[1].shape[1], pt.shape[1]
    sl = sl.long()
    pages = ((sl + ps - 1) // ps).clamp(max=pps).masked_fill(sl <= 0, pps)
    return int(pages.sum()), int(sl.clamp(min=0, max=pps * ps).sum())


def _paged_bytes(args, out) -> int:
    """q, the table, the lengths and the K and V rows of the pages the call
    must read, each read once, and the output written once."""
    q, kp, _vp, pt, sl = args
    pages, _ = _paged_work(args)
    _, ps, hk, dh = kp.shape
    nbytes = 2 * pages * ps * hk * dh * kp.element_size()
    return nbytes + sum(t.numel() * t.element_size() for t in (q, pt, sl, out))


def _paged_bound_ms(args, out):
    """Least time the card could take: ``_paged_bytes`` at the memory rate,
    against two f32 multiply-adds per query head, head dimension and
    attended position (scores and values) at the f32 rate outside the
    tensor cores."""
    q, kp = args[0], args[1]
    _, positions = _paged_work(args)
    nbytes = _paged_bytes(args, out)
    n_ops = 4.0 * q.shape[1] * kp.shape[3] * positions
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _paged_library_calls(args):
    """The yardstick: an ``index_select`` gather of the table's pages and
    one ``scaled_dot_product_attention`` call on them (GQA, boolean
    length mask); and the same call on K/V gathered beforehand.  Never
    called on the port's path."""
    import torch
    import torch.nn.functional as F
    q, kp, vp, pt, sl = args
    B, H, dh = q.shape
    _, ps, hk, _ = kp.shape
    S = pt.shape[1] * ps
    idx = pt.reshape(-1).long()
    mask = (torch.arange(S, device=q.device)[None, :]
            < sl.long()[:, None]).view(B, 1, 1, S)
    qq = q.view(B, H, 1, dh)

    def gather():
        k = kp.index_select(0, idx).view(B, S, hk, dh).transpose(1, 2)
        v = vp.index_select(0, idx).view(B, S, hk, dh).transpose(1, 2)
        return k, v

    k0, v0 = gather()

    def with_gather():
        k, v = gather()
        return F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                              enable_gqa=True).view(B, H, dh)

    def without_gather():
        return F.scaled_dot_product_attention(qq, k0, v0, attn_mask=mask,
                                              enable_gqa=True).view(B, H, dh)
    return with_gather, without_gather


def _paged_shape_row(label, args, dev):
    from repro_torch.kernels import ops, ref
    kernel = ops.paged_attention
    out = kernel(*args)
    want = ref.paged_attention_ref(*args)
    dtype = _dtype_name(args[0])
    bad, err = _paged_compare(out, want, dtype)
    bound, bound_by = _paged_bound_ms(args, out)
    with_gather, without_gather = _paged_library_calls(args)
    _, lib_err = _paged_compare(with_gather(), want, dtype)
    pages, positions = _paged_work(args)
    q, kp, _vp, pt, sl = args
    queued = _queued_row(lambda: kernel(*args), with_gather)
    extra = {}
    if dtype == "bfloat16":
        extra = _vs_f32(ref.paged_attention_ref, out, args)
    return {
        "shape": label, "dtype": dtype, "B": int(q.shape[0]),
        "H": int(q.shape[1]), "Hk": int(kp.shape[2]), "dh": int(q.shape[2]),
        "page_size": int(kp.shape[1]), "pages_per_seq": int(pt.shape[1]),
        "pool_pages": int(kp.shape[0]),
        "seq_lens": [int(sl.min()), int(sl.max())],
        "pages_read": pages, "positions": positions,
        "mismatches": bad, "max_abs_err": err, **extra,
        "ms": _time_ms(lambda: kernel(*args), dev),
        "plain_ms": _time_ms(lambda: ref.paged_attention_ref(*args), dev),
        "library_ms": _time_ms(with_gather, dev),
        "library_no_gather_ms": _time_ms(without_gather, dev),
        **queued,
        "tb_per_s": _paged_bytes(args, out)
        / (queued["device_ms"] * 1e-3) / 1e12,
        "library_max_abs_err": lib_err,
        "bound_ms": bound, "bound_by": bound_by,
    }


def deployment_batch(dev, dtype):
    """A decode batch a deployment runs at these widths: B = 32 sequences
    of 1024-4096 tokens, H = 12, Hk = 2, dh = 128, pages of 16 tokens, a
    pool of 8192 pages, each sequence's table a slice of one random
    permutation of the pool.  Drawn on the card from a seed."""
    import torch
    B, H, hk, dh, ps, n_pages = 32, 12, 2, 128, 16, 8192
    pps = 4096 // ps
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((B, H, dh), generator=g, device=dev).to(dtype)
    kp = (0.5 * torch.randn((n_pages, ps, hk, dh), generator=g,
                            device=dev)).to(dtype)
    vp = (0.5 * torch.randn((n_pages, ps, hk, dh), generator=g,
                            device=dev)).to(dtype)
    pt = torch.randperm(n_pages, generator=g, device=dev)[: B * pps]
    pt = pt.view(B, pps).to(torch.int32)
    sl = torch.randint(1024, 4097, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    return [q, kp, vp, pt, sl]


def paged_kernel_entry(dev, recorder: Recorder, serve_full: dict) -> dict:
    """Paged attention against its plain version on every input captured
    from ``serve_full`` and at a deployment's batch in f32 and bf16, with
    the timings.  The top-level numbers are the heaviest captured input's
    (the main path)."""
    import torch
    from repro_torch.kernels import ops, ref
    samples = [a for (name, _), got in sorted(recorder.samples.items())
               for a, _ in got if name == "paged_attention"]
    if not samples:
        fail("kernels", "paged_attention: no input captured in serve_full")
    bad, err = 0, 0.0
    for args in samples:
        b, e = _paged_compare(ops.paged_attention(*args),
                              ref.paged_attention_ref(*args),
                              _dtype_name(args[0]))
        bad, err = bad + b, max(err, e)
    heaviest = max(samples, key=lambda a: _paged_work(a)[0])
    rows = [_paged_shape_row("serve_full captured", heaviest, dev)]
    main = rows[0]
    for dtype in (torch.float32, torch.bfloat16):
        args = deployment_batch(dev, dtype)
        rows.append(_paged_shape_row("deployment", args, dev))
        del args
    torch.cuda.empty_cache()
    bad_all = bad + sum(r["mismatches"] for r in rows[1:]) \
        + sum(not _normwise_worst(r) <= NORMWISE_TOL for r in rows
              if "normwise_vs_f32" in r)
    launches = serve_full["launches"]["paged_attention"]
    return {
        "name": "paged_attention", "route": "cuda",
        "source": SOURCE["paged_attention"],
        "replaces": REPLACES["paged_attention"], "launches": launches,
        "max_abs_err": max([err] + [r["max_abs_err"] for r in rows[1:]]),
        "mismatches": bad_all, "inputs_compared": len(samples),
        "tolerance": {"float32": 3e-5, "bfloat16": 3e-2},
        "normwise_tolerance": NORMWISE_TOL,
        "ms": main["ms"], "device_ms": main["device_ms"],
        "host_ms": main["host_ms"], "tb_per_s": main["tb_per_s"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library_device_ms": main["library_device_ms"],
        "library_no_gather_ms": main["library_no_gather_ms"],
        "share_of_forward": serve_full["profile"][
            "paged_attention_share_of_forward"],
        "share_of_forward_window": "serve_full profile: 40 decode forwards "
                                   "at position 200 over 13 pages",
        "shapes": rows,
    }


# ----------------------------------------------------------- model stack ----

def _model_compare(kernel, got, want, dtype: str):
    from repro_torch.kernels import cases
    return _outside(got, want, cases.MODEL_TOL[kernel][dtype])


def model_fns():
    from repro_torch.kernels import ops, ref
    return {"flash_attention": (ops.flash_attention, ref.flash_attention_ref),
            "mamba2_scan": (ops.mamba2_scan, ref.mamba2_scan_ref),
            "mlstm_chunked": (ops.mlstm_chunked, ref.mlstm_chunked_ref)}


def phase_model_fuzz(dev) -> None:
    import torch
    from repro_torch.kernels import cases
    fns = model_fns()
    out = {"phase": "model_fuzz", "device": str(dev),
           "tolerance": cases.MODEL_TOL}
    normwise = dict.fromkeys(NORMWISE_KERNELS, 0.0)
    for case in cases.model_cases():
        kernel, plain = fns[case["kernel"]]
        args = cases.model_tensors(case, dev)
        got = kernel(*args, **case["static"])
        torch.cuda.synchronize()
        b, e = _model_compare(case["kernel"], got,
                              plain(*args, **case["static"]), case["dtype"])
        nw = None
        if case["kernel"] in normwise and case["dtype"] == "bfloat16":
            nw = _vs_f32(plain, got, args, case["static"])
            normwise[case["kernel"]] = _max_nan(normwise[case["kernel"]],
                                                _normwise_worst(nw))
        if b or (nw is not None and not _normwise_worst(nw) <= NORMWISE_TOL):
            emit({"phase": "model_fuzz", "kernel": case["kernel"],
                  "case": case["name"], "mismatches": b, "max_abs_err": e,
                  "normwise": nw})
        row = out.setdefault(case["kernel"], {}).setdefault(
            case["dtype"], {"cases": 0, "mismatches": 0, "max_abs_err": 0.0})
        row["cases"] += 1
        row["mismatches"] += b
        row["max_abs_err"] = max(row["max_abs_err"], e)
    for k, worst in normwise.items():
        out[k]["bfloat16"]["max_normwise_vs_f32"] = worst
    out["normwise_tolerance"] = NORMWISE_TOL
    out["ok"] = (all(r["mismatches"] == 0 for k in MODEL_KERNELS
                     for r in out[k].values())
                 and all(w <= NORMWISE_TOL for w in normwise.values()))
    emit(out)
    if not out["ok"]:
        fail("model_fuzz", "a model-stack kernel disagrees with its plain "
                           "version")


class FirstCalls(Recorder):
    """A :class:`Recorder` of the model-stack kernels that keeps the
    arguments of the first call at each input shape, labelled with the
    configuration that made it: ``samples`` is kernel -> [(label, args,
    static), ...]."""

    def __init__(self):
        super().__init__(MODEL_KERNELS)
        self.label = ""

    def _wrap(self, name, fn):
        def wrapped(*args, **static):
            got = self.samples.setdefault(name, [])
            shape = tuple(a.shape for a in args)
            if all(tuple(x.shape for x in s[1]) != shape for s in got):
                t0 = time.perf_counter()
                got.append((self.label, [a.clone() for a in args],
                            dict(static)))
                self.seconds += time.perf_counter() - t0
            return fn(*args, **static)
        return wrapped


def _sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def _zero_cache(specs, dev, dtype=None):
    import torch
    return {k: torch.zeros(s.shape, dtype=dtype or s.dtype, device=dev)
            for k, s in specs.items()}


def _decode(model, params, cache, first, steps: int):
    """``steps`` tokens through ``serve_step`` from position 0, each
    step's token the argmax of the last logits; all logits finite."""
    import torch
    tok, finite = first, torch.ones((), dtype=torch.bool, device=first.device)
    for pos in range(steps):
        logits, cache = model.serve_step(params, cache,
                                         {"token": tok, "pos": pos})
        finite &= torch.isfinite(logits).all()
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
    return bool(finite)


def decode_matches_prefill(model, params, dev, seed: int = 3):
    """The last logits of one prompt of DECODE_PREFILL_TOKENS tokens, in
    f32, by prefill and decoded token by token from a zero f32 cache
    (xLSTM's with its sLSTM stabiliser ``sm`` at -1e9, where
    ``slstm_block`` starts it; a zero cache is a fault of the reference,
    ROADMAP §C): ``(max |difference|, largest excess over atol = rtol =
    DECODE_PREFILL_TOL (0 when all within), max |prefill logit|)``."""
    import torch
    cfg = model.cfg
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, DECODE_PREFILL_TOKENS),
                         generator=g, device=dev, dtype=torch.int32)
    pre = model.prefill_logits(params, {"tokens": toks})[0, -1].float()
    cache = _zero_cache(model.cache_specs(1, DECODE_PREFILL_TOKENS), dev,
                        torch.float32)
    if "sm" in cache:
        cache["sm"].fill_(-1e9)
    logits = None
    for pos in range(DECODE_PREFILL_TOKENS):
        logits, cache = model.serve_step(
            params, cache, {"token": toks[:, pos:pos + 1], "pos": pos})
    diff = (logits[0, -1].float() - pre).abs()
    excess = diff - DECODE_PREFILL_TOL * (1.0 + pre.abs())
    return float(diff.max()), float(excess.max().clamp(min=0.0)), \
        float(pre.abs().max())


def phase_model_serve(dev, calls: FirstCalls) -> dict:
    """The model stack's serving path at three families' full widths in
    bf16: ``build_model`` -> ``init_params`` (seed 0, on the card, stacked
    matrices rescaled by ``fan_in_rescale``) ->
    ``prefill_logits`` (B = 4 x 4,096 tokens; one 32,768-token sequence for
    the attention families) -> ``serve_step`` (32 tokens at B = 8 from an
    empty 4,096-position cache).  Launch counts are set to 0 just before
    and read just after; then each model's f32 decode-vs-prefill check."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.layers import tree_paths, unflatten
    rows, kept = [], {}
    ops.reset_launch_counts()
    t_path = time.time()
    with calls:
        for arch in MODEL_ARCHS:
            rows.append(_serve_arch(arch, dev, calls, kept))
    launches = {k: v for k, v in ops.launch_counts().items()
                if k in MODEL_KERNELS}
    path_s = time.time() - t_path
    ok = all(r["logits_finite"] and r["launches"] for r in rows)
    # the f32 decode-vs-prefill check, after the counts were read
    for row in rows:
        model, params = kept.pop(row["arch"])
        params32 = unflatten({k: t.float()
                              for k, t in tree_paths(params).items()})
        del params
        torch.cuda.empty_cache()
        diff, excess, scale = decode_matches_prefill(model, params32, dev)
        row["decode_vs_prefill_f32"] = {
            "tokens": DECODE_PREFILL_TOKENS, "max_abs_diff": diff,
            "logit_scale": scale, "tolerance": DECODE_PREFILL_TOL,
            "excess_over_tolerance": excess}
        ok &= excess == 0.0
        del params32
        torch.cuda.empty_cache()
    out = {"phase": "model_serve", "archs": rows, "launches": launches,
           "path_s": path_s, "capture_s": calls.seconds}
    out["ok"] = ok and all(launches[k] > 0 for k in MODEL_KERNELS)
    emit(out)
    if not out["ok"]:
        fail("model_serve", "non-finite logits, a kernel never launched or "
                            "decode disagreeing with prefill")
    return out


def _serve_arch(arch, dev, calls: FirstCalls, kept: dict) -> dict:
    """One family of ``phase_model_serve``'s main path; keeps the model
    and its weights in ``kept`` for the f32 check."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, init_params, tree_paths
    from repro_torch.models.layers import fan_in_rescale
    cfg = get_config(arch)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    # the reference's draw is too ill-conditioned at full width for the f32
    # decode-vs-prefill check (ROADMAP §C): each stacked matrix is rescaled
    # to its own fan-in; with that draw Zamba2's and xLSTM's f32 decode left
    # prefill by a third of the logits' scale, with this one by ~1e-5
    params, init_s = _sync_time(lambda: fan_in_rescale(
        model.param_specs, init_params(
            model.param_specs, torch.Generator(device=dev).manual_seed(0),
            getattr(torch, cfg.dtype), dev)))
    n_params = sum(t.numel() for t in tree_paths(params).values())
    g = torch.Generator(device=dev).manual_seed(1)
    row = {"arch": arch, "dtype": cfg.dtype, "params": n_params,
           "init_s": init_s, "prefill": [], "launches": {}}
    before = ops.launch_counts()
    finite = True
    for B, T in MODEL_PREFILL:
        if T > 4096 and arch not in LONG_PREFILL_ARCHS:
            continue
        toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                             device=dev, dtype=torch.int32)
        calls.label = f"{arch} prefill B={B} T={T}"
        logits, secs = _sync_time(lambda: model.prefill_logits(
            params, {"tokens": toks}))
        fin = bool(torch.isfinite(logits).all())
        finite &= fin and tuple(logits.shape) == (B, 1, cfg.padded_vocab)
        row["prefill"].append({"B": B, "T": T, "seconds": secs,
                               "tokens_per_s": B * T / secs,
                               "logits_finite": fin})
        del logits, toks
    D = MODEL_DECODE
    cache = _zero_cache(model.cache_specs(D["batch"], D["cache"]), dev)
    first = torch.randint(0, cfg.vocab_size, (D["batch"], 1), generator=g,
                          device=dev, dtype=torch.int32)
    dec_finite, secs = _sync_time(lambda: _decode(
        model, params, cache, first, D["steps"]))
    finite &= dec_finite
    del cache
    row["decode"] = {**D, "seconds": secs,
                     "tokens_per_s": D["batch"] * D["steps"] / secs,
                     "ms_per_step": secs / D["steps"] * 1e3,
                     "logits_finite": dec_finite}
    after = ops.launch_counts()
    row["launches"] = {k: after[k] - before[k] for k in MODEL_KERNELS
                       if after[k] != before[k]}
    n_prefills = sum(1 for _, T in MODEL_PREFILL
                     if T <= 4096 or arch in LONG_PREFILL_ARCHS)
    row["launches_per_forward"] = {k: v // n_prefills
                                   for k, v in row["launches"].items()}
    row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    row["logits_finite"] = finite
    kept[arch] = (model, params)
    return row


def _model_work(kernel, args, static):
    """(operations, bytes) the least a call must do: every input read and
    the output written once; flash attention 4 B H dh flops per attended
    (query, key) pair (the causal half, the window), the scans 4 flops per
    (step, head, state element) of their recurrences (one multiply-add to
    update the element, one to read it out)."""
    import torch
    nbytes = sum(t.numel() * t.element_size() for t in args)
    if kernel == "flash_attention":
        q, k, _v = args
        B, T, H, dh = q.shape
        S = k.shape[1]
        off = S - T if static.get("offset") is None else static["offset"]
        t = torch.arange(T, dtype=torch.int64)
        hi = (t + off + 1).clamp(0, S) if static.get("causal", True) \
            else torch.full_like(t, S)
        lo = torch.zeros_like(t)
        if static.get("window") is not None:
            lo = (t + off - static["window"] + 1).clamp(0, S)
        pairs = int((hi - lo).clamp(min=0).sum())
        ops = 4.0 * B * H * dh * pairs
        nbytes += q.numel() * q.element_size()
    elif kernel == "mamba2_scan":
        xh, _a, b, _c = args
        B, T, H, P = xh.shape
        ops = 4.0 * B * T * H * P * b.shape[-1]
        nbytes += xh.numel() * xh.element_size()
    else:
        q, _k, v, _a, _i = args
        B, T, H, K = q.shape
        ops = 4.0 * B * T * H * K * (v.shape[-1] + 1)
        nbytes += v.numel() * v.element_size()
    return ops, nbytes


def _model_bound_ms(kernel, args, static):
    import torch
    ops, nbytes = _model_work(kernel, args, static)
    rate = BF16_OPS_PER_S if args[0].dtype == torch.bfloat16 \
        else FP32_OPS_PER_S
    t_ops = ops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _time_budget_ms(fn, dev, budget_s: float = 1.5) -> float:
    """``_time_ms`` with as many launches as fit ``budget_s`` (3 to 30)."""
    import torch
    _, once = _sync_time(fn)
    n = int(min(30, max(3, budget_s / max(once, 1e-6))))
    return _time_ms(fn, dev, n=n, warm=1)


def _sdpa_call(q, k, v, static):
    """One ``scaled_dot_product_attention`` on the same q/k/v with KV
    expanded to H heads beforehand, causal from the top-left corner (T = S
    on the model path): the yardstick; the port never calls it."""
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2)
    causal = static.get("causal", True)

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    return call


def _held_to_plain(name, args, static, dtype: str) -> dict:
    """The kernel and its plain version on ``args``, held at
    ``MODEL_TOL[name][dtype]``: elements outside, the largest difference
    and the root mean square of the plain output (the scale the tolerance
    is read against)."""
    kernel, plain = model_fns()[name]
    got = kernel(*args, **static)
    want = plain(*args, **static)
    b, e = _model_compare(name, got, want, dtype)
    rms = float(want.float().square().mean().sqrt())
    return {"mismatches": b, "max_abs_err": e, "rms_want": rms}


#: the CUDA kernels one call launches on a bf16 input, each once: the SSD
#: split's three passes (csrc/mamba2_scan.cu), the mLSTM's scores and
#: recurrence (csrc/mlstm.cu)
CUDA_PASSES = {"mamba2_scan": ("chunk_state", "state_pass", "chunk_scan"),
               "mlstm_chunked": ("mlstm_scores", "mlstm_recur")}


def cuda_kernels_per_call(fn, reps: int = 20) -> dict:
    """The CUDA kernels one call of ``fn`` launches, by name, each with its
    launches per call, counted by ``torch.profiler`` (device activity only,
    as ``tools/time_ssd_passes.py`` reads it) over ``reps`` calls.  A
    warm-up step of as many calls comes first: late in a long process the
    device activity started recording some milliseconds after the profiler
    was entered, and the first calls' kernels went uncounted; each step
    also waits 0.1 s before its first call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):              # the warm-up step, the counted one
            time.sleep(0.1)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()

    def is_kernel(k) -> bool:       # not the steps' own annotations
        if getattr(k, "is_user_annotation", False) \
                or k.key.startswith("ProfilerStep"):
            return False
        return k.device_type == DeviceType.CUDA \
            or (getattr(k, "self_device_time_total", 0.0) or 0.0) > 0
    return {k.key: k.count / reps for k in prof.key_averages()
            if is_kernel(k)}


def _pass_launches(name: str, kernels: dict) -> dict:
    """``cuda_kernels_per_call``'s count for one call of ``name``'s
    kernel, held to the design: each of ``CUDA_PASSES[name]`` once and
    nothing else."""
    passes = CUDA_PASSES[name]
    per_pass = {p: sum(n for k, n in kernels.items() if p in k)
                for p in passes}
    total = sum(kernels.values())
    if total != len(passes) or any(n != 1 for n in per_pass.values()):
        fail("kernels", f"{name}: a call launched {kernels}, expected "
                        f"each of {passes} once")
    return {"cuda_launches_per_call": total, "cuda_kernels": kernels}


def model_kernel_entries(dev, calls: FirstCalls, serve: dict) -> list:
    """B5-B7 against their plain versions on every input captured from
    ``model_serve``, twice: as captured (bf16) and cast to f32, where the
    tolerance is far below a typical output (``rms_want``), each with 0
    elements outside; and the timings of each captured shape in bf16.  The
    top-level numbers are the B = 4 x 4,096 prefill's of the kernel's first
    family."""
    import torch
    from repro_torch.kernels import cases
    fns = model_fns()
    entries = []
    for name in MODEL_KERNELS:
        kernel, plain = fns[name]
        samples = calls.samples.get(name, [])
        if not samples:
            fail("kernels", f"{name}: no input captured in model_serve")
        rows, bad, err, err32 = [], 0, 0.0, 0.0
        for label, args, static in samples:
            held = _held_to_plain(name, args, static, _dtype_name(args[0]))
            args32 = [a.float() if a.is_floating_point() else a
                      for a in args]
            held32 = _held_to_plain(name, args32, static, "float32")
            del args32
            torch.cuda.empty_cache()
            bad += held["mismatches"] + held32["mismatches"]
            err = max(err, held["max_abs_err"])
            err32 = max(err32, held32["max_abs_err"])
            bound, bound_by = _model_bound_ms(name, args, static)
            if name in NORMWISE_KERNELS and args[0].dtype == torch.bfloat16:
                held.update(_vs_f32(plain, kernel(*args, **static), args,
                                    static))
                bad += not _normwise_worst(held) <= NORMWISE_TOL
                torch.cuda.empty_cache()
            ms = _time_budget_ms(lambda: kernel(*args, **static), dev)
            sdpa = (_sdpa_call(*args, static) if name == "flash_attention"
                    else None)
            queued = _queued_row(lambda: kernel(*args, **static), sdpa,
                                 n=int(min(20, max(3, 1000.0 / ms))))
            row = {"shape": label, "dtype": _dtype_name(args[0]),
                   "inputs": [list(a.shape) for a in args],
                   **held, "float32": held32, "ms": ms, **queued,
                   "tflops": _model_work(name, args, static)[0]
                   / (queued["device_ms"] * 1e-3) / 1e12,
                   "plain_ms": _time_budget_ms(
                       lambda: plain(*args, **static), dev),
                   "library_ms": None,
                   "bound_ms": bound, "bound_by": bound_by}
            if sdpa is not None:
                row["library_ms"] = _time_budget_ms(sdpa, dev)
            if name in CUDA_PASSES:        # one count a call, a launch a pass
                row.update(_pass_launches(name, cuda_kernels_per_call(
                    lambda: kernel(*args, **static))))
            rows.append(row)
            torch.cuda.empty_cache()
        main = rows[0]
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": serve["launches"][name],
            "launches_per_forward": {
                r["arch"]: r["launches_per_forward"][name]
                for r in serve["archs"] if name in r["launches_per_forward"]},
            "max_abs_err": err, "max_abs_err_f32": err32, "mismatches": bad,
            "inputs_compared": len(samples),
            "tolerance": {dt: cases.MODEL_TOL[name][dt]
                          for dt in ("bfloat16", "float32")},
            "ms": main["ms"], "device_ms": main["device_ms"],
            "host_ms": main["host_ms"], "tflops": main["tflops"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library_device_ms": main.get("library_device_ms"),
            "shapes": rows,
        })
        if name in NORMWISE_KERNELS:
            entries[-1]["normwise_tolerance"] = NORMWISE_TOL
        if name in CUDA_PASSES:
            entries[-1]["cuda_launches_per_call"] = \
                main["cuda_launches_per_call"]
    return entries


# --------------------------------------------------------------- serving ----

def serve_plan(vocab: int, *, n_requests, page_size, prefix_len, share_ratio,
               gen_lo, gen_hi, seed, **_):
    """The serving benchmark's requests (``run_policy``'s draw), request
    ids 0..n-1.  Token ids are taken modulo the model's vocabulary: the
    unshared prefixes use ids 1000 + i, outside ``TinyConfig()``'s 512;
    which prompts share a prefix does not change."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    common = list(range(prefix_len))
    lengths = rng.integers(gen_lo, gen_hi, n_requests)
    shared = rng.random(n_requests) < share_ratio
    plan = []
    for i in range(n_requests):
        prefix = common if shared[i] else [1000 + i] * prefix_len
        prompt = prefix + [int(t) for t in rng.integers(0, 100, 16)]
        plan.append(Request(prompt=[t % vocab for t in prompt],
                            max_new_tokens=int(lengths[i]), rid=i))
    return plan


def serve_point(policy: str, lm, on_logits=None):
    """Run the point to completion under ``policy`` through the engine of
    ``repro_torch.launch.serve`` with ``lm``'s ``step_fn``, one arrival
    every ``arrival_interval`` steps.  ``on_logits`` sees every forward's
    logits.  Returns ``(engine, wall seconds, token-forwards)``."""
    import torch
    from repro_torch.launch import serve
    forward = lm._forward_token
    count = [0]

    def counted(*a, **k):
        out = forward(*a, **k)
        count[0] += 1
        if on_logits is not None:
            on_logits(out)
        return out

    point, cfg = SERVE_POINT, lm.cfg
    lm._forward_token = counted
    try:
        eng = serve.make_engine(policy, point["pool_pages"],
                                point["page_size"], point["max_batch"],
                                lm.step_fn, cfg)
        plan = serve_plan(cfg.vocab, **point)
        t0 = time.time()
        due = 0
        while len(eng.finished) < len(plan) and eng.stats.steps < 50_000:
            while due < len(plan) and \
                    eng.stats.steps >= due * point["arrival_interval"]:
                eng.submit(plan[due])
                due += 1
            eng.step()
        if lm.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        lm._forward_token = forward
    return eng, wall, count[0]


def _max_abs_diff(a, b) -> float:
    """Largest absolute difference; infinity when either side holds a
    value that is not finite (``max`` would drop a NaN)."""
    import math
    d = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
    return d if math.isfinite(d) else float("inf")


def _engine_summary(eng) -> dict:
    import dataclasses
    return {"stats": dataclasses.asdict(eng.stats),
            "token_gaps": list(eng.token_gaps),
            "finished": [r.rid for r in eng.finished]}


def phase_serve_small(dev) -> None:
    """``TinyConfig()`` with the same weights on the card and on the CPU,
    under every serving policy: scheduling does not depend on token values,
    so stats, gaps and finish order must be equal, and every forward's
    logits within 1e-4 (f32, sums in another order).  Equal tokens are
    reported, not relied on: at these widths the argmax is nearly always
    the input token, whatever attention computes."""
    import torch
    from repro_torch.serving.model import PagedTinyLM, TinyConfig
    cfg = TinyConfig()
    tol = 1e-4
    rows, ok = [], True
    for policy in SERVING_POLICIES:
        runs = []
        for device in (dev, torch.device("cpu")):
            lm = PagedTinyLM(cfg, seed=0, device=device)
            logits = []
            threads = torch.get_num_threads()
            if device.type == "cpu":       # tiny ops: threads only contend
                torch.set_num_threads(1)
            try:
                eng, wall, forwards = serve_point(
                    policy, lm, on_logits=lambda t: logits.append(
                        t.detach().to("cpu", copy=True)))
            finally:
                torch.set_num_threads(threads)
            runs.append((eng, wall, forwards, logits))
        (ge, gwall, gfwd, glog), (ce, cwall, cfwd, clog) = runs
        same_sched = _engine_summary(ge) == _engine_summary(ce)
        err = max((_max_abs_diff(a, b) for a, b in zip(glog, clog)),
                  default=float("inf"))
        row = {
            "policy": policy, "schedule_equal": same_sched,
            "forwards": [gfwd, cfwd], "logits_max_abs_err": err,
            "logits_tolerance": tol,
            "tokens_equal": ([r.generated for r in ge.finished]
                             == [r.generated for r in ce.finished]),
            "completed": len(ge.finished), "steps": ge.stats.steps,
            "preemptions": ge.stats.preemptions, "resumes": ge.stats.resumes,
            "wall_s": {str(dev): gwall, "cpu": cwall},
        }
        row["ok"] = (same_sched and gfwd == cfwd == len(glog) == len(clog)
                     and err <= tol
                     and len(ge.finished) == SERVE_POINT["n_requests"])
        if policy == "lru":
            row["ok"] = row["ok"] and ge.stats.preemptions > 0
        ok &= row["ok"]
        rows.append(row)
    emit({"phase": "serve_small", "config": vars(cfg), "point": SERVE_POINT,
          "policies": rows, "ok": ok})
    if not ok:
        fail("serve_small", "the card and the CPU disagree, or lru did not "
                            "preempt")


def phase_serve_full(dev, recorder: Recorder) -> dict:
    """PagedTinyLM at Qwen2-1.5B's attention widths and depth, the default
    point under pbm, through ``repro_torch.launch.serve``'s objects, with
    the kernel's launch count set to 0 just before and read just after.
    Every forward's logits must be finite; afterwards a few forwards
    through the kernel are held to the same forwards through the plain
    version on the card."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.serving.model import PagedTinyLM, TinyConfig
    cfg = TinyConfig(**QWEN2_1_5B_WIDTHS)
    t0 = time.time()
    lm = PagedTinyLM(cfg, seed=0, device=dev)
    # PagedTinyLM's draw, N(0, 0.05) for every matrix, has no norm to hold
    # it at these widths: each layer multiplies the residual by ~20, the
    # attention scores overflow f32 and the logits are NaN.  Each layer
    # matrix is rescaled to N(0, 1 / fan_in), and the two that write the
    # residual (wo, w2) by a further 1 / sqrt(2 n_layers), as GPT-2
    # initialises them; the embedding stays as drawn.
    with torch.no_grad():
        for layer in lm.layers:
            for name, w in layer.named_parameters():
                scale = 1.0 / (0.05 * w.shape[0] ** 0.5)
                if name in ("wo", "w2"):
                    scale /= (2 * cfg.n_layers) ** 0.5
                w.mul_(scale)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def check(logits):
        finite.logical_and_(torch.isfinite(logits).all())

    captured = recorder.seconds
    ops.reset_launch_counts()
    with recorder:
        eng, wall, forwards = serve_point("pbm", lm, on_logits=check)
    launches = {k: v for k, v in ops.launch_counts().items()
                if k == "paged_attention"}
    captured = recorder.seconds - captured
    st = eng.stats

    # the same forward through the kernel and through the plain version, on
    # stale pool contents (write=False leaves the pool as it is)
    replay_err = 0.0
    for n_pages, pos in ((1, 0), (10, 150), (cfg.n_pages, 447)):
        pages = list(range(n_pages))
        got = lm._forward_token(7, pages, pos, write=False)
        orig = ops.paged_attention
        ops.paged_attention = ref.paged_attention_ref
        try:
            want = lm._forward_token(7, pages, pos, write=False)
        finally:
            ops.paged_attention = orig
        replay_err = max(replay_err, _max_abs_diff(got, want))
    replay_tol = 1e-3
    profile = profile_forwards(lm)
    weights = sum(p.numel() * p.element_size() for p in lm.parameters())
    kv_page = 2 * cfg.n_layers * cfg.page_size * cfg.n_kv_heads \
        * cfg.head_dim * 4
    page_bytes = serve.page_bytes(cfg.page_size, cfg)
    out = {
        "phase": "serve_full", "config": vars(cfg),
        "is": "PagedTinyLM's block (GELU MLP of 4 d, no RoPE, norms or QKV "
              "bias) at Qwen2-1.5B's attention widths and depth, random "
              "weights (seed 0; layer matrices rescaled to N(0, 1/fan_in), "
              "wo and w2 by 1/sqrt(2 n_layers) more): not Qwen2-1.5B",
        "point": SERVE_POINT, "policy": "pbm",
        "weights_bytes": weights, "kv_bytes_per_page_all_layers": kv_page,
        "model_build_s": build_s, "wall_s": wall,
        "capture_s": captured,      # part of wall_s: cloning kernel inputs
        "token_forwards": forwards,
        "ms_per_token_forward": wall / max(1, forwards) * 1e3,
        "engine_steps": st.steps,
        "ms_per_engine_step": wall / max(1, st.steps) * 1e3,
        "tokens_generated": st.tokens_generated,
        "completed": len(eng.finished), "launches": launches,
        "preemptions": st.preemptions, "resumes": st.resumes,
        "prefetched_resumes": st.prefetched_resumes,
        "page_bytes": page_bytes,
        "swap_out_bytes": st.swap_out_bytes,
        "swap_in_bytes": st.swap_in_bytes,
        "swap_bytes_all_layers_f32": (
            (st.swap_out_bytes + st.swap_in_bytes) // page_bytes * kv_page),
        "logits_finite": bool(finite),
        "replay_max_abs_err": replay_err, "replay_tolerance": replay_tol,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "profile": profile,
    }
    out["ok"] = (out["logits_finite"] and replay_err <= replay_tol
                 and len(eng.finished) == SERVE_POINT["n_requests"]
                 and launches["paged_attention"] > 0)
    emit(out)
    del lm, eng
    torch.cuda.empty_cache()
    if not out["ok"]:
        fail("serve_full", "non-finite logits, a kernel/plain disagreement, "
                           "an unfinished request or no kernel launch")
    return out


def profile_forwards(lm):
    """Where a decode token-forward's time goes: 40 forwards at position
    200 over 13 pages (a mid-length request of the default point), each
    ending in the decode step's argmax read, first on the host clock, then
    under ``torch.profiler``: device launches, device busy time and the
    paged-attention kernel's share, per forward."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n, pages, pos = 40, 13, 200
    kv = list(range(pages))

    def window():
        for i in range(n):
            int(torch.argmax(lm._forward_token(7 + i, kv, pos, write=False)))

    window()                                     # warm
    torch.cuda.synchronize()
    t0 = time.time()
    window()
    host_ms = (time.time() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
    busy = b4 = 0.0
    launches = b4_launches = 0
    for k in prof.key_averages():
        if k.device_type != DeviceType.CUDA:
            continue        # operators' rows repeat their kernels' time
        dev_us = getattr(k, "self_device_time_total", 0.0) or 0.0
        busy += dev_us
        launches += k.count
        if "paged_attention" in k.key:
            b4 += dev_us
            b4_launches += k.count
    busy_ms = busy / n / 1e3
    return {
        "forwards": n, "pages": pages, "pos": pos,
        "host_ms_per_forward": host_ms,
        "device_launches_per_forward": launches / n,
        "device_busy_ms_per_forward": busy_ms,
        "device_idle_share": 1.0 - busy_ms / host_ms,
        "paged_attention_launches_per_forward": b4_launches / n,
        "paged_attention_ms_per_forward": b4 / n / 1e3,
        "paged_attention_share_of_device": b4 / max(busy, 1e-9),
        "paged_attention_share_of_forward": b4 / n / 1e3 / host_ms,
    }


# ------------------------------------------------------------- simulator ----

def micro_workload(scale: float, n_streams: int, queries: int, seed: int = 3):
    from repro_torch.core.array_sim import compile_workload
    from repro_torch.core.workload import (
        make_lineitem_db, micro_accessed_bytes, micro_streams)
    db = make_lineitem_db(scale_tuples=int(180_000_000 * scale))
    streams = micro_streams(db, n_streams=n_streams,
                            queries_per_stream=queries, seed=seed)
    return compile_workload(db, streams), micro_accessed_bytes(db)


def sweep_configs(spec, ws, fracs, dev, bandwidth=700e6, lanes=None):
    from repro_torch.core.array_sim import make_config, stack_configs
    if lanes is None:
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
    launch counts set to 0 just before and read just after.  The caller
    names the stepper."""
    from repro_torch.core.array_sim import make_runner, run_sweep
    from repro_torch.kernels import ops
    runner = make_runner(spec, policies=POLICIES, device=dev, **runner_kw)
    ops.reset_launch_counts()
    t0 = time.time()
    results = run_sweep(spec, cfgs, runner=runner, device=dev)
    wall = time.time() - t0
    launches = {k: v for k, v in ops.launch_counts().items()
                if k in SIM_KERNELS}
    steps = runner.stats["cheap_steps"] + runner.stats["refresh_steps"]
    return results, wall, launches, steps, dict(runner.stats)


def phase_sim_small(dev) -> None:
    import torch
    scale, fracs = 0.03, (0.2, 0.4, 0.8)
    spec, ws = micro_workload(scale, 3, 3)
    lanes, cfgs = sweep_configs(spec, ws, fracs, dev)
    cpu = torch.device("cpu")   # asked for explicitly: a comparison
    _, cfgs_cpu = sweep_configs(spec, ws, fracs, cpu)
    out = {"phase": "sim_small", "P": spec.n_pages, "ok": True}
    for stepper in ("fixed", "horizon"):
        kw = dict(time_slice=0.1 * scale, stepper=stepper)
        on_dev, wall, launches, steps, _ = run_sweep_counted(
            spec, cfgs, dev, **kw)
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
            rows.append({"policy": p, "frac": f, "tolerance": tol,
                         "rel": rel, "equal": equal, "ok": lane_ok})
        out[stepper] = {"lanes": rows, "device_equals_cpu": all_equal,
                        "wall_s": wall, "batched_steps": steps,
                        "launches": launches, "ok": ok}
        out["ok"] &= ok
    emit(out)
    if not out["ok"]:
        fail("sim_small", "the card and the CPU disagree beyond tolerance")


class EventRuns:
    """The event engine's reference runs of the calibrated micro workload
    at the validated points (``VALIDATED_FRACS`` x ``POLICIES``), on the
    host in ``EVENT_WORKERS`` worker processes, started before the card's
    sweep so that they run beside it.  ``results()`` waits for them;
    ``close()`` stops the workers."""

    def __init__(self, scale: float):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        self.t0 = time.time()
        self.pool = ProcessPoolExecutor(
            EVENT_WORKERS, mp_context=multiprocessing.get_context("spawn"))
        self.futures = {
            (p, f): self.pool.submit(event_point, scale, p, f)
            for f in VALIDATED_FRACS for p in POLICIES}
        self._results = None

    def results(self) -> dict:
        if self._results is None:
            self._results = {k: f.result() for k, f in self.futures.items()}
            self.seconds = time.time() - self.t0
            self.close()
        return self._results

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


def event_point(scale: float, policy: str, frac: float):
    """One reference point on the host: ``(EngineResult, wall seconds)``
    of the port's event engine, at the lane's own capacity."""
    from repro_torch.core.array_sim.validate import event_run
    from repro_torch.core.workload import (
        make_lineitem_db, micro_accessed_bytes, micro_streams)
    db = make_lineitem_db(scale_tuples=int(180_000_000 * scale))
    streams = micro_streams(db, n_streams=8, queries_per_stream=16, seed=3)
    cap = int(frac * micro_accessed_bytes(db))
    return event_run(db, streams, policy, cap, 700e6, 0.1 * scale, 2.0)


def held_to_events(lanes, results, events: dict, stepper: str) -> list:
    """Rows of ``validate.compare_row`` for the lanes at a validated
    point, each with its bar and verdict."""
    from repro_torch.core.array_sim import validate
    rows = []
    for (p, f), ar in zip(lanes, results):
        if (p, f) not in events:
            continue
        ev, ev_wall = events[(p, f)]
        row = validate.compare_row("micro", p, stepper, f, ev, ev_wall, ar)
        row["bar"] = validate.bar_of(row)
        row["ok"] = bool(not row["truncated"]
                         and validate.worst_error(row) <= row["bar"])
        rows.append(row)
    return rows


def phase_sim_micro(phase: str, scale: float, dev, recorder: Recorder,
                    max_slices=None, events=None):
    """The micro sweep at ``scale`` with the horizon stepper, recorded for
    the kernels phase; with ``events`` (an :class:`EventRuns` of the same
    scale) its lanes at the validated points are held to the event
    engine within ``validate.ERROR_BARS``."""
    spec, ws = micro_workload(scale, n_streams=8, queries=16)
    lanes, cfgs = sweep_configs(spec, ws, FRACS, dev)
    kw = dict(time_slice=0.1 * scale, bandwidth_ref=700e6, stepper="horizon")
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
    if events is not None:
        t0 = time.time()
        held = held_to_events(lanes, results, events.results(), "horizon")
        out["event_engine"] = {
            "rows": held, "wait_s": time.time() - t0,
            "pool_s": events.seconds, "workers": EVENT_WORKERS,
            "wall_s_each": {f"{r['policy']}@{r['buffer_frac']}":
                            r["event_wall_s"] for r in held},
            "host_s": sum(r["event_wall_s"] for r in held)}
        out["within_error_bars"] = all(r["ok"] for r in held)
        out["ok"] = out["ok"] and out["within_error_bars"] and \
            len(held) == len(VALIDATED_FRACS) * len(POLICIES)
    emit(out)
    if not out["ok"]:
        fail(phase, "a lane ended truncated, a kernel was never launched, "
                    "or a lane is outside its bar of the event engine")
    return out


def phase_sim_fixed(dev, events: "EventRuns", ms_per_step: float) -> dict:
    """The fixed-dt stepper on the card at the calibrated scale, held to
    the event engine within the same bars.  Every fine step is a full
    eager step, so a lane's run costs its stream time over dt steps: the
    lanes run are ``FIXED_MUST`` and every other validated point whose
    event run ends within what ``FIXED_BUDGET_S`` of the card's time
    covers at ``ms_per_step`` (sim_calibrated's time a step)."""
    from repro_torch.core.array_sim import validate
    scale = CALIBRATED_SCALE
    spec, ws = micro_workload(scale, n_streams=8, queries=16)
    ev = events.results()
    dt = float(spec.page_size.max()) / 700e6
    budget_sim_s = FIXED_BUDGET_S * 1e3 / ms_per_step * dt
    reach = max(budget_sim_s, max(ev[k][0].sim_time for k in FIXED_MUST))
    lanes, left_out = [], []
    for f in VALIDATED_FRACS:
        for p in POLICIES:
            t_end = ev[(p, f)][0].sim_time
            if (p, f) in FIXED_MUST or t_end <= reach:
                lanes.append((p, f))
            else:
                left_out.append({
                    "policy": p, "frac": f, "event_sim_s": t_end,
                    "why": f"its event run ends at {t_end:.2f} s of "
                           f"simulated time, beyond the {reach:.2f} s "
                           f"that {FIXED_BUDGET_S:.0f} s of the card "
                           f"covers at {ms_per_step:.2f} ms a fine step"})
    _, cfgs = sweep_configs(spec, ws, None, dev, lanes=lanes)
    # the livelock guard at twice the longest event run: a lane that needs
    # more is not comparable and fails the phase as truncated
    max_slices = int(2.0 * reach / (0.1 * scale)) + 8
    results, wall, launches, steps, stats = run_sweep_counted(
        spec, cfgs, dev, time_slice=0.1 * scale, bandwidth_ref=700e6,
        stepper="fixed", max_slices=max_slices)
    held = held_to_events(lanes, results, ev, "fixed")
    out = {"phase": "sim_fixed", "scale": scale, "P": spec.n_pages,
           "L": len(lanes), "rows": held, "left_out": left_out,
           "wall_s": wall, "fine_steps": steps, **stats,
           "ms_per_fine_step": wall / max(1, steps) * 1e3,
           "launches": launches, "max_slices": max_slices,
           "budget_s": FIXED_BUDGET_S, "dt": dt,
           "within_error_bars": all(r["ok"] for r in held),
           "bars": {f"{r['policy']}@{r['buffer_frac']}": validate.bar_of(r)
                    for r in held}}
    out["ok"] = (out["within_error_bars"] and len(held) == len(lanes)
                 and all(m in lanes for m in FIXED_MUST)
                 and launches["batched_evict"] > 0)
    emit(out)
    if not out["ok"]:
        fail("sim_fixed", "a lane of the fixed stepper is outside its bar "
                          "of the event engine, truncated, or missing")
    return launches


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
            stepper="horizon", max_slices=max_slices)
    emit({"phase": "tpch_probe", "P": spec.n_pages, "C": spec.n_cols,
          "Q": spec.n_queries, "max_slices": max_slices, "truncated": True,
          "wall_s": wall, "batched_steps": steps,
          "ms_per_macro_step": wall / max(1, steps) * 1e3,
          "sim_seconds_covered": max(r.sim_time for r in results),
          "launches": launches, "ok": True})
    return launches


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
    # full-f32 matrix products on the serving path (PyTorch's default,
    # stated): TF32 would not meet the f32 tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import (
        _build, flash_attention, mamba2_scan, mlstm, paged_attention,
        pbm_timeline)

    all_phases = ["env", "build", "kernels_fuzz", "paged_fuzz", "model_fuzz",
                  "sim_small", "serve_small", "model_serve", "sim_calibrated",
                  "sim_fixed", "serve_full", "sim_full", "tpch_probe",
                  "kernels"]
    phases = [p for p in args.phases.split(",") if p] or all_phases
    unknown = set(phases) - set(all_phases)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; known: {all_phases}")

    if "env" in phases:
        env = {"phase": "env", "python": sys.version.split()[0],
               "torch": torch.__version__, "cuda_runtime": torch.version.cuda,
               "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        env["nvcc"] = subprocess.run(
            [_build.find_nvcc(), "--version"], capture_output=True,
            text=True, check=True).stdout.strip().splitlines()[-2:]
        env["gpu"] = nvidia_smi_line()
        env["device_name"] = torch.cuda.get_device_name(0)
        emit(env)

    if "build" in phases:
        t0 = time.time()
        libraries = sorted({os.path.basename(s)[:-3]
                            for s in SOURCE.values()})     # csrc/<name>.cu
        with ThreadPoolExecutor(len(libraries)) as pool:   # one nvcc each,
            list(pool.map(_build.load, libraries))         # all at once
        for module in (pbm_timeline, paged_attention, flash_attention,
                       mamba2_scan, mlstm):
            module.library(dev)
        out = {"phase": "build", "seconds": time.time() - t0,
               "nvcc_seconds": _build.build_seconds,
               "sources": sorted(set(SOURCE.values())),
               "flags": list(_build.NVCC_FLAGS)}
        out["resource_usage"] = {name: resource_usage(name)
                                 for name in libraries}
        out["sass"] = {name: sass_counts(name) for name in libraries}
        # ptxas -v of the builds this process ran (none for a library
        # found built): extra output, the gate reads the binaries
        out["ptxas"] = _build.ptxas_usage
        out["warnings"] = {k: v for k, v in _build.build_warnings.items() if v}
        out["ok"], why = build_evidence_ok(out["resource_usage"], out["sass"])
        emit(out)
        if not out["ok"]:
            fail("build", why)

    if "kernels_fuzz" in phases:
        phase_kernels_fuzz(dev)
    if "paged_fuzz" in phases:
        phase_paged_fuzz(dev)
    if "model_fuzz" in phases:
        phase_model_fuzz(dev)
    if "sim_small" in phases:
        phase_sim_small(dev)
    if "serve_small" in phases:
        phase_serve_small(dev)
    model_calls, model_serve = FirstCalls(), None
    if "model_serve" in phases:
        model_serve = phase_model_serve(dev, model_calls)

    recorder = Recorder(SIM_KERNELS, focus=[
        i for i, p in enumerate(LANE_POLICIES) if p == "cscan"])
    serve_recorder = Recorder(("paged_attention",))
    launches, main_p, calibrated, serve_full = None, None, None, None
    # every simulator phase's launch counts; the main path is the
    # calibrated sweep (run to completion and held to the event engine),
    # else the first simulator phase run
    by_phase = {}
    events = None
    if "sim_calibrated" in phases or "sim_fixed" in phases:
        events = EventRuns(CALIBRATED_SCALE)
    try:
        if "sim_calibrated" in phases:
            calibrated = phase_sim_micro("sim_calibrated", CALIBRATED_SCALE,
                                         dev, recorder, events=events)
            launches, main_p = calibrated["launches"], calibrated["P"]
            by_phase["sim_calibrated"] = launches
        if "sim_fixed" in phases:
            ms = (calibrated["ms_per_macro_step"] if calibrated is not None
                  else 10.0)
            by_phase["sim_fixed"] = phase_sim_fixed(dev, events, ms)
    finally:
        if events is not None:
            events.close()
    if "serve_full" in phases:
        serve_full = phase_serve_full(dev, serve_recorder)
    if "sim_full" in phases:
        max_slices = args.full_max_slices
        if max_slices is None and calibrated is not None:
            # scale 1.0 takes roughly four times the macro-steps of scale
            # 0.25 per slice, each FULL_STEP_COST times as dear: run it to
            # its end only if that fits what is left of the target
            budget = TARGET_S - (time.time() - T0) - TAIL_S \
                - (MODEL_KERNELS_S if model_serve is not None else 0.0)
            predicted = 4.5 * FULL_STEP_COST * calibrated["wall_s"]
            if predicted > budget:
                per_slice = (calibrated["batched_steps"]
                             / max(1, calibrated["refresh_steps"]))
                ms = FULL_STEP_COST * calibrated["ms_per_macro_step"]
                max_slices = max(8, int(budget * 1e3 / (ms * 4.0 * per_slice)))
        full = phase_sim_micro("sim_full", 1.0, dev, recorder,
                               max_slices=max_slices)
        by_phase["sim_full"] = full["launches"]
        if launches is None:
            launches, main_p = full["launches"], full["P"]
    if "tpch_probe" in phases:
        by_phase["tpch_probe"] = phase_tpch_probe(dev, recorder)

    kernels_line = None
    if "kernels" in phases:
        if launches is None and serve_full is None and model_serve is None:
            fail("kernels", "needs a simulator phase, serve_full or "
                            "model_serve in the same run")
        entries = []
        if launches is not None:
            entries += sim_kernel_entries(dev, recorder, launches, main_p,
                                          by_phase)
        if serve_full is not None:
            entries.append(paged_kernel_entry(dev, serve_recorder, serve_full))
        if model_serve is not None:
            entries += model_kernel_entries(dev, model_calls, model_serve)
        kernels_line = {"kernels": entries}
        if any(e["mismatches"] for e in entries):
            emit(kernels_line)
            fail("kernels", "a kernel disagrees with its plain version on "
                            "the inputs of its path")

    emit({"phase": "total", "seconds": time.time() - T0,
          "time_limit_s": TIME_LIMIT_S})
    if kernels_line is not None:
        emit(kernels_line)
    if phases != all_phases:
        emit({"ok": False, "partial": True, "phases": phases,
              "device": str(dev)})
        return 3
    if {e["name"] for e in kernels_line["kernels"]} != set(REPLACES):
        fail("kernels", "the kernels line does not list every kernel")
    if any(e["launches"] <= 0 for e in kernels_line["kernels"]):
        fail("kernels", "a kernel of the main path was never launched")
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
