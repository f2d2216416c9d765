#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three paths end to end on the card — the batched
buffer-pool simulator (LRU / PBM / OPT / array-CScan lanes in one call,
the event-horizon and the fixed-dt stepper, held to the port's event
engine inside the JAX package's error bars; its telemetry tier: carried
counters, flight recorder, manifest), the
paged-KV serving path (page pool, policy driver, continuous-batching
engine, ``PagedTinyLM`` decoding through paged attention) and the model
stack's serving path (dense LM, Mamba2 hybrid, xLSTM, MoE, the 5:1
local:global ring, the vision stub and the encoder-decoder at full width
through flash attention, the Mamba2 scan and the mLSTM) and its training
path (``launch.train`` fed by the PBM-cached data pipeline, gradients
through the same kernels, AdamW, checkpoints) — builds the
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
                      HGMMA / HMMA (and TF32 HMMA) / UTMALDG / UBLKCP /
                      LDGSTS: flash_attention must show HGMMA and
                      UTMALDG (its bf16 arm) and TF32 HMMA (its f32 arm's
                      P V, 3xTF32 on mma.sync),
                      paged_attention LDGSTS or UBLKCP, mamba2_scan and
                      mlstm HGMMA or HMMA, pbm_timeline no tensor-core
                      instruction; no kernel of those four libraries (mlstm's
                      f32 and bf16 kernels all listed), and none of
                      batched_evict (both key types), fifo_grant and
                      wake_solve, may have a stack frame or use local memory
2b. ``contracts``     ``repro_torch.analysis``'s static checks on the tree
                      (the step regions' sync lint, the registry
                      cross-check, the kernel rules), then every kernel
                      contract (``analysis.kernels.CONTRACTS``: B1-B7's
                      paths, the page split, bf16 and f32) on the card
                      between guard zones, in poisoned buffers and
                      repeated, each held to its plain version; each
                      kernel's shared memory against the card's opt-in
                      limit; ``compute-sanitizer`` where it runs on the
                      device (its refusal recorded where it does not)
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
                      for the scans a 128-step chunk of one head), and on
                      ``cases.width_cases``: the scan's state past 128
                      columns and off-16 / narrow heads, the mLSTM's K
                      past 1,024, flash attention's f32 arm at dh 64 /
                      128 / 160 / 256 causal, windowed, non-causal and
                      T < S, and both arms past its kernels' widths: dh
                      12 and 100 (zero-padded to a multiple of 8), 264,
                      320 and 512 (the f32 kernel's output in slices of
                      256; bf16 upcast to it)
6. ``sim_small``      a tiny sweep of the four policies on ``cuda`` and,
                      asked for explicitly, on ``cpu``, under both
                      steppers: the two must agree
6a. ``sim_graphs``    the runner on the card replays captured CUDA graphs
                      (the JAX runner's ``jax.jit``): held to its own
                      eager steps (``eager_loop``), every state leaf
                      bit-equal with the same loop stats and launch
                      counts, at sim_small's point and the telemetry
                      tests' tiny point (both steppers; plain, telemetry,
                      sanitize), the
                      calibrated 24 lanes cut at ``GRAPH_CHECK_SLICES``
                      and the (1, 4) mesh runner; then in a fresh child
                      process the CUDA kernels of one replay of each
                      graph against those of its body run eagerly
6b. ``sanitize``      ``make_runner(sanitize=True)`` at the JAX package's
                      sanitize points (micro 4 M tuples, TPC-H 0.02), both
                      steppers x four policies: no NaN, no index outside
                      its extent, one config signature per runner, no
                      truncated lane; the B1 keys that were -0.0
7. ``serve_small``    ``TinyConfig()`` with the same weights on ``cuda`` and,
                      asked for explicitly, on ``cpu``, at the serving
                      benchmark's default point under all four policies:
                      equal stats, token gaps and finish order, every
                      forward's logits within 1e-4
8. ``model_serve``    the model stack's serving path at the full widths of
                      qwen2_1_5b, zamba2_2_7b, xlstm_350m,
                      granite_moe_1b_a400m, gemma3_12b, internvl2_26b,
                      seamless_m4t_large_v2 and llama4_scout_17b_a16e
                      (4 of its 48 layers) in bf16 (random weights from
                      seed 0), one family in memory at a time: prefill of
                      4 x 4,096 positions (and 1 x 32,768 for qwen2, zamba2
                      and gemma3), 32 decode steps at B = 8; after each
                      family, decode-vs-prefill in f32 on 16 tokens over
                      one period of its layers
9. ``sim_calibrated`` micro workload, scale 0.25, 24 lanes = {lru, pbm, opt,
                      cscan} x buffer fractions {0.1 .. 1.0}, horizon
                      stepper, to completion; its 12 lanes at 0.1 / 0.2 /
                      0.4 held to the port's event engine (run on the
                      host in worker processes meanwhile) within
                      ``validate.ERROR_BARS``
10. ``sim_fixed``     the fixed-dt stepper on the card at the same scale:
                      all 12 validated points, held to the same event
                      runs within the same bars (``left_out`` empty),
                      its ms a fine step measured on the run itself
11. ``sim_telemetry`` the simulator's telemetry (``repro_torch.obs``): (a)
                      counters off vs on at the tiny point of the
                      telemetry tests, four policies, both steppers —
                      every state leaf bit-equal, per lane loads and
                      macro-steps equal to the counters'; (b) the same
                      on sim_calibrated's 24 lanes cut at
                      ``TELEMETRY_SLICES`` slices, with the lanes'
                      summaries (hit rate, victim-rank and jump
                      histograms, chunk picks, PBM's bucket occupancy)
                      and the launches and ms a macro-step off and on;
                      (c) the flight recorder at the trace CLI's default
                      point, pbm@0.4: its evictions equal to the
                      runner's counter and within the error bar of the
                      event engine (host, a worker process), its Chrome
                      export, and the run's manifest
12. ``serve_full``    ``PagedTinyLM`` at Qwen2-1.5B's attention widths and
                      depth (28 layers, d 1536, 12 query / 2 KV heads of 128,
                      vocabulary 151,936; random weights from a seed) at the
                      default point under ``pbm``, to completion
13. ``train``         training (``train_loss`` -> autograd, B5-B7 through
                      their Functions: the kernel forward, the plain
                      version's VJP recomputed backward -> AdamW): (a) the
                      card against the CPU at one period of qwen2_1_5b,
                      zamba2_2_7b, xlstm_350m and granite_moe_1b_a400m's
                      published widths, f32, B = 2, T = 128: the loss
                      within 1e-4 relative, every leaf's gradient finite,
                      non-zero and within 1e-3 (B5) / 5e-3 (B6, B7)
                      normwise; xLSTM's params and AdamW state through an
                      async checkpoint round trip, bit-equal; (b)
                      ``launch.train.run`` at qwen2_1_5b's full width and
                      28 layers, f32, 8 x 1,024 tokens in 4 microbatches,
                      the PBM host cache feeding it: a warm step and five
                      timed, ms a step, tokens/s, peak memory, finite
                      losses and gradient norms, B5's 28 x 4 launches a
                      step, and one more step under the profiler (device
                      idle share, B5's and the plain VJP's share); (c) the
                      smoke configuration's loss falls over 40 steps;
                      the dry run of (b)'s step (``launch.dryrun``, on the
                      meta device): its bytes and operations beside the
                      measured peak and step time
13b. ``examples``     ``examples/torch_*.py``, each a child process on the
                      card at its smallest flags, all at once
14. ``sim_full``      the same sweep at scale 1.0 (the paper's size: 180 M
                      tuples, P = 3072); to completion if the time limit
                      allows, else cut at a stated ``max_slices`` and
                      reported as truncated
15. ``tpch_probe``    ``TPCH_SLICES`` slices of the TPC-H workload (P =
                      8832), only to give the kernels that shape with real
                      keys and sizes
16. ``page_split``    page-split candidate selection: (a) B1 and B2 with
                      ``page_shards`` 2, 4 and 8 against the single-stage
                      kernel on the inputs captured at P = 768, 3,072 and
                      8,832 and on seeded and fuzz cases, and B1-B3 at
                      P = 20,000 against their plain versions (0
                      mismatches); (b) ``tpch_big``, TPC-H at scale 4.0
                      (P = 35,328, beyond one block a lane),
                      ``TPCH_SLICES`` slices of the horizon stepper, its inputs kept for ``kernels``;
                      (c) ``make_runner(mesh=)`` with a ('lanes', 'page')
                      mesh of shape (1, 4) on the card at sim_small's
                      point, both steppers, bit-equal to ``mesh=None``
16b. ``mesh_ranks``   the simulator's mesh across processes: (a) in a
                      child, ``tpch_big`` on a (1, 1) ('lanes', 'page')
                      DeviceMesh of one NCCL rank, replayed from graphs
                      with the all-gather inside, bit-equal to
                      ``mesh=None``, its ms a macro-step, the all-gather's
                      time and each stage 1's device ms at its shard
                      offset; (b) two ranks on the one card (``gloo`` on
                      CUDA tensors, stepped eagerly; NCCL one card a rank
                      where there are two), (1, 2) and (2,) meshes at
                      sim_small's point and (1, 2) at ``tpch_big``, cut at
                      ``MESH_RANK_SLICES``, every leaf of both ranks
                      bit-equal to ``mesh=None``; ``device_count``, and
                      ``cross_card`` while the machine has one card
17. ``kernels``       every kernel against its plain version on inputs
                      captured from phases 8-16, and its time per call
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
                      on each captured input and on the first width case
                      of each path past their tiles (``width_paths``),
                      counted by the profiler in a fresh process (each of
                      their passes once, else the phase fails); paged
                      attention also at a deployment's batch
                      (B = 32, 1024-4096 tokens); B4's to B7's bf16 inputs
                      held to f32 as in 4; B6 and B7 also at a width
                      past their tiles and B5 past its kernels' widths
                      (``WIDTH_SHAPES``), timed per call and queued, and
                      held (B5's f32 arm is timed at the training input in
                      ``train``; at the other geometries by
                      ``tools/time_attention_f32.py``)

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
import functools
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
#: what the whole script aims at, to stay under 900 s: sim_full is cut to
#: what is left of it (never below 8 slices); since the runner replays
#: captured graphs the 24-lane calibrated sweep takes ~40-60 s of the
#: ~300 it took eagerly, and the fixed stepper holds every validated point
TARGET_S = 840.0
#: kept for the phases after sim_full (tpch_probe, page_split, mesh_ranks,
#: kernels: ~175 s on an H100 80GB HBM3 at 700 W, mesh_ranks ~85 s of
#: it), and for the kernels phase's timing of the model-stack kernels
TAIL_S, MODEL_KERNELS_S = 200.0, 100.0
#: a scale-1.0 macro-step (P = 3072) over a scale-0.25 one (P = 768),
#: which sim_full's budget reads: 1.74 against 1.54 ms replayed from the
#: runner's graphs on an H100 80GB HBM3 at 700 W (sim_full and
#: sim_calibrated of one run of this script; eagerly it was 7.40 against
#: 4.94)
FULL_STEP_COST = 1.13
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside the tensor cores
#: f32-exact products on the tensor cores as 3xTF32: a third of the dense
#: TF32 rate (495 TFLOP/s), the least time of B5's f32 work on this card
TF32X3_OPS_PER_S = 495e12 / 3
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
#: the model stack's serving path: eight families at their full published
#: widths (src/repro_torch/configs), bf16, weights drawn on the card, one
#: family in memory at a time
MODEL_ARCHS = ("qwen2_1_5b", "zamba2_2_7b", "xlstm_350m",
               "granite_moe_1b_a400m", "gemma3_12b", "internvl2_26b",
               "seamless_m4t_large_v2", "llama4_scout_17b_a16e")
#: depth cuts, named on the family's row as ``reduced``: llama4's 48 layers
#: of 16 experts are about 200 GB in bf16, more than one card holds
MODEL_CUTS = {"llama4_scout_17b_a16e": {"n_layers": 4}}
#: prefill: B = 4 prompts of 4,096 tokens; qwen2, zamba2 and gemma3 (whose
#: 1,024-token window matters there) also take one sequence of
#: prefill_32k's 32,768 tokens (one chip's share of it).  The other new
#: families take no 32k prefill: the first cut of the time budget, named on
#: model_serve's line (``cuts``).  internvl2's prompt is 256 random patch
#: embeddings and 3,840 tokens; seamless's is 4,096 random frame
#: embeddings and 1,024 target tokens (its cross-attention's T != S)
MODEL_PREFILL = ((4, 4096), (1, 32_768))
LONG_PREFILL_ARCHS = ("qwen2_1_5b", "zamba2_2_7b", "gemma3_12b")
ENC_TARGET_DIV = 4
#: layers of one pattern period, the f32 decode-vs-prefill check's depth
#: (1 elsewhere; seamless: one encoder and one decoder layer)
MODEL_PERIOD = {"zamba2_2_7b": 6, "xlstm_350m": 8, "gemma3_12b": 6}
#: decode: 32 tokens at B = 8 from an empty cache of 4,096 positions
MODEL_DECODE = dict(batch=8, steps=32, cache=4096)
#: decode-vs-prefill in f32 at full width, one period: the JAX model test's
#: bar
DECODE_PREFILL_TOKENS, DECODE_PREFILL_TOL = 16, 2e-2
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
#: phase ``train`` (a): the card against the CPU at one period
#: (MODEL_PERIOD) of four families' published widths in f32, B x T tokens;
#: the kernels each family's loss must go through; the loss's relative bar
#: and the normwise bar of every leaf's gradient, the largest of its
#: kernels' (the f32 forward bars of B6 and B7 are 2e-3, of B5 3e-5)
TRAIN_ARCHS = ("qwen2_1_5b", "zamba2_2_7b", "xlstm_350m",
               "granite_moe_1b_a400m")
TRAIN_KERNELS = {"qwen2_1_5b": ("flash_attention",),
                 "zamba2_2_7b": ("flash_attention", "mamba2_scan"),
                 "xlstm_350m": ("mlstm_chunked",),
                 "granite_moe_1b_a400m": ("flash_attention",)}
TRAIN_GRAD_SHAPE = (2, 128)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = {"flash_attention": 1e-3, "mamba2_scan": 5e-3,
                  "mlstm_chunked": 5e-3}
#: (b) launch.train.run at qwen2_1_5b's full width and depth, f32: one
#: warm step and five timed, 8 sequences of 1,024 tokens in 4 microbatches;
#: (c) the smoke configuration's 40 steps must lower the loss (the JAX
#: package's test_tiny_training_reduces_loss, longer); the phase's aim
TRAIN_FULL = dict(arch="qwen2_1_5b", steps=6, batch=8, seq=1024,
                  microbatches=4)
TRAIN_LEARN = dict(arch="qwen2_1_5b", steps=40, batch=4, seq=32, lr=3e-3)
TRAIN_BUDGET_S = 90.0
#: seconds each of the kernel, its plain version and SDPA is timed for on
#: each training input (``train_kernel_rows``)
TRAIN_TIME_BUDGET_S = 0.3
#: where (a) writes its checkpoint, inside this checkout; removed after
TRAIN_CKPT_DIR = ".smoke_ckpt"
#: how far the dry run's predicted peak of (b)'s step (state and live
#: activations, ``launch.dryrun``) may be from the measured one
DRYRUN_PEAK_BAR = 0.20
#: PERF.md's estimate of (b)'s operations in matrix products a step:
#: 6 x 1.54e9 parameters x 8,192 tokens
TRAIN_PRODUCT_FLOPS = 7.6e13
#: the sanitized smoke sweep (both points x both steppers x four policies)
SANITIZE_BUDGET_S = 30.0
#: the static checks and every kernel contract on the card
CONTRACTS_BUDGET_S = 120.0
#: the four examples, each a child process on the card, all at once
EXAMPLES_BUDGET_S = 60.0
#: each example at its smallest flags (the device is the default, cuda),
#: and what its output must hold
EXAMPLES = {
    "torch_quickstart.py": ([], ["step 9 loss", "flash attention kernel "
                                 "launches"]),
    "torch_concurrent_scans_demo.py": (["--scale", "0.01", "--streams", "2"],
                                       ["opt(trace)", "sharing potential"]),
    "torch_serve_paged.py": ([], ["tokens identical under a different "
                                  "eviction policy: True",
                                  "paged attention kernel launches"]),
    "torch_train_lm.py": (["--steps", "3"], ["device=cuda", "done: loss"]),
}
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
#: sim_fixed: the lanes it runs (every validated point)
FIXED_MUST = tuple((p, f) for f in VALIDATED_FRACS for p in POLICIES)
#: sim_graphs: the slices the calibrated sweep's graph-versus-eager check
#: runs (some 200 macro-steps of its 24 lanes)
GRAPH_CHECK_SLICES = 12
#: worker processes for the event engine's reference runs (host, pure
#: Python, while the card runs the sweep)
EVENT_WORKERS = 4
CALIBRATED_SCALE = 0.25
#: sim_telemetry: the card time it aims at, all three parts; the slices
#: part (b) cuts the calibrated sweep at; the macro-steps each runner (off,
#: on) takes before its windows, those of a timed window and those of the
#: profiled one (the profiler's own processing grows with the events)
TELEMETRY_BUDGET_S = 45.0
TELEMETRY_SLICES = 24
TELEMETRY_WARM, TELEMETRY_WINDOW, TELEMETRY_PROFILED = 100, 50, 20
#: the horizon stepper's slices in ``tpch_probe`` and ``page_split`` (b)
TPCH_SLICES = 16
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
# The build gate (SASS and cuobjdump -res-usage rules on the built
# libraries) lives in repro_torch.analysis.kernels (build_gate), beside the
# kernels' static rules.

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


def _plain_split(unsplit, split):
    """A buffer-pool kernel's plain version that takes ``page_shards`` as
    the simulator's step passes it: the sharded plain version for a split
    into more than one shard, else the unsplit one."""
    def plain(*args, page_shards=1, **static):
        if page_shards > 1:
            return split(*args, page_shards, **static)
        return unsplit(*args, **static)
    return plain


def kernel_fns():
    from repro_torch.kernels import ops, ref
    return {
        "batched_evict": (ops.batched_evict, _plain_split(
            ref.batched_evict_ref, ref.evict_page_sharded)),
        "fifo_grant": (ops.fifo_grant, _plain_split(
            ref.fifo_grant_ref, ref.grant_page_sharded)),
        "wake_solve": (ops.wake_solve, ref.wake_solve_ref),
        "paged_attention": (ops.paged_attention, ref.paged_attention_ref),
    }


def _split(args, static) -> bool:
    """Whether a captured call took the page-split path."""
    from repro_torch.kernels.pbm_timeline import splits
    return splits(args[0].shape[1], static.get("page_shards", 1))


def path_counts(name, inputs) -> dict:
    """Lanes of the calls ``inputs`` (``[(args, static), ...]``) that took
    each path of ``name``'s kernel (``pbm_timeline.PATHS``: nothing to do,
    the head of the service order selected and sorted alone, the whole row
    sorted, and for batched_evict every page a candidate), computed on the
    host from the inputs as the kernel decides on the device."""
    from repro_torch.kernels.pbm_timeline import (
        PATHS, SPLIT_PATHS, lane_paths)
    counts = {f"{path}_lanes": 0 for path in PATHS[name]}
    if any(_split(args, static) for args, static in inputs):
        counts.update({f"{path}_lanes": 0 for path in SPLIT_PATHS})
    for args, static in inputs:
        for path in lane_paths(name, args, static):
            counts[f"{path}_lanes"] += 1
    return counts


def path_counts_by_policy(name, inputs) -> dict:
    """``path_counts`` split by the policy of each lane: every recorded
    sweep has the lanes of ``sweep_configs`` (``LANE_POLICIES``)."""
    from repro_torch.kernels.pbm_timeline import (
        PATHS, SPLIT_PATHS, lane_paths)
    paths = PATHS[name] + SPLIT_PATHS[1:] if any(
        _split(args, static) for args, static in inputs) else PATHS[name]
    counts = {p: {f"{path}_lanes": 0 for path in paths} for p in POLICIES}
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
    finds them idle.

    The simulator's runner replays captured CUDA graphs, in which a
    wrapper runs once, at capture.  There the inputs are cloned inside the
    graph (a slot that every replay of that graph refreshes: some copies
    a step on the device, in the runs recorded only), and every replay of
    a graph counts as one call of each kernel it holds: a sampled one
    clones the slot after the replay.  The warm-up run that precedes each
    capture, on a side stream and on copies of the buffers that the run
    then drops, is neither counted nor sampled."""

    STRIDE, CAP = 97, 12

    def __init__(self, names=SIM_KERNELS, focus=None):
        self.names = tuple(names)
        self.samples = {}      # (kernel, dim) -> [(args, static), ...]
        self.busy = {}         # the same, the focus lanes at work
        self.focus = focus
        self._calls = {}
        self._slots = {}       # graph -> [(kernel, (clones, static)), ...]
        self._capturing = None
        self.seconds = 0.0

    def __enter__(self):
        import torch
        from repro_torch.kernels import ops
        self._ops = ops
        self._stream = torch.cuda.current_stream()
        self._orig = {n: getattr(ops, n) for n in self.names}
        for name, fn in self._orig.items():
            setattr(ops, name, self._wrap(name, fn))
        graph = torch.cuda.CUDAGraph
        self._graph_orig = (graph.capture_begin, graph.replay)
        begin, replay = self._graph_orig
        recorder = self

        def capture_begin(g, *a, **k):
            recorder._capturing = g
            return begin(g, *a, **k)

        def replayed(g):
            replay(g)
            for name, slot in recorder._slots.get(g, ()):
                recorder._sample(name, slot)
        graph.capture_begin, graph.replay = capture_begin, replayed
        return self

    def __exit__(self, *exc):
        import torch
        for name, fn in self._orig.items():
            setattr(self._ops, name, fn)
        graph = torch.cuda.CUDAGraph
        graph.capture_begin, graph.replay = self._graph_orig

    def _wrap(self, name, fn):
        import torch

        def wrapped(*args, **static):
            if torch.cuda.is_current_stream_capturing():
                slot = ([a.clone() for a in args], dict(static))
                self._slots.setdefault(self._capturing, []).append(
                    (name, slot))
                return fn(*args, **static)
            if torch.cuda.current_stream() == self._stream:
                self._sample(name, (args, static))
            return fn(*args, **static)
        return wrapped

    def _sample(self, name, call):
        args, static = call
        i = self._calls[name] = self._calls.get(name, 0) + 1
        if i % self.STRIDE == 0:
            t0 = time.perf_counter()
            key = (name, args[0].shape[1])
            sample = ([a.clone() for a in args], dict(static))
            self._keep(self.samples.setdefault(key, []), sample)
            if self.focus is not None and self._focus_busy(name, sample):
                self._keep(self.busy.setdefault(key, []), sample)
            self.seconds += time.perf_counter() - t0

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
            if _split(args, static):     # each launch of the split's stages
                by_p[P]["cuda_kernels"] = cuda_kernel_times(
                    lambda: kernel(*args, **static))
                if name == "batched_evict":
                    # the same keys with every lane freeing: the split's
                    # head path in every lane
                    busy = [*args[:3], torch.full_like(args[3], 1e12)]
                    b, e = _compare(kernel(*busy, **static),
                                    plain(*busy, **static))
                    bad, err = bad + b, max(err, e)
                    by_p[P]["every_lane_freeing"] = {
                        "mismatches": b, "paths": path_counts(
                            name, [(busy, static)]),
                        "ms": _time_ms(lambda: kernel(*busy, **static), dev),
                        "plain_ms": _time_ms(
                            lambda: plain(*busy, **static), dev),
                        **_queued_row(lambda: kernel(*busy, **static)),
                        "cuda_kernels": cuda_kernel_times(
                            lambda: kernel(*busy, **static))}
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
    for case in cases.model_cases() + cases.width_cases():
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
    arguments of the first call at each input shape and keyword arguments
    (gemma3's local and global layers, seamless's encoder and
    cross-attention), labelled with the
    configuration that made it: ``samples`` is kernel -> [(label, args,
    static), ...]."""

    def __init__(self):
        super().__init__(MODEL_KERNELS)
        self.label = ""

    def _wrap(self, name, fn):
        def wrapped(*args, **static):
            got = self.samples.setdefault(name, [])
            shape = tuple(a.shape for a in args)
            if all(tuple(x.shape for x in s[1]) != shape or s[2] != static
                   for s in got):
                t0 = time.perf_counter()
                got.append((self.label, [a.detach().clone() for a in args],
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
    """A zero cache of the specs' tree; float leaves in ``dtype`` if
    given."""
    import torch
    if isinstance(specs, dict):
        return {k: _zero_cache(v, dev, dtype) for k, v in specs.items()}
    dt = dtype if dtype is not None and specs.dtype.is_floating_point \
        else specs.dtype
    return torch.zeros(specs.shape, dtype=dt, device=dev)


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


def prefill_batch(cfg, B: int, T: int, g, dev, dtype, patches=None):
    """The family's prefill batch of B prompts of T positions: tokens; for
    the vision stub ``patches`` random patch embeddings (default the
    config's 256) and T - patches tokens; for the encoder-decoder T random
    frame embeddings and T / ENC_TARGET_DIV target tokens."""
    import torch
    if cfg.is_encdec:
        tgt = max(1, T // ENC_TARGET_DIV)
        return {"src_embeds": torch.randn((B, T, cfg.d_model), generator=g,
                                          device=dev, dtype=dtype),
                "tgt_tokens": torch.randint(0, cfg.vocab_size, (B, tgt),
                                            generator=g, device=dev,
                                            dtype=torch.int32)}
    n = 0 if cfg.frontend != "vision" else (
        cfg.frontend_tokens if patches is None else patches)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, T - n),
                                     generator=g, device=dev,
                                     dtype=torch.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.randn((B, n, cfg.d_model), generator=g,
                                            device=dev, dtype=dtype)
    return batch


def fill_cross(model, params, cache, src):
    """The encoder-decoder's cross cache from the encoder's output on the
    frames ``src`` (``ENC_FRAMES`` of them), as serving fills it."""
    from repro_torch.models.transformer import encdec_cross_kv
    ck, cv = encdec_cross_kv(params, model.encode(params, src), model.cfg)
    cache["cross"]["k"].copy_(ck)
    cache["cross"]["v"].copy_(cv)
    cache["enc_done"].fill_(1)


def one_period(cfg, params):
    """The family cut to one pattern period at full width, its weights the
    first period of ``params`` in f32, and for an MoE a capacity with no
    drop (decode, one token a row, never drops; a prefill may): ``(model,
    params32, what was cut)``."""
    import dataclasses
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_paths, unflatten
    cut = {"n_layers": min(MODEL_PERIOD.get(cfg.name, 1), cfg.n_layers)}
    if cfg.is_encdec:
        cut["encoder_layers"] = 1
    if cfg.moe:
        cut["capacity_factor"] = cfg.n_experts / cfg.top_k
    model = build_model(dataclasses.replace(cfg, **cut))
    specs = tree_paths(model.param_specs)
    full = tree_paths(params)
    params32 = unflatten({
        path: full[path][tuple(slice(0, d) for d in spec.shape)].float()
        for path, spec in specs.items()})
    return model, params32, cut


def decode_matches_prefill(model, params, dev, seed: int = 3):
    """The last logits of one prompt of DECODE_PREFILL_TOKENS tokens, in
    f32, by prefill and decoded token by token from a zero f32 cache
    (xLSTM's with its sLSTM stabiliser ``sm`` at -1e9, where
    ``slstm_block`` starts it; a zero cache is a fault of the reference,
    ROADMAP §C; internvl2's prompt with no patch position, decode having
    no frontend; seamless's cross cache filled from the encoder on the
    prefill's ``ENC_FRAMES`` frames): ``(max |difference|, largest excess
    over atol = rtol = DECODE_PREFILL_TOL (0 when all within), max
    |prefill logit|)``."""
    import torch
    from repro_torch.models.transformer import ENC_FRAMES
    cfg = model.cfg
    g = torch.Generator(device=dev).manual_seed(seed)
    n = DECODE_PREFILL_TOKENS
    batch = prefill_batch(cfg, 1, ENC_FRAMES if cfg.is_encdec else n, g, dev,
                          torch.float32, patches=0)
    toks = batch["tgt_tokens"] if cfg.is_encdec else batch["tokens"]
    toks = toks[:, :n]
    if cfg.is_encdec:
        batch["tgt_tokens"] = toks
    pre = model.prefill_logits(params, batch)[0, -1].float()
    cache = _zero_cache(model.cache_specs(1, n), dev, torch.float32)
    if "sm" in cache:
        cache["sm"].fill_(-1e9)
    if cfg.is_encdec:
        fill_cross(model, params, cache, batch["src_embeds"])
    logits = None
    for pos in range(n):
        logits, cache = model.serve_step(
            params, cache, {"token": toks[:, pos:pos + 1], "pos": pos})
    diff = (logits[0, -1].float() - pre).abs()
    excess = diff - DECODE_PREFILL_TOL * (1.0 + pre.abs())
    return float(diff.max()), float(excess.max().clamp(min=0.0)), \
        float(pre.abs().max())


def phase_model_serve(dev, calls: FirstCalls) -> dict:
    """The model stack's serving path at eight families' full widths in
    bf16 (llama4 cut in depth, ``MODEL_CUTS``): ``build_model`` ->
    ``init_params`` (seed 0, on the card, stacked matrices rescaled by
    ``fan_in_rescale``) -> ``prefill_logits`` (B = 4 x 4,096 positions;
    one 32,768-token sequence for ``LONG_PREFILL_ARCHS``) -> ``serve_step``
    (32 tokens at B = 8 from an empty 4,096-position cache).  Launch counts
    are set to 0 just before and read after each family's path; right
    after it (its launches not counted), the family's f32
    decode-vs-prefill check on one period, then its weights are freed."""
    import torch
    from repro_torch.kernels import ops
    rows = []
    launches = {k: 0 for k in MODEL_KERNELS}
    t_path = 0.0
    ok = True
    for arch in MODEL_ARCHS:
        ops.reset_launch_counts()
        t0 = time.time()
        with calls:
            row, model, params = _serve_arch(arch, dev, calls)
        t_path += time.time() - t0
        for k in MODEL_KERNELS:
            launches[k] += row["launches"].get(k, 0)
        ok &= row["logits_finite"] and bool(row["launches"])
        cfg = model.cfg
        del model
        model32, params32, cut = one_period(cfg, params)
        del params
        torch.cuda.empty_cache()
        diff, excess, scale = decode_matches_prefill(model32, params32, dev)
        row["decode_vs_prefill_f32"] = {
            "tokens": DECODE_PREFILL_TOKENS, "one_period": cut,
            "max_abs_diff": diff, "logit_scale": scale,
            "tolerance": DECODE_PREFILL_TOL, "excess_over_tolerance": excess}
        ok &= excess == 0.0
        del model32, params32
        torch.cuda.empty_cache()
        rows.append(row)
        emit({"phase": "model_serve_family", **row})
    cuts = {"32k_prefill_not_run": [a for a in MODEL_ARCHS
                                    if a not in LONG_PREFILL_ARCHS],
            "depth": MODEL_CUTS}
    out = {"phase": "model_serve", "archs": rows, "launches": launches,
           "cuts": cuts, "path_s": t_path, "capture_s": calls.seconds}
    out["ok"] = ok and all(launches[k] > 0 for k in MODEL_KERNELS) and all(
        r["launches"].get("flash_attention", 0) > 0 for r in rows
        if r["arch"] != "xlstm_350m")       # every family but xLSTM has B5
    emit(out)
    if not out["ok"]:
        fail("model_serve", "non-finite logits, a kernel never launched or "
                            "decode disagreeing with prefill")
    return out


def _serve_arch(arch, dev, calls: FirstCalls):
    """One family of ``phase_model_serve``'s main path: ``(row, model,
    params)``."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, init_params, tree_paths
    from repro_torch.models.layers import fan_in_rescale
    from repro_torch.models.transformer import ENC_FRAMES
    cfg = get_config(arch)
    reduced = {k: [getattr(cfg, k), v] for k, v in
               MODEL_CUTS.get(arch, {}).items()}
    cfg = dataclasses.replace(cfg, **MODEL_CUTS.get(arch, {}))
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    dtype = getattr(torch, cfg.dtype)
    # the reference's draw is too ill-conditioned at full width for the f32
    # decode-vs-prefill check (ROADMAP §C): each stacked matrix is rescaled
    # to its own fan-in; with that draw Zamba2's and xLSTM's f32 decode left
    # prefill by a third of the logits' scale, with this one by ~1e-5
    params, init_s = _sync_time(lambda: fan_in_rescale(
        model.param_specs, init_params(
            model.param_specs, torch.Generator(device=dev).manual_seed(0),
            dtype, dev)))
    n_params = sum(t.numel() for t in tree_paths(params).values())
    g = torch.Generator(device=dev).manual_seed(1)
    row = {"arch": arch, "dtype": cfg.dtype, "params": n_params,
           "init_s": init_s, "prefill": [], "launches": {}}
    if reduced:
        row["reduced"] = reduced
    before = ops.launch_counts()
    finite = True
    for B, T in MODEL_PREFILL:
        if T > 4096 and arch not in LONG_PREFILL_ARCHS:
            continue
        batch = prefill_batch(cfg, B, T, g, dev, dtype)
        calls.label = f"{arch} prefill B={B} T={T}"
        logits, secs = _sync_time(lambda: model.prefill_logits(params, batch))
        fin = bool(torch.isfinite(logits).all())
        finite &= fin and tuple(logits.shape) == (B, 1, cfg.padded_vocab)
        row["prefill"].append({"B": B, "T": T, "seconds": secs,
                               "tokens_per_s": B * T / secs,
                               "logits_finite": fin,
                               "inputs": {k: list(v.shape)
                                          for k, v in batch.items()}})
        del logits, batch
    mid = ops.launch_counts()
    D = MODEL_DECODE
    cache = _zero_cache(model.cache_specs(D["batch"], D["cache"]), dev)
    enc_s = None
    if cfg.is_encdec:           # the encoder's K/V, as serving fills them
        src = torch.randn((D["batch"], ENC_FRAMES, cfg.d_model), generator=g,
                          device=dev, dtype=dtype)
        calls.label = f"{arch} encode B={D['batch']} frames={ENC_FRAMES}"
        _, enc_s = _sync_time(lambda: fill_cross(model, params, cache, src))
        del src
    first = torch.randint(0, cfg.vocab_size, (D["batch"], 1), generator=g,
                          device=dev, dtype=torch.int32)
    calls.label = f"{arch} decode B={D['batch']}"
    dec_finite, secs = _sync_time(lambda: _decode(
        model, params, cache, first, D["steps"]))
    finite &= dec_finite
    del cache
    row["decode"] = {**D, "seconds": secs,
                     "tokens_per_s": D["batch"] * D["steps"] / secs,
                     "ms_per_step": secs / D["steps"] * 1e3,
                     "logits_finite": dec_finite}
    if enc_s is not None:
        row["decode"]["encode_cross_s"] = enc_s
    after = ops.launch_counts()
    row["launches"] = {k: after[k] - before[k] for k in MODEL_KERNELS
                       if after[k] != before[k]}
    n_prefills = sum(1 for _, T in MODEL_PREFILL
                     if T <= 4096 or arch in LONG_PREFILL_ARCHS)
    row["launches_per_forward"] = {k: (mid[k] - before[k]) // n_prefills
                                   for k in row["launches"]}
    row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    row["logits_finite"] = finite
    return row, model, params


def _model_bound_ms(kernel, args, static, f32_rate=None):
    """Least time of a model-stack call: operations at the dtype's rate
    (bf16 989 TFLOP/s; f32 67 outside the tensor cores, and for B5's f32
    work, which 3xTF32 could do on them, 165) against its bytes at 3.35
    TB/s; ``f32_rate`` overrides the f32 rate."""
    import torch
    from repro_torch.kernels import accounting
    ops, nbytes = accounting.work(kernel, args, static)
    if args[0].dtype == torch.bfloat16:
        rate = BF16_OPS_PER_S
    elif f32_rate is not None:
        rate = f32_rate
    else:
        rate = TF32X3_OPS_PER_S if kernel == "flash_attention" \
            else FP32_OPS_PER_S
    t_ops = ops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


#: B6 and B7 at a width past their tiles, timed beside the captured
#: shapes: Zamba2's prefill (4 x 4,096, 80 heads of 64) with a state of
#: 256, and xLSTM-350M's (4 x 4,096, 4 heads, P = 512) with K = 2,048, in
#: bf16; and that mLSTM in f32 at 1 x 1,024
WIDTH_SHAPES = (("mamba2_scan", "bfloat16", (4, 4096, 80, 64, 256)),
                ("mlstm_chunked", "bfloat16", (4, 4096, 4, 2048, 512)),
                ("mlstm_chunked", "float32", (1, 1024, 4, 2048, 512)),
                # B5 (B, T, H, Hk, dh), causal: a dh off 8 (padded) and
                # one past 256 (the f32 kernel's output slices; bf16 on it)
                ("flash_attention", "bfloat16", (4, 4096, 16, 16, 100)),
                ("flash_attention", "float32", (1, 4096, 8, 8, 512)),
                ("flash_attention", "bfloat16", (1, 4096, 8, 8, 512)))


def width_rows(name: str, dev) -> list:
    """``WIDTH_SHAPES``' rows of kernel ``name``: held to the plain version
    (at the dtype's bar; bf16 also normwise against f32) and timed per
    call, with the bound and, for B5, one SDPA call on the same inputs.  Their paths' CUDA launches a call are counted in
    ``model_fuzz`` (``width_paths``)."""
    import torch
    kernel, plain = model_fns()[name]
    rows = []
    for kname, dtype, shape in WIDTH_SHAPES:
        if kname != name:
            continue
        g = torch.Generator(device=dev).manual_seed(5)
        dt = getattr(torch, dtype)
        static = {}
        if name == "flash_attention":
            B, T, H, Hk, dh = shape
            static = {"causal": True}
            args = [(0.5 * torch.randn(B, L, h, dh, generator=g, device=dev)
                     ).to(dt) for L, h in ((T, H), (T, Hk), (T, Hk))]
        elif name == "mamba2_scan":
            B, T, H, P, N = shape
            args = [(0.5 * torch.randn(B, T, H, P, generator=g, device=dev)
                     ).to(dt),
                    0.6 + 0.4 * torch.rand(B, T, H, generator=g, device=dev),
                    (0.3 * torch.randn(B, T, N, generator=g, device=dev)
                     ).to(dt),
                    (0.3 * torch.randn(B, T, N, generator=g, device=dev)
                     ).to(dt)]
        else:
            B, T, H, K, P = shape
            args = [torch.randn(B, T, H, K, generator=g, device=dev).to(dt),
                    (0.3 * torch.randn(B, T, H, K, generator=g, device=dev)
                     ).to(dt),
                    torch.randn(B, T, H, P, generator=g, device=dev).to(dt),
                    0.7 + 0.3 * torch.rand(B, T, H, generator=g, device=dev),
                    0.1 + 0.9 * torch.rand(B, T, H, generator=g, device=dev)]
        held = _held_to_plain(name, args, static, dtype)
        if dtype == "bfloat16":
            held.update(_vs_f32(plain, kernel(*args, **static), args, static))
            held["mismatches"] += not _normwise_worst(held) <= NORMWISE_TOL
        torch.cuda.empty_cache()
        bound, bound_by = _model_bound_ms(name, args, static)
        path = _width_path(name, args, dtype)
        if name == "flash_attention":
            from repro_torch.kernels import flash_attention as fa
            dhp, run_dtype = fa.launch_plan(shape[-1], args[0].dtype)
            how = "sliced" if dhp > fa.MAX_DH else "padded"
            path = (f"flash_attention[{how},{dtype} on "
                    f"{str(run_dtype).replace('torch.', '')}]")

        def call():
            return kernel(*args, **static)
        sdpa = (_sdpa_call(*args, static) if name == "flash_attention"
                else None)
        rows.append({"shape": list(shape), "dtype": dtype, "static": static,
                     "path": path, **held,
                     "ms": _time_budget_ms(call, dev),
                     **_queued_row(call, sdpa),
                     "library_ms": (None if sdpa is None
                                    else _time_budget_ms(sdpa, dev)),
                     "bound_ms": bound, "bound_by": bound_by})
        del args, sdpa
        torch.cuda.empty_cache()
    return rows


def _time_budget_ms(fn, dev, budget_s: float = 1.5) -> float:
    """``_time_ms`` with as many launches as fit ``budget_s`` (3 to 30)."""
    import torch
    _, once = _sync_time(fn)
    n = int(min(30, max(3, budget_s / max(once, 1e-6))))
    return _time_ms(fn, dev, n=n, warm=1)


def _sdpa_call(q, k, v, static):
    """One ``scaled_dot_product_attention`` on the same q/k/v with KV
    expanded to H heads beforehand: causal from the top-left corner (T = S
    on the model path), a sliding window as a boolean mask of the same
    positions (query t, key s kept while 0 <= t - s + offset < window):
    the yardstick; the port never calls it."""
    import torch
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2)
    causal = static.get("causal", True)
    window = static.get("window")
    mask = None
    if window is not None:
        T, S = q.shape[1], k.shape[1]
        off = static.get("offset")
        off = S - T if off is None else off
        rel = (torch.arange(T, device=q.device)[:, None]
               - torch.arange(S, device=q.device)[None, :] + off)
        mask = rel < window
        if causal:
            mask &= rel >= 0

    def call():
        if mask is not None:
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
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
#: the same past the tiles' widths, by path and dtype: the scan's state in
#: slices (their shares of y added by a fourth launch), the scan's off-16
#: widths padded (the three passes; the padding and the cut are PyTorch
#: copies, reported apart), the mLSTM's K in slices (the parts added and
#: divided by a last launch; in f32 its one kernel and the combine)
_SSD = ("chunk_state", "state_pass", "chunk_scan")
WIDTH_PASSES = {
    "mamba2_scan[n_slices,f32]": _SSD + ("sum_slices",),
    "mamba2_scan[n_slices,bf16]": _SSD + ("sum_slices",),
    "mamba2_scan[padded,f32]": _SSD,
    "mamba2_scan[padded,bf16]": _SSD,
    "mlstm_chunked[k_slices,bf16]": ("mlstm_scores", "mlstm_recur",
                                     "mlstm_combine"),
    "mlstm_chunked[k_slices,f32]": ("mlstm_ffma", "mlstm_combine"),
}


def width_launches(dev) -> dict:
    """The CUDA kernels one call of each ``WIDTH_PASSES`` path launches,
    on the first width case that takes it (profiler): path -> {"case":
    name, "kernels": {kernel: launches a call}}."""
    from repro_torch.kernels import cases
    fns, out = model_fns(), {}
    for case in cases.width_cases():
        args = cases.model_tensors(case, dev)
        path = _width_path(case["kernel"], args, case["dtype"])
        if path is None or path in out:
            continue
        kernel = fns[case["kernel"]][0]
        out[path] = {"case": case["name"], "kernels": cuda_kernels_per_call(
            lambda: kernel(*args, **case["static"]))}
    return out


def count_launches(path: str, dev) -> dict:
    """The child's side of :func:`launch_counts_child`: the CUDA kernels a
    call launches on each input saved at ``path`` (kernel name, args,
    static), then on the width cases."""
    import torch
    fns = model_fns()
    saved = torch.load(path, map_location=dev)
    return {"captured": [cuda_kernels_per_call(
                lambda: fns[name][0](*args, **static))
            for name, args, static in saved],
            "width": width_launches(dev)}


def launch_counts_child(inputs: list) -> dict:
    """:func:`count_launches` in a fresh process (``--count-launches``) on
    ``inputs`` (kernel name, args, static), saved to a temporary file: in a
    process that has made many launches the profiler recorded fewer
    kernels than ran, up to none (``tools/profiler_window_drift.py``); a
    fresh process counts them whole."""
    import tempfile
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save(inputs, path)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--count-launches", path],
                              capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail("kernels", f"the launch count exited {proc.returncode}: "
                        f"{proc.stdout[-1000:]} {proc.stderr[-1500:]}")
    return json.loads(lines[-1])


def _width_path(kernel: str, args, dtype: str):
    """The ``WIDTH_PASSES`` path a call takes, None for the widths the
    tiles take as they are (``mamba2_scan.plan``, ``mlstm.k_slices``)."""
    from repro_torch.kernels import mamba2_scan, mlstm
    dt = "bf16" if dtype == "bfloat16" else "f32"
    if kernel == "mamba2_scan":
        P, N = args[0].shape[-1], args[2].shape[-1]
        pl = mamba2_scan.plan(P, N)
        if len(pl["slices"]) > 1:
            return f"mamba2_scan[n_slices,{dt}]"
        if (pl["P_pad"], pl["N_pad"]) != (P, N):
            return f"mamba2_scan[padded,{dt}]"
    if kernel == "mlstm_chunked" and len(mlstm.k_slices(
            args[0].shape[-1])) > 1:
        return f"mlstm_chunked[k_slices,{dt}]"
    return None


def cuda_kernels_per_call(fn, reps: int = 20) -> dict:
    """The CUDA kernels one call of ``fn`` launches, by name, each with its
    launches per call (:func:`cuda_kernel_times`)."""
    return {k: v["per_call"] for k, v in cuda_kernel_times(fn, reps).items()}


def cuda_kernel_times(fn, reps: int = 20) -> dict:
    """The CUDA kernels one call of ``fn`` launches, by name, each with its
    launches and device ms per call, by ``torch.profiler`` (device activity only,
    as ``tools/time_ssd_passes.py`` reads it) over ``reps`` calls.  A
    warm-up step of as many calls comes first: late in a long process the
    device activity started recording some milliseconds after the profiler
    was entered, and the first calls' kernels went uncounted; each step
    also waits 0.1 s before its first call.  In a process that has made
    many launches the profiler records fewer kernels than ran, whatever the
    window's layout (``tools/profiler_window_drift.py``): a count that is
    checked is made in a fresh process (:func:`launch_counts_child`)."""
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
    return {k.key: {"per_call": k.count / reps,
                    "device_ms_per_call": (getattr(k, "self_device_time_total",
                                                   0.0) or 0.0)
                    / reps / 1e3}
            for k in prof.key_averages() if is_kernel(k)}


def _pass_launches(name: str, kernels: dict) -> dict:
    """``cuda_kernels_per_call``'s count for one call of ``name``'s
    kernel (or of a ``WIDTH_PASSES`` path), held to the design: each of
    its passes once and nothing else (a padded path's PyTorch copies are
    counted apart, ``layout_launches_per_call``)."""
    passes = {**CUDA_PASSES, **WIDTH_PASSES}[name]
    ours = {k: n for k, n in kernels.items() if any(p in k for p in passes)}
    per_pass = {p: sum(n for k, n in ours.items() if p in k)
                for p in passes}
    total, layout = sum(ours.values()), sum(kernels.values()) - sum(
        ours.values())
    if total != len(passes) or any(n != 1 for n in per_pass.values()) \
            or (layout and "[padded" not in name):
        fail("kernels", f"{name}: a call launched {kernels}, expected each "
                        f"of {passes} once")
    out = {"cuda_launches_per_call": total, "cuda_kernels": kernels}
    if layout:
        out["layout_launches_per_call"] = layout
    return out


def model_kernel_entries(dev, calls: FirstCalls, serve: dict,
                         train: dict = None) -> list:
    """B5-B7 against their plain versions on every input captured from
    ``model_serve``, twice: as captured (bf16) and cast to f32, where the
    tolerance is far below a typical output (``rms_want``), each with 0
    elements outside; and the timings of each captured shape in bf16.  The
    top-level numbers are the B = 4 x 4,096 prefill's of the kernel's first
    family.  With ``train`` (``phase_train``'s line), each kernel's
    training inputs as that phase held and timed them (``train_shapes``),
    their mismatches counted with the serving inputs'."""
    import torch
    from repro_torch.kernels import accounting, cases
    fns = model_fns()
    entries = []
    counted = [(name, i) for name in CUDA_PASSES
               for i, _ in enumerate(calls.samples.get(name, []))]
    counts = launch_counts_child([
        (name, *calls.samples[name][i][1:]) for name, i in counted])
    per_input = dict(zip(counted, counts["captured"]))
    width_paths = {p: {"case": w["case"],
                       **_pass_launches(p, w["kernels"])}
                   for p, w in counts["width"].items()}
    if set(width_paths) != set(WIDTH_PASSES):
        fail("kernels", f"the width cases ran {sorted(width_paths)}, "
                        f"expected {sorted(WIDTH_PASSES)}")
    for name in MODEL_KERNELS:
        kernel, plain = fns[name]
        samples = calls.samples.get(name, [])
        if not samples:
            fail("kernels", f"{name}: no input captured in model_serve")
        rows, bad, err, err32 = [], 0, 0.0, 0.0
        for i, (label, args, static) in enumerate(samples):
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
                   "static": dict(static),
                   **held, "float32": held32, "ms": ms, **queued,
                   "tflops": accounting.work(name, args, static)[0]
                   / (queued["device_ms"] * 1e-3) / 1e12,
                   "plain_ms": _time_budget_ms(
                       lambda: plain(*args, **static), dev),
                   "library_ms": None,
                   "bound_ms": bound, "bound_by": bound_by}
            if sdpa is not None:
                row["library_ms"] = _time_budget_ms(sdpa, dev)
            if name in CUDA_PASSES:        # one count a call, a launch a pass
                row.update(_pass_launches(name, per_input[(name, i)]))
            rows.append(row)
            torch.cuda.empty_cache()
        main = rows[0]
        trained = [r for r in (train or {}).get("kernel_inputs", [])
                   if r["kernel"] == name]
        bad += sum(r["mismatches"] for r in trained)
        err32 = max([err32] + [r["max_abs_err"] for r in trained
                               if r["dtype"] == "float32"])
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": serve["launches"][name],
            "launches_per_forward": {
                r["arch"]: r["launches_per_forward"][name]
                for r in serve["archs"] if name in r["launches_per_forward"]},
            "max_abs_err": err, "max_abs_err_f32": err32, "mismatches": bad,
            "inputs_compared": len(samples) + len(trained),
            "tolerance": {dt: cases.MODEL_TOL[name][dt]
                          for dt in ("bfloat16", "float32")},
            "ms": main["ms"], "device_ms": main["device_ms"],
            "host_ms": main["host_ms"], "tflops": main["tflops"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library_device_ms": main.get("library_device_ms"),
            "shapes": rows, "train_shapes": trained,
        })
        if name in NORMWISE_KERNELS:
            entries[-1]["normwise_tolerance"] = NORMWISE_TOL
        if name in CUDA_PASSES:
            entries[-1]["cuda_launches_per_call"] = \
                main["cuda_launches_per_call"]
            entries[-1]["width_paths"] = {
                p: w for p, w in width_paths.items() if p.startswith(name)}
        wide = width_rows(name, dev)
        entries[-1]["width_shapes"] = wide
        entries[-1]["mismatches"] += sum(r["mismatches"] for r in wide)
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


# -------------------------------------------------------------- training ----

def _leaf_grads(model, params, batch):
    """``(loss, metrics, {path: grad or None})`` of ``model.train_loss`` at
    ``params`` (a tree of tensors that do not require grad)."""
    import torch
    from repro_torch.models.layers import tree_paths, unflatten
    live = {k: v.detach().requires_grad_(True)
            for k, v in tree_paths(params).items()}
    loss, metrics = model.train_loss(unflatten(live), batch)
    grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    return loss.detach(), {k: float(v.detach()) for k, v in metrics.items()}, \
        dict(zip(live, grads))


def _normwise_rel(got, want) -> float:
    import torch
    den = float(torch.linalg.vector_norm(want.double()))
    num = float(torch.linalg.vector_norm(got.double() - want.double()))
    return num / den if den > 0 else float("inf")


def train_card_vs_cpu(arch: str, dev, calls: FirstCalls) -> tuple:
    """Part (a) of ``phase_train`` for one family: one pattern period at
    the published widths in f32, weights drawn on the host from a seed
    (stacked matrices at their own fan-in, as ``model_serve``'s) and
    carried to the card; the loss and every leaf's gradient on the card
    (B5-B7 through their autograd Functions, their inputs recorded by
    ``calls``) against the port on the CPU (the plain versions).  Returns
    ``(row, model, params on the card, grads on the card)``."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, init_params
    from repro_torch.models.layers import fan_in_rescale, tree_paths, \
        unflatten
    cfg = get_config(arch)
    period = MODEL_PERIOD.get(arch, 1)
    cfg = dataclasses.replace(cfg, n_layers=period, dtype="float32")
    model = build_model(cfg)
    cpu = fan_in_rescale(model.param_specs, init_params(
        model.param_specs, 0, torch.float32, "cpu"))
    card = unflatten({k: v.to(dev) for k, v in tree_paths(cpu).items()})
    B, T = TRAIN_GRAD_SHAPE
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, T))
    toks = torch.from_numpy(toks.astype(np.int32))
    t0 = time.time()
    want_loss, want_m, want = _leaf_grads(model, cpu, {"tokens": toks})
    cpu_s = time.time() - t0
    ops.reset_launch_counts()
    ops.reset_recompute_counts()
    calls.label = f"train (a) {arch} {period} layers B={B} T={T}"
    with calls:
        (got_loss, got_m, got), card_s = _sync_time(
            lambda: _leaf_grads(model, card, {"tokens": toks.to(dev)}))
    launches = {k: v for k, v in ops.launch_counts().items()
                if k in MODEL_KERNELS and v}
    recomputes = {k: v for k, v in ops.recompute_counts().items() if v}
    loss_rel = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
    bar = max(TRAIN_GRAD_TOL[k] for k in TRAIN_KERNELS[arch])
    leaves, bad = {}, []
    for path, w in want.items():
        g = got[path]
        if g is None or w is None:
            bad.append(f"{path}: no gradient")
            continue
        g = g.cpu()
        rel = _normwise_rel(g, w)
        finite = bool(torch.isfinite(g).all())
        nonzero = bool((g != 0).any())
        leaves[path] = rel
        if not (finite and nonzero and rel <= bar):
            bad.append(f"{path}: finite {finite} nonzero {nonzero} "
                       f"normwise {rel:.3g}")
    row = {"arch": arch, "reduced": {"n_layers": [get_config(arch).n_layers,
                                                  period]},
           "dtype": "float32", "remat": cfg.remat, "B": B, "T": T,
           "loss_card": float(got_loss), "loss_cpu": float(want_loss),
           "loss_rel_err": loss_rel, "loss_tolerance": TRAIN_LOSS_RTOL,
           "metrics_card": got_m, "metrics_cpu": want_m,
           "leaves": len(want), "grad_normwise_max": max(leaves.values(),
                                                         default=None),
           "grad_normwise_worst_leaf": max(leaves, key=leaves.get,
                                           default=None),
           "grad_tolerance": bar, "bad_leaves": bad,
           "launches": launches, "recomputes": recomputes,
           "card_s": card_s, "cpu_s": cpu_s}
    row["ok"] = (loss_rel <= TRAIN_LOSS_RTOL and not bad and all(
        launches.get(k, 0) > 0 and recomputes.get(k, 0) > 0
        for k in TRAIN_KERNELS[arch]))
    return row, model, card, got


def checkpoint_round_trip(params, grads) -> dict:
    """xLSTM's period through ``CheckpointManager``: its params and the
    optimizer state after one AdamW step on its card gradients, saved with
    ``async_=True`` and restored onto the card; every leaf bit-equal."""
    import torch
    from repro_torch.models.layers import tree_paths, unflatten
    from repro_torch.train.checkpoint import CheckpointManager, _flatten
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                             init_opt_state)
    opt = init_opt_state(params)
    adamw_update(OptimizerConfig(), params, unflatten(grads), opt)
    d = os.path.join(HERE, TRAIN_CKPT_DIR)
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.time()
    try:
        mgr = CheckpointManager(d, keep=1)
        mgr.save(1, params, opt, extra={"phase": "train"}, async_=True)
        returned_s = time.time() - t0
        mgr.wait()
        step, p2, o2, extra = mgr.restore(None, params, opt)
        want = _flatten({"params": params, "opt": opt})
        got = _flatten({"params": p2, "opt": o2})
        unequal = [k for k in want if not (
            got[k].device == want[k].device and got[k].dtype == want[k].dtype
            and torch.equal(got[k], want[k]))]
        nbytes = sum(os.path.getsize(os.path.join(d, f"step_{step}", f))
                     for f in os.listdir(os.path.join(d, f"step_{step}")))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {"leaves": len(want), "bytes": nbytes, "step": step,
            "extra": extra, "save_returned_s": returned_s,
            "round_trip_s": time.time() - t0, "unequal_leaves": unequal,
            "ok": step == 1 and not unequal and extra == {"phase": "train"}}


def profile_train_step(res: dict, dev) -> dict:
    """Where a full-width training step's device time goes: one more step
    of (b)'s run (its params and AdamW state, a fresh batch) under
    ``torch.profiler``, after a warm-up step of the profiler: device
    launches and busy ms, B5's forward kernels, the plain attention VJP's
    recompute (the ``recompute_vjp/...`` ranges), each as a share of the
    run's own ms a step (measured without the profiler)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.configs import get_config
    from repro_torch.launch.train import _make_batch
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import make_train_step
    F = TRAIN_FULL
    cfg = get_config(F["arch"])
    step = make_train_step(build_model(cfg), OptimizerConfig(
        warmup_steps=20, total_steps=F["steps"]), F["microbatches"])
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (F["batch"], F["seq"] + 1))
    batch = _make_batch(cfg, toks, F["seq"], dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        time.sleep(0.1)                          # the profiler's warm-up
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
        prof.step()
        step(res["params"], res["opt_state"], batch)
        torch.cuda.synchronize()
        prof.step()
    busy = b5 = 0.0
    launches = 0
    for k in prof.key_averages():
        if getattr(k, "is_user_annotation", False) \
                or k.device_type != DeviceType.CUDA:
            continue        # operators' rows repeat their kernels' time
        dev_us = getattr(k, "self_device_time_total", 0.0) or 0.0
        busy += dev_us
        launches += k.count
        if "flash_attention" in k.key:
            b5 += dev_us
    recompute = sum(ev.device_time_total for ev in prof.events()
                    if ev.name.startswith("recompute_vjp/")
                    and ev.device_type == DeviceType.CPU)
    ms = statistics.median(res["step_s"][1:]) * 1e3
    return {"device_launches": launches, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / ms,
            "b5_forward_ms": b5 / 1e3, "b5_forward_share": b5 / 1e3 / ms,
            "plain_vjp_ms": recompute / 1e3,
            "plain_vjp_share": recompute / 1e3 / ms,
            "of_ms_per_step": ms}


def train_launches(train: dict, name: str) -> dict:
    """One kernel's launches and backward recomputes in each part of
    ``phase_train``: per family in (a), per step in (b), in (c)."""
    return {
        "card_vs_cpu": {r["arch"]: [r["launches"].get(name, 0),
                                    r["recomputes"].get(name, 0)]
                        for r in train["card_vs_cpu"]},
        "full_width_per_step": [
            train["full_width"]["launches_per_step"].get(name, 0),
            train["full_width"]["recomputes_per_step"].get(name, 0)],
        "learning": [train["learning"]["launches"].get(name, 0),
                     train["learning"]["recomputes"].get(name, 0)]}


def train_kernel_rows(calls: FirstCalls, dev) -> list:
    """B5-B7 against their plain versions on the first input of each shape
    that ``phase_train``'s three parts handed them (``calls``), at the
    tolerance of the input's dtype (f32), with the kernel's, the plain
    version's and (B5) SDPA's times on it (per call, and queued: device
    and host) and its bound.  These launches are not the path's: the
    parts' counts were read before."""
    from repro_torch.kernels import cases
    fns = model_fns()
    rows = []
    for name in MODEL_KERNELS:
        kernel, plain = fns[name]
        for label, args, static in calls.samples.get(name, []):
            dtype = _dtype_name(args[0])
            bound, bound_by = _model_bound_ms(name, args, static)
            sdpa = (_sdpa_call(*args, static) if name == "flash_attention"
                    else None)
            rows.append({
                "kernel": name, "shape": label, "dtype": dtype,
                "inputs": [list(a.shape) for a in args],
                "static": dict(static),
                **_held_to_plain(name, args, static, dtype),
                "tolerance": cases.MODEL_TOL[name][dtype],
                "ms": _time_budget_ms(lambda: kernel(*args, **static), dev,
                                      TRAIN_TIME_BUDGET_S),
                "plain_ms": _time_budget_ms(lambda: plain(*args, **static),
                                            dev, TRAIN_TIME_BUDGET_S),
                "library_ms": (None if sdpa is None else _time_budget_ms(
                    sdpa, dev, TRAIN_TIME_BUDGET_S)),
                **_queued_row(lambda: kernel(*args, **static), sdpa),
                "bound_ms": bound, "bound_by": bound_by})
            if name == "flash_attention" and dtype == "float32":
                rows[-1]["bound_ms_ffma"] = _model_bound_ms(
                    name, args, static, FP32_OPS_PER_S)[0]
                rows[-1]["bound_share"] = bound / rows[-1]["device_ms"]
    return rows


def train_mode_bias(res: dict, dev) -> dict:
    """The peak of (b)'s step above its own start (its activations: the
    state exists before it), on (b)'s params and AdamW state and a fresh
    batch, once with no dispatch mode (as ``launch.train`` runs it) and
    once under a mode that only calls each operator.  The dry run counts
    the step under a mode (its counter), so the difference is what a
    mode's presence costs the allocator, measured in every run
    (``tools/dryrun_peak_gap.py`` tells it from the counting)."""
    import contextlib
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.configs import get_config
    from repro_torch.launch.train import _make_batch
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import make_train_step

    class Bare(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    F = TRAIN_FULL
    cfg = get_config(F["arch"])
    step = make_train_step(build_model(cfg), OptimizerConfig(
        warmup_steps=20, total_steps=F["steps"]), F["microbatches"])
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (F["batch"], F["seq"] + 1))
    batch = _make_batch(cfg, toks, F["seq"], dev)
    peaks = {}
    for name, mode in (("no_mode", contextlib.nullcontext()),
                       ("bare_mode", Bare())):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        with mode:
            step(res["params"], res["opt_state"], batch)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - start
    return peaks


def train_dryrun(full: dict, bias: dict) -> dict:
    """The dry run (``launch.dryrun``, on the meta device) of (b)'s step:
    its parameter, gradient, optimizer-state and input bytes, its peak of
    live activations and its predicted peak (state and activations), its
    bytes accessed and operations, and the collectives it would move per
    card under the pod and multi-pod meshes, beside the step's measured
    peak memory and time.  ``peak_ok``: the predicted peak within
    ``DRYRUN_PEAK_BAR`` of the measured one, the memory the earlier phases
    left on the card (``resident_before_bytes``) taken off it.  ``bias``
    (:func:`train_mode_bias`): the step's activations on the card with no
    mode and under a bare one, beside the predicted activations."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    F = TRAIN_FULL
    shape = ShapeConfig("train_full_width", F["seq"], F["batch"], "train")
    t0 = time.time()
    cell = dryrun.build_cell(
        F["arch"], "train_full_width", shape=shape,
        param_dtype=torch.float32, microbatches=F["microbatches"])
    seconds = time.time() - t0
    b = cell["bytes"]
    state = b["params"] + b["grads"] + b["opt_state"] + b["inputs"]
    measured = full["peak_memory_bytes"]
    step_peak = measured - full["resident_before_bytes"]
    ratio = b["peak"] / step_peak
    step_s = full["ms_per_step"] * 1e-3
    return {"flops": cell["flops"], "bytes": b,
            "predicted_state_bytes": state,
            "activations_peak": b["activations_peak"],
            "predicted_peak_bytes": b["peak"],
            "measured_peak_bytes": measured,
            "resident_before_bytes": full["resident_before_bytes"],
            "measured_step_peak_bytes": step_peak,
            "predicted_over_measured_peak": ratio,
            "peak_bar": DRYRUN_PEAK_BAR,
            "peak_ok": abs(ratio - 1) <= DRYRUN_PEAK_BAR,
            "peak_over_predicted_state": measured / state,
            "step_activations_no_mode_bytes": bias["no_mode"],
            "step_activations_bare_mode_bytes": bias["bare_mode"],
            "mode_bias_bytes": bias["bare_mode"] - bias["no_mode"],
            "predicted_over_bare_mode_activations":
                b["activations_peak"] / bias["bare_mode"],
            "predicted_over_no_mode_activations":
                b["activations_peak"] / bias["no_mode"],
            "bytes_accessed": cell["bytes_accessed"],
            "bytes_accessed_tb_per_s": cell["bytes_accessed"] / step_s
            / 1e12,
            "collectives_per_card": {
                m: {"collective_bytes": r["collective_bytes"],
                    "collective_total": r["collective_total"],
                    "activations": r["activations"], "peak": r["peak"]}
                for m, r in cell["per_card"].items()},
            "counted": cell["counted"],
            "achieved_tflops_per_s": cell["flops"] / step_s / 1e12,
            "estimate_flops_in_products": TRAIN_PRODUCT_FLOPS,
            "seconds": seconds}


def phase_train(dev, calls: FirstCalls) -> dict:
    """Training on the card (``model.train_loss`` -> autograd through
    B5-B7's Functions -> AdamW).  (a) card against CPU, four families at
    one period of their published widths; the checkpoint round trip of
    xLSTM's; (b) ``launch.train.run`` at qwen2_1_5b's full width and
    depth with the PBM host cache; (c) the smoke configuration learns.
    Launch and recompute counts are set to 0 just before each run and read
    just after.  ``calls`` records the first B5-B7 input of each shape on
    the card in each part; each is then held against its plain version
    (``train_kernel_rows``), and the ``kernels`` line reports them."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_launch
    t_phase = time.time()
    out = {"phase": "train", "gpu": nvidia_smi_line(), "card_vs_cpu": []}
    ok = True
    for arch in TRAIN_ARCHS:
        row, model, card, grads = train_card_vs_cpu(arch, dev, calls)
        ok &= row["ok"]
        out["card_vs_cpu"].append(row)
        if arch == "xlstm_350m":
            out["checkpoint"] = checkpoint_round_trip(card, grads)
            ok &= out["checkpoint"]["ok"]
        del model, card, grads
        torch.cuda.empty_cache()

    F = TRAIN_FULL
    resident = torch.cuda.memory_allocated()    # earlier phases' captures
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ops.reset_recompute_counts()
    calls.label = (f"train (b) {F['arch']} {get_config(F['arch']).n_layers} "
                   f"layers B={F['batch'] // F['microbatches']} T={F['seq']}")
    t0 = time.time()
    with calls:
        res = train_launch.run(arch=F["arch"], steps=F["steps"],
                               batch=F["batch"], seq=F["seq"],
                               microbatches=F["microbatches"], device=dev,
                               log=None)
    wall = time.time() - t0
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    recomputes = {k: v for k, v in ops.recompute_counts().items() if v}
    timed = res["step_s"][1:]
    ms = statistics.median(timed) * 1e3
    tokens = F["batch"] * F["seq"]
    finite = all(math.isfinite(x) for x in res["losses"] + res["grad_norms"])
    n, depth = F["steps"], get_config(F["arch"]).n_layers
    full = {"arch": F["arch"], "layers": depth, "dtype": "float32",
            "tf32": torch.backends.cuda.matmul.allow_tf32,
            "seq": F["seq"], "global_batch": F["batch"],
            "microbatches": F["microbatches"], "steps": n,
            "timed_steps": len(timed), "ms_per_step": ms,
            "ms_per_step_each": [s * 1e3 for s in res["step_s"]],
            "tokens_per_s": tokens / (ms * 1e-3),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "resident_before_bytes": resident,
            "losses": res["losses"], "grad_norms": res["grad_norms"],
            "finite": finite, "launches": launches,
            "launches_per_step": {k: v / n for k, v in launches.items()},
            "recomputes_per_step": {k: v / n for k, v in recomputes.items()},
            "flash_attention_expected_per_step": depth * F["microbatches"],
            "cache": res["cache"], "wall_s": wall, "gpu": nvidia_smi_line()}
    full["ok"] = (finite and len(timed) >= 5
                  and launches.get("flash_attention", 0)
                  == n * full["flash_attention_expected_per_step"]
                  and recomputes.get("flash_attention", 0)
                  == launches["flash_attention"])
    ok &= full["ok"]
    full["profile"] = profile_train_step(res, dev)
    out["full_width"] = full
    out["dryrun"] = train_dryrun(full, train_mode_bias(res, dev))
    ok &= out["dryrun"]["peak_ok"]
    del res
    torch.cuda.empty_cache()

    L = TRAIN_LEARN
    ops.reset_launch_counts()
    ops.reset_recompute_counts()
    calls.label = f"train (c) {L['arch']} smoke B={L['batch']} T={L['seq']}"
    with calls:
        learn = train_launch.run(arch=L["arch"], smoke=True,
                                 steps=L["steps"], batch=L["batch"],
                                 seq=L["seq"], lr=L["lr"], device=dev,
                                 log=None)
    losses = learn["losses"]
    last5 = statistics.mean(losses[-5:])
    out["learning"] = {
        **L, "first_loss": losses[0], "last5_mean": last5,
        "losses": losses,
        "launches": {k: v for k, v in ops.launch_counts().items() if v},
        "recomputes": {k: v for k, v in ops.recompute_counts().items() if v},
        "ok": last5 < losses[0]}
    ok &= out["learning"]["ok"]
    out["kernel_inputs"] = train_kernel_rows(calls, dev)
    held = {r["kernel"] for r in out["kernel_inputs"]}
    ok &= (held >= {k for ks in TRAIN_KERNELS.values() for k in ks}
           and all(r["mismatches"] == 0 for r in out["kernel_inputs"]))
    calls.samples.clear()
    out["seconds"] = time.time() - t_phase
    out["budget_s"] = TRAIN_BUDGET_S
    out["ok"] = bool(ok)
    emit(out)
    if not out["ok"]:
        fail("train", "card vs CPU outside the bars, a leaf without a "
                      "gradient, a checkpoint not bit-equal, a non-finite "
                      "full-width step, a loss that did not fall or a "
                      "kernel that disagrees with its plain version on a "
                      "training input")
    return out


# ------------------------------------------------------ contract gates ----

def phase_contracts(dev) -> dict:
    """``repro_torch.analysis``'s static checks on the tree, then every
    kernel contract on the card (``analysis.absint.contracts_on_card``):
    guard zones, poisoned buffers and repeats on every case, each held to
    its plain version; each kernel's shared memory against the card's
    opt-in limit; ``compute-sanitizer`` where it runs on this device, its
    refusal recorded where it does not."""
    from repro_torch.analysis import run_checks
    from repro_torch.analysis.absint import contracts_on_card
    t0 = time.time()
    static = run_checks()
    report, findings = contracts_on_card()
    rows = report["device_checks"]
    out = {"phase": "contracts", "static_findings": [f.format()
                                                     for f in static],
           "cases": len(rows),
           "cases_by_kernel": {k: sum(r["kernel"] == k for r in rows)
                               for k in REPLACES},
           **report, "findings": [f.format() for f in findings],
           "seconds": time.time() - t0, "budget_s": CONTRACTS_BUDGET_S}
    out["ok"] = (not static and not findings
                 and all(out["cases_by_kernel"].values()))
    emit(out)
    if not out["ok"]:
        fail("contracts", "a static finding, or a kernel contract that "
                          "failed on the card")
    return out


def phase_sanitize(dev) -> dict:
    """``make_runner(sanitize=True)`` over the JAX package's sanitize
    points (``analysis.sanitize``): no NaN, no index out of its extent, one
    config signature per runner, no truncated lane; per (point, stepper)
    the steps, lanes, signatures and the B1 keys that were -0.0."""
    from repro_torch.analysis.sanitize import sanitize_smoke
    t0 = time.time()
    rows = []
    failures = sanitize_smoke(log=None, device=dev, rows=rows)
    out = {"phase": "sanitize", "rows": rows, "failures": failures,
           "neg_zero_keys": sum(lane["neg_zero_keys"] for r in rows
                                for lane in r["lanes"]),
           "seconds": time.time() - t0, "budget_s": SANITIZE_BUDGET_S}
    out["ok"] = (not failures and len(rows) == 4
                 and all(r["signatures"] == 1 for r in rows))
    emit(out)
    if not out["ok"]:
        fail("sanitize", "a sanitizer hit, a second config signature or a "
                         "truncated lane")
    return out


def phase_examples(dev) -> dict:
    """The four examples of ``examples/torch_*.py``, each a child process
    on the card at its smallest flags, all at once: exit code, seconds and
    what each must print."""
    import tempfile
    t0 = time.time()
    ckpt = tempfile.mkdtemp(prefix="smoke_example_ckpt_")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    procs = {}
    for name, (args, _) in EXAMPLES.items():
        extra = ["--checkpoint-dir", ckpt] if name == "torch_train_lm.py" \
            else []
        procs[name] = (time.time(), subprocess.Popen(
            [sys.executable, os.path.join(HERE, "examples", name), *args,
             *extra], env=env, cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    rows = []
    try:
        for name, (start, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=2 * EXAMPLES_BUDGET_S)
            missing = [t for t in EXAMPLES[name][1] if t not in stdout]
            rows.append({"example": name, "args": EXAMPLES[name][0],
                         "rc": proc.returncode,
                         "seconds": time.time() - start,
                         "missing": missing,
                         "tail": stdout.strip().splitlines()[-3:],
                         "stderr_tail": stderr.strip().splitlines()[-3:]})
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(ckpt, ignore_errors=True)
    out = {"phase": "examples", "rows": rows, "device": str(dev),
           "seconds": time.time() - t0, "budget_s": EXAMPLES_BUDGET_S}
    out["ok"] = all(r["rc"] == 0 and not r["missing"] for r in rows)
    emit(out)
    if not out["ok"]:
        fail("examples", "an example failed on the card or did not print "
                         "what it must")
    return out


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


def phase_sim_fixed(dev, events: "EventRuns") -> dict:
    """The fixed-dt stepper on the card at the calibrated scale, every
    validated point (``FIXED_MUST``) held to the event engine within the
    same bars.  A lane's run costs its stream time over dt fine steps, each
    a replay of the captured fine step; no lane is left out."""
    from repro_torch.core.array_sim import validate
    scale = CALIBRATED_SCALE
    spec, ws = micro_workload(scale, n_streams=8, queries=16)
    ev = events.results()
    dt = float(spec.page_size.max()) / 700e6
    lanes = list(FIXED_MUST)
    _, cfgs = sweep_configs(spec, ws, None, dev, lanes=lanes)
    kw = dict(time_slice=0.1 * scale, bandwidth_ref=700e6, stepper="fixed")
    reach = max(ev[k][0].sim_time for k in lanes)
    # the livelock guard at twice the longest event run: a lane that needs
    # more is not comparable and fails the phase as truncated
    max_slices = int(2.0 * reach / (0.1 * scale)) + 8
    results, wall, launches, steps, stats = run_sweep_counted(
        spec, cfgs, dev, max_slices=max_slices, **kw)
    held = held_to_events(lanes, results, ev, "fixed")
    out = {"phase": "sim_fixed", "scale": scale, "P": spec.n_pages,
           "L": len(lanes), "rows": held, "left_out": [],
           "wall_s": wall, "fine_steps": steps, **stats,
           "ms_per_fine_step": wall / max(1, steps) * 1e3,
           "longest_event_sim_s": reach,
           "launches": launches, "max_slices": max_slices, "dt": dt,
           "within_error_bars": all(r["ok"] for r in held),
           "bars": {f"{r['policy']}@{r['buffer_frac']}": validate.bar_of(r)
                    for r in held}}
    out["ok"] = (out["within_error_bars"] and len(held) == len(lanes)
                 and launches["batched_evict"] > 0)
    emit(out)
    if not out["ok"]:
        fail("sim_fixed", "a lane of the fixed stepper is outside its bar "
                          "of the event engine, truncated, or missing")
    return launches


def nest_steps(run, cfgs, lc, live, carry, n: int, taken: int = 0):
    """``n`` batched steps of a runner's own loop nest, from ``carry``,
    without its reads of the outer condition: under the horizon stepper a
    cheap step while the slice lasts for any lane, else the refresh step;
    under the fixed stepper ``n_inner - 1`` cheap steps and the refresh
    (``taken``: the steps taken before, which place the slice's end).
    ``live`` is an all-True ``(L,)`` mask the caller makes once."""
    n_inner = run.cheap.n_inner
    for k in range(taken + 1, taken + n + 1):
        if run.stepper == "fixed":
            step = run.full if k % n_inner == 0 else run.cheap
            carry = step(carry, cfgs, None, lc)
            continue
        inner = live & run.inner_cond(carry)
        if int(inner.sum()) == 0:
            carry = run.full(carry, cfgs, live, lc)
        else:
            carry = run.cheap(carry, cfgs, inner, lc)
    return carry


def eager_loop(run, spec, cfgs):
    """A runner's loop nest driven eagerly from its own steps (``run.cheap``
    / ``run.full``, its conditions ``run.cond`` / ``run.inner_cond``):
    the reference the runner's captured graphs are held to.  Returns
    ``(output, stats)`` as the runner returns them; a sanitized runner's
    checks run after every step and their flag rides in every read, as
    the runner's own eager loop does them."""
    from repro_torch.core.array_sim import sim
    L = cfgs.policy.shape[0]
    lc, carry = run.cheap.lane_consts(cfgs), run.init_carry(cfgs)
    san = (sim._Sanitizer(spec, L, cfgs.policy.device) if run.sanitize
           else None)
    stats = {"cheap_steps": 0, "refresh_steps": 0, "host_reads": 0}

    def read(count):
        if san is not None:
            count = san.fold(count)
        v = int(count)
        stats["host_reads"] += 1
        if v >> 32:
            san.raise_hit()
        return v

    def step(fn, carry, mask):
        carry = fn(carry, cfgs, mask, lc)
        if san is not None:
            san.check(carry, fn.probe, mask)
        return carry

    while True:
        live = run.cond(carry, cfgs)
        n_live = read(live.sum())
        if n_live == 0:
            break
        mask = None if n_live == L else live
        if run.stepper == "fixed":
            for _ in range(run.cheap.n_inner - 1):
                carry = step(run.cheap, carry, mask)
            carry = step(run.full, carry, mask)
            stats["cheap_steps"] += run.cheap.n_inner - 1
            stats["refresh_steps"] += 1
            continue
        while True:
            inner = live & run.inner_cond(carry)
            n_in = read(inner.sum())
            if n_in == 0:
                break
            carry = step(run.cheap, carry, None if n_in == L else inner)
            stats["cheap_steps"] += 1
        carry = step(run.full, carry, mask)
        stats["refresh_steps"] += 1
    if san is not None:
        stats["neg_zero_keys"] = san.neg_zero.tolist()
    return ((carry[0], carry[-1]) if run.telemetry else carry[0]), stats


def graph_vs_eager(label: str, run, spec, cfgs, shard=None) -> dict:
    """``run(cfgs)`` (replays of its captured graphs) against
    :func:`eager_loop` on the same lanes: every state leaf, the loop's
    stats and the buffer-pool kernels' launch counts, with the wall time
    of each.  ``shard`` (a mesh runner's lane-shard runner) is the runner
    whose steps the eager loop drives."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t0 = time.time()
    got = run(cfgs)
    torch.cuda.synchronize()
    graph_s = time.time() - t0
    graph_launches = {k: v for k, v in ops.launch_counts().items()
                      if k in SIM_KERNELS}
    graph_stats = dict(run.stats)
    ops.reset_launch_counts()
    t0 = time.time()
    want, stats = eager_loop(shard or run, spec, cfgs)
    torch.cuda.synchronize()
    eager_s = time.time() - t0
    eager_launches = {k: v for k, v in ops.launch_counts().items()
                      if k in SIM_KERNELS}
    steps = stats["cheap_steps"] + stats["refresh_steps"]
    own = shard or run
    keys = sorted(str(k) for rep in own._replays.values()
                  for k in rep.graphs)
    if shard is not None:       # the mesh runner keeps the step counts
        stats = {k: stats[k] for k in graph_stats}
    row = {"point": label, "stepper": own.stepper,
           "telemetry": own.telemetry, "sanitize": own.sanitize,
           "L": int(cfgs.policy.shape[0]), "macro_steps": steps,
           "graphs": keys, "unequal_leaves": unequal_leaves(want, got),
           "stats": graph_stats, "stats_equal": graph_stats == stats,
           "launches": graph_launches,
           "launches_equal": graph_launches == eager_launches,
           "graph_s": graph_s, "eager_s": eager_s,
           "graph_ms_per_step": graph_s / max(1, steps) * 1e3,
           "eager_ms_per_step": eager_s / max(1, steps) * 1e3}
    row["ok"] = (not row["unequal_leaves"] and row["stats_equal"]
                 and row["launches_equal"] and steps > 0)
    return row


def phase_sim_graphs(dev) -> dict:
    """The simulator's runner replays captured CUDA graphs (the
    counterpart of the JAX runner's ``jax.jit``); held here to its own
    eager steps driven by :func:`eager_loop`, every state leaf bit-equal,
    with the same loop stats (host reads, -0.0 keys) and launch counts:
    (a) ``sim_small``'s point, both steppers, plain, telemetry on and
    sanitize on; (b) the telemetry tests' tiny point, the same; (c) the calibrated 24-lane sweep cut at
    ``GRAPH_CHECK_SLICES`` slices, horizon stepper; (d) the ('lanes',
    'page') mesh runner of shape (1, 4) at (a)'s point, both steppers;
    (e) in a fresh child process (``--count-graph-kernels``), the CUDA
    kernels one replay of each captured graph launches against those of
    the same body run eagerly, by the profiler, for every runner whose
    launch counts a gate reads (:func:`count_graph_kernels`)."""
    from repro_torch.core.array_sim import (
        Mesh, compile_workload, make_config, make_runner, stack_configs)
    from repro_torch.core.workload import make_lineitem_db, micro_streams
    t_phase = time.time()
    rows = []
    scale = 0.03
    spec, ws = micro_workload(scale, 3, 3)
    _, cfgs = sweep_configs(spec, ws, (0.2, 0.4, 0.8), dev)
    for stepper in ("fixed", "horizon"):
        for extra in ({}, {"telemetry": True}, {"sanitize": True}):
            run = make_runner(spec, time_slice=0.1 * scale, stepper=stepper,
                              policies=POLICIES, device=dev, **extra)
            rows.append(graph_vs_eager("sim_small", run, spec, cfgs))
    db = make_lineitem_db(scale_tuples=2_000_000)
    spec_t = compile_workload(db, micro_streams(
        db, n_streams=2, queries_per_stream=1, seed=3))
    cfgs_t = stack_configs([make_config(spec_t, 16 << 20, 700e6, p,
                                        device=dev) for p in POLICIES])
    for stepper in ("fixed", "horizon"):
        for extra in ({}, {"telemetry": True}, {"sanitize": True}):
            run = make_runner(spec_t, time_slice=0.01, stepper=stepper,
                              policies=POLICIES, device=dev, **extra)
            rows.append(graph_vs_eager("telemetry_tiny", run, spec_t, cfgs_t))
    spec_c, ws_c = micro_workload(CALIBRATED_SCALE, n_streams=8, queries=16)
    _, cfgs_c = sweep_configs(spec_c, ws_c, FRACS, dev)
    run = make_runner(spec_c, time_slice=0.1 * CALIBRATED_SCALE,
                      bandwidth_ref=700e6, stepper="horizon",
                      policies=POLICIES, max_slices=GRAPH_CHECK_SLICES,
                      device=dev)
    rows.append(graph_vs_eager("calibrated_cut", run, spec_c, cfgs_c))
    mesh = Mesh([[dev] * 4], ("lanes", "page"))
    for stepper in ("fixed", "horizon"):
        run = make_runner(spec, time_slice=0.1 * scale, stepper=stepper,
                          policies=POLICIES, mesh=mesh)
        rows.append(graph_vs_eager("mesh_1x4", run, spec, cfgs,
                                   shard=run.runners[dev]))
    counts = json_child("--count-graph-kernels", "sim_graphs", 600)
    out = {"phase": "sim_graphs", "rows": rows, "kernel_counts": counts,
           "seconds": time.time() - t_phase}
    out["ok"] = all(r["ok"] for r in rows) and counts["ok"]
    emit(out)
    if not out["ok"]:
        fail("sim_graphs", "a captured run differs from the eager steps, "
                           "or a graph launches other kernels than its "
                           "body run eagerly")
    return out


def count_graph_kernels(dev) -> dict:
    """The ``--count-graph-kernels`` child of ``sim_graphs``: for each runner
    whose launch counts a gate reads — ``sim_small``'s point under both
    steppers, ``sim_calibrated``'s 24-lane horizon runner run to its end,
    and ``tpch_big``'s (P = 35,328, the page-split kernels) cut where that
    phase cuts it — one run captures the runner's graphs (the same runner
    over one NCCL rank: ``mesh_ranks`` (a)); then for each
    graph the CUDA kernels one replay launches and those of the same body
    run eagerly on copies of the buffers (``torch.profiler``), and the
    buffer-pool kernels the runner counts a replay."""
    from repro_torch.core.array_sim import make_runner
    out = {"graphs": [], "ok": True}

    def profile(point, spec, cfgs, **kw):
        run = make_runner(spec, policies=POLICIES, device=dev, **kw)
        run(cfgs)
        for row in _graph_rows(run):
            row.update(point=point, P=spec.n_pages, stepper=kw["stepper"])
            out["ok"] &= row["ok"]
            out["graphs"].append(row)

    scale = 0.03
    spec, ws = micro_workload(scale, 3, 3)
    _, cfgs = sweep_configs(spec, ws, (0.2, 0.4, 0.8), dev)
    for stepper in ("fixed", "horizon"):
        profile("sim_small", spec, cfgs, time_slice=0.1 * scale,
                stepper=stepper)
    spec, ws = micro_workload(CALIBRATED_SCALE, n_streams=8, queries=16)
    _, cfgs = sweep_configs(spec, ws, FRACS, dev)
    profile("sim_calibrated", spec, cfgs,
            time_slice=0.1 * CALIBRATED_SCALE, bandwidth_ref=700e6,
            stepper="horizon")
    spec, cfgs, kw = tpch_big_point(dev, TPCH_BIG["max_slices"])
    kw.pop("policies")
    profile("tpch_big", spec, cfgs, **kw)
    return out


#: the CUDA kernel that ends each call of a buffer-pool wrapper: its
#: single-stage kernel, or the page split's finish (once a call either way)
CALL_KERNELS = {
    "batched_evict": ("batched_evict_kernel", "split_evict_finish"),
    "fifo_grant": ("fifo_grant_kernel", "split_grant_finish"),
    "wake_solve": ("wake_solve_kernel", "split_wake_finish")}


def _graph_rows(run) -> list:
    """For each graph a runner captured: the CUDA kernels of one replay
    against those of its body run eagerly on copies of the buffers, and
    each buffer-pool wrapper's calls a replay (``CALL_KERNELS``) against
    the launches the runner counts for it."""
    import torch
    from repro_torch.core.array_sim import sim
    rows = []
    for rep in run._replays.values():
        for key, (_, counted) in sorted(rep.graphs.items()):
            b = dict(rep.bufs)
            b["carry"] = sim._tree_map(torch.clone, b["carry"])
            for name in ("live", "inner", "n_live", "n_in"):
                b[name] = b[name].clone()
            replay = _replay_kernels(rep, key)
            body = _graph_names(cuda_kernels_per_call(
                lambda rep=rep, key=key, b=b: rep._body(*key, b), reps=5))
            hand = {name: sum(n for k, n in replay.items()
                              if any(c in k for c in CALL_KERNELS[name]))
                    for name in counted}
            row = {"graph": list(key),
                   "replay_kernels": sum(replay.values()),
                   "eager_kernels": sum(body.values()),
                   "counted_launches": counted,
                   "hand_kernels_a_replay": hand,
                   "split_kernels_a_replay": sum(
                       n for k, n in replay.items() if "split_" in k),
                   "copies_a_replay": _copies(replay),
                   "unequal": {k: [replay.get(k, 0.0), body.get(k, 0.0)]
                               for k in set(replay) | set(body)
                               if replay.get(k, 0.0) != body.get(k, 0.0)}}
            row["ok"] = (not row["unequal"] and row["replay_kernels"] > 0
                         and all(hand[k] == n for k, n in counted.items()))
            rows.append(row)
    return rows


#: a device-to-device copy or a memset that the eager stream runs as a copy
#: engine's, a replay runs as a kernel node of the graph under these names
GRAPH_KERNEL_ALIASES = {"memcpy32_post": "Memcpy DtoD (Device -> Device)",
                        "memcpy128": "Memcpy DtoD (Device -> Device)",
                        "memset32": "Memset (Device)",
                        "Memset (Unknown)": "Memset (Device)"}


def _replay_kernels(rep, key) -> dict:
    """The CUDA kernels one replay of graph ``key`` of ``rep`` launches."""
    return _graph_names(cuda_kernels_per_call(lambda: rep.replay(key),
                                              reps=5))


def _copies(kernels: dict) -> dict:
    """NCCL's kernels, copies and memsets among ``kernels``."""
    return {k: n for k, n in kernels.items()
            if "nccl" in k.lower() or k.startswith(("Memcpy", "Memset"))}


def collective_in_graphs(rank_rows: list, plain) -> dict:
    """What each captured graph of a page-row rank's runner runs beyond the
    same graph of the one-process runner ``plain`` at the same point (by
    the profiler, ``copies_a_replay``: NCCL's kernels, copies and
    memsets; of ``plain`` its replays alone are profiled): the step's
    all-gathers.  NCCL runs a one-rank all-gather as a
    device-to-device copy and launches no kernel of its own; ``ok`` asks
    that every graph holds at least the two all-gathers (B1's and B2's) as
    NCCL kernels or copies, and nothing else more."""
    plain = {tuple(key): _copies(_replay_kernels(rep, key))
             for rep in plain._replays.values() for key in rep.graphs}
    out, ok = {}, bool(rank_rows)
    for r in rank_rows:
        base = plain.get(tuple(r["graph"]), {})
        mine = r["copies_a_replay"]
        extra = {k: mine.get(k, 0.0) - base.get(k, 0.0)
                 for k in set(mine) | set(base)
                 if mine.get(k, 0.0) != base.get(k, 0.0)}
        out[str(r["graph"])] = extra
        ok &= (sum(extra.values()) >= 2 and all(
            n > 0 and ("nccl" in k.lower() or k.startswith("Memcpy DtoD"))
            for k, n in extra.items()))
    return {"extra_a_replay": out, "ok": ok}


def _graph_names(kernels: dict) -> dict:
    """``cuda_kernels_per_call``'s counts with a replay's names for a
    device-to-device copy read as the eager stream's."""
    out = {}
    for k, n in kernels.items():
        k = GRAPH_KERNEL_ALIASES.get(k, k)
        out[k] = out.get(k, 0.0) + n
    return out


def json_child(flag: str, phase: str, timeout: float) -> dict:
    """This script run with ``flag`` in a fresh process (the profiler
    records fewer kernels than ran late in a long process,
    ``tools/profiler_window_drift.py``): the JSON object of its last
    line; ``phase`` fails if it does not end well."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                          capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(phase, f"{flag} exited {proc.returncode}: "
                    f"{proc.stdout[-1000:]} {proc.stderr[-2500:]}")
    return json.loads(lines[-1])


def profile_nest(runs: dict, cfgs, warm: int, n: int, n_prof: int) -> dict:
    """Host ms and device launches a macro-step of each runner's nest
    (``runs``: tag -> runner over the same lanes): ``warm`` steps from the
    start (the profiler loses the first kernels of a long process without
    a warm-up), then windows of ``n`` steps on the host clock in turns (a,
    b, b, a: each runner's k-th window covers the same steps of the run),
    then one window of ``n_prof`` steps each under ``torch.profiler``
    (device activity only counted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    lcs = {t: run.cheap.lane_consts(cfgs) for t, run in runs.items()}
    live = torch.ones(cfgs.policy.shape[0], dtype=torch.bool,
                      device=cfgs.policy.device)
    carries = {t: nest_steps(run, cfgs, lcs[t], live, run.init_carry(cfgs),
                             warm)
               for t, run in runs.items()}
    taken = dict.fromkeys(runs, warm)
    ms = {t: [] for t in runs}
    for t in list(runs) + list(runs)[::-1]:
        torch.cuda.synchronize()
        t0 = time.time()
        carries[t] = nest_steps(runs[t], cfgs, lcs[t], live, carries[t], n,
                                taken[t])
        torch.cuda.synchronize()
        ms[t].append((time.time() - t0) / n * 1e3)
        taken[t] += n
    out = {}
    for t, run in runs.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            nest_steps(run, cfgs, lcs[t], live, carries[t], n_prof, taken[t])
            torch.cuda.synchronize()
        launches, busy_us = 0, 0.0
        for k in prof.key_averages():
            if k.device_type == DeviceType.CUDA:
                launches += k.count
                busy_us += getattr(k, "self_device_time_total", 0.0) or 0.0
        out[t] = {"steps_before": warm, "window_steps": n,
                  "ms_per_step_windows": ms[t],
                  "ms_per_step": statistics.mean(ms[t]),
                  "profiled_steps": n_prof,
                  "device_launches_per_step": launches / n_prof,
                  "device_busy_ms_per_step": busy_us / n_prof / 1e3}
    return out


def _leaves(tree, prefix=""):
    import torch
    if torch.is_tensor(tree):
        yield prefix, tree
    elif hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{prefix}.{f}")
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")


def telemetry_identities(state, tele) -> dict:
    """Per lane: the counters against the state's own counts."""
    steps = state.steps.cpu()
    return {
        "loads_equal": bool((tele.loads.cpu() == state.loads.cpu()).all()),
        "jump_hist_sums_to_steps": bool(
            (tele.jump_hist.sum(dim=1).cpu() == steps).all()),
        "hits_plus_misses_positive": bool(
            ((tele.hits + tele.misses).cpu() > 0).all()),
    }


def unequal_leaves(a, b) -> list:
    """Names of the leaves of two states that are not bit-equal."""
    import torch
    return [name for (name, x), (_, y) in zip(_leaves(a), _leaves(b))
            if x.dtype != y.dtype or not torch.equal(x, y)]


def telemetry_point():
    """The trace CLI's default point on the host: (db, streams, cap)."""
    from repro_torch.core.workload import (
        make_lineitem_db, micro_accessed_bytes, micro_streams)
    db = make_lineitem_db(scale_tuples=int(6_001_215 * 0.1))
    streams = micro_streams(db, n_streams=4, queries_per_stream=4, seed=3)
    return db, streams, max(1 << 22, int(0.4 * micro_accessed_bytes(db)))


def telemetry_event_run():
    """The port's event engine at the trace CLI's default point, pbm@0.4:
    ``(total_evictions, wall seconds)`` (runs in a worker process)."""
    from repro_torch.core import EngineConfig, run_workload
    db, streams, cap = telemetry_point()
    t0 = time.time()
    ev = run_workload(db, streams, "pbm", EngineConfig(
        bandwidth=700e6, buffer_bytes=cap, sample_interval=2.0,
        pbm_time_slice=0.1))
    return ev.total_evictions, time.time() - t0


def phase_sim_telemetry(dev) -> dict:
    """The simulator's telemetry tier on the card (``repro_torch.obs``).

    (a) The tiny point of the telemetry tests (2 M tuples, 2 streams x 1
        query, seed 3, 16 MiB): the four policies, both steppers, runners
        with the counters off and on: every state leaf bit-equal, and per
        lane ``loads`` equal to the state's, ``sum(jump_hist)`` equal to
        its macro-steps, ``hits + misses > 0``.
    (b) sim_calibrated's 24 lanes at scale 0.25, horizon stepper, cut at
        ``TELEMETRY_SLICES`` slices with the counters off and on: the same
        checks, the buffer-pool kernels' launches of the run with the
        counters on (counts set to 0 just before), the lanes' summaries,
        and per runner the launches and host ms a macro-step
        (``profile_nest``).
    (c) The flight recorder at the trace CLI's default point (scale 0.1 of
        SF1 lineitem, 4 x 4 streams, seed 3, 700 MB/s, time slice 0.1),
        pbm@0.4: its eviction total equal to the telemetry runner's
        counter with the same final clock, within ``ERROR_BARS[(0.4,
        "pbm")]`` of the port's event engine (run on the host in a worker
        meanwhile), the Chrome export's evictions summing to the same and
        every duration positive; and the run's manifest."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from repro_torch.core.array_sim import (
        compile_workload, make_config, make_runner, result_from_state,
        stack_configs)
    from repro_torch.core.array_sim.validate import ERROR_BARS
    from repro_torch.core.workload import make_lineitem_db, micro_streams
    from repro_torch.kernels import ops
    from repro_torch.obs import collect_manifest, lane_slice, summarize
    from repro_torch.obs.trace import TraceSession, _build_point

    t_phase = time.time()
    pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        event_future = pool.submit(telemetry_event_run)
        out = {"phase": "sim_telemetry", "budget_s": TELEMETRY_BUDGET_S}
        seconds = out["seconds_by_part"] = {}

        # (a) off vs on at the tiny point
        db = make_lineitem_db(scale_tuples=2_000_000)
        spec = compile_workload(db, micro_streams(
            db, n_streams=2, queries_per_stream=1, seed=3))
        cfgs = stack_configs([make_config(spec, 16 << 20, 700e6, p,
                                          device=dev) for p in POLICIES])
        part_a = {"P": spec.n_pages, "policies": list(POLICIES)}
        for stepper in ("fixed", "horizon"):
            kw = dict(time_slice=0.01, stepper=stepper, policies=POLICIES,
                      device=dev)
            off = make_runner(spec, **kw)(cfgs)
            on, tele = make_runner(spec, telemetry=True, **kw)(cfgs)
            part_a[stepper] = {"steps": on.steps.tolist(),
                               "unequal_leaves": unequal_leaves(off, on),
                               **telemetry_identities(on, tele)}
        out["a"] = part_a
        seconds["a"] = time.time() - t_phase

        # (b) the calibrated sweep, cut, off vs on
        spec, ws = micro_workload(CALIBRATED_SCALE, n_streams=8, queries=16)
        lanes, cfgs = sweep_configs(spec, ws, FRACS, dev)
        kw = dict(time_slice=0.1 * CALIBRATED_SCALE, bandwidth_ref=700e6,
                  stepper="horizon", policies=POLICIES,
                  max_slices=TELEMETRY_SLICES, device=dev)
        part_b = {"scale": CALIBRATED_SCALE, "P": spec.n_pages,
                  "L": len(lanes), "max_slices": TELEMETRY_SLICES}
        runs = {}
        for tag, telemetry in (("off", False), ("on", True)):
            run = make_runner(spec, telemetry=telemetry, **kw)
            ops.reset_launch_counts()
            t0 = time.time()
            res = run(cfgs)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {k: v for k, v in ops.launch_counts().items()
                        if k in SIM_KERNELS}
            steps = run.stats["cheap_steps"] + run.stats["refresh_steps"]
            runs[tag] = (run, res)
            part_b[tag] = {"wall_s": wall, "batched_steps": steps,
                           "ms_per_macro_step": wall / max(1, steps) * 1e3,
                           "launches": launches}
        state_off = runs["off"][1]
        run_on, (state_on, tele) = runs["on"]
        part_b["unequal_leaves"] = unequal_leaves(state_off, state_on)
        part_b.update(telemetry_identities(state_on, tele))
        part_b["lanes"] = []
        for i, (p, f) in enumerate(lanes):
            r = result_from_state(state_on, p, dt_ref=run_on.dt_ref, lane=i)
            t = summarize(lane_slice(tele, i), policies=run_on.policy_names,
                          steps=r.steps)
            part_b["lanes"].append({
                "policy": p, "frac": f, "macro_steps": r.steps,
                "truncated": r.extras["truncated"],
                "hit_rate": t["hit_rate"], "loads": t["loads"],
                "evictions": t["evictions"],
                "evict_rank_hist": t["evict_rank_hist"],
                "jump_hist": t["jump_hist"],
                "chunk_picks": t["chunk_picks"],
                "ioq_depth_max": t["ioq_depth_max"],
                "pbm_bucket_occupancy":
                    t.get("policy_obs", {}).get("pbm")})
        t_prof = time.time()
        prof = profile_nest({t: r for t, (r, _) in runs.items()}, cfgs,
                            TELEMETRY_WARM, TELEMETRY_WINDOW,
                            TELEMETRY_PROFILED)
        part_b["profile_s"] = time.time() - t_prof
        for tag in runs:
            part_b[tag]["profile"] = prof[tag]
        prof_off, prof_on = prof["off"], prof["on"]
        part_b["launches_added_per_step"] = (
            prof_on["device_launches_per_step"]
            - prof_off["device_launches_per_step"])
        part_b["ms_added_per_step"] = (prof_on["ms_per_step"]
                                       - prof_off["ms_per_step"])
        out["b"] = part_b
        seconds["b"] = time.time() - t_phase - seconds["a"]

        # (c) the flight recorder, against the runner and the event engine
        spec, cap = _build_point(0.1, 4, 4, 3, 0.4)
        cfg = make_config(spec, cap, 700e6, "pbm", device=dev)
        t0 = time.time()
        sess = TraceSession(spec, policies=("pbm",), device=dev)
        traced = sess.run(cfg)
        trace_s = time.time() - t0
        run = make_runner(spec, bandwidth_ref=700e6, time_slice=0.1,
                          policies=("pbm",), stepper="horizon",
                          telemetry=True, device=dev)
        st, tele_c = run(cfg)
        te = sess.eviction_total()
        chrome = sess.to_chrome()
        xs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
        t_wait = time.time()
        ev_total, ev_wall = event_future.result()
        seconds["event_wait"] = time.time() - t_wait
        bar = ERROR_BARS[(0.4, "pbm")]
        out["c"] = {
            "P": spec.n_pages, "macro_steps": len(sess.events),
            "trace_s": trace_s, "trace_evictions": te,
            "runner_evictions": int(tele_c.evictions[0]),
            "trace_t": float(traced.t[0]), "runner_t": float(st.t[0]),
            "event_evictions": ev_total, "event_wall_s": ev_wall,
            "rel_to_event": te / max(1, ev_total) - 1.0, "bar": bar,
            "chrome_evicted": sum(e["args"]["evicted"] for e in xs),
            "chrome_durations_positive": all(e["dur"] > 0 for e in xs),
            "manifest": collect_manifest(
                spec=spec, runner=run, policy="pbm", buffer_frac=0.4,
                scale=0.1, macro_steps=len(sess.events), evictions=te,
                telemetry=summarize(lane_slice(tele_c, 0),
                                    policies=run.policy_names,
                                    steps=int(st.steps[0]))),
        }
        seconds["c"] = time.time() - t_phase - seconds["a"] - seconds["b"]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    c = out["c"]
    out["gpu"] = nvidia_smi_line()
    out["seconds"] = time.time() - t_phase
    checks = {
        "a": all(not part_a[s]["unequal_leaves"] and part_a[s]["loads_equal"]
                 and part_a[s]["jump_hist_sums_to_steps"]
                 and part_a[s]["hits_plus_misses_positive"]
                 for s in ("fixed", "horizon")),
        "b": (not part_b["unequal_leaves"] and part_b["loads_equal"]
              and part_b["jump_hist_sums_to_steps"]
              and all(v > 0 for v in part_b["on"]["launches"].values())),
        "c": (c["trace_evictions"] == c["runner_evictions"] > 0
              and c["trace_t"] == c["runner_t"]
              and abs(c["trace_evictions"] - c["event_evictions"])
              <= max(2, bar * c["event_evictions"])
              and c["chrome_evicted"] == c["trace_evictions"]
              and c["chrome_durations_positive"]),
    }
    out["checks"] = checks
    out["ok"] = all(checks.values())
    emit(out)
    if not out["ok"]:
        fail("sim_telemetry", f"a telemetry check failed: {checks}")
    return part_b["on"]["launches"]


def phase_tpch_probe(dev, recorder: Recorder,
                     max_slices: int = TPCH_SLICES) -> None:
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


# ------------------------------------------------------------ page split ----

#: page shards the split path is held to the single-stage kernel at
SPLIT_SHARDS = (2, 4, 8)
#: the TPC-H deployment beyond one block a lane: scale 4.0 (P = 35,328)
TPCH_BIG = dict(scale=4.0, n_streams=8, seed=7, max_slices=TPCH_SLICES)


def seeded_split_cases(dev):
    """The JAX package's seeded cases of its page-sharded ops test
    (``tests/test_time_engine.py`` 238-264: P = 1024, four trials), the
    trials as four lanes: ``{kernel: [(args, static), ...]}``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)
    Pn, keys, sizes, evs, fkeys = 1024, [], [], [], []
    for _ in range(4):
        keys.append(rng.integers(-1, 1 << 28, Pn).astype(np.int32))
        sizes.append(rng.choice([524288.0, 4096.0], Pn).astype(np.float32))
        evs.append(rng.random(Pn) < 0.7)
        fkeys.append(rng.random(Pn).astype(np.float32))
    t = lambda a: torch.from_numpy(np.stack(a)).to(dev)  # noqa: E731
    full = lambda v, dt: torch.full((4,), v, dtype=dt, device=dev)  # noqa
    return {
        "fifo_grant": [([t(keys), t(sizes), full(4e6, torch.float32),
                         full(9, torch.int32)], {"vmax": 16})],
        "batched_evict": [([t(fkeys), t(sizes), t(evs),
                            full(3e6, torch.float32)], {"vmax": 64})],
    }


def split_against_unsplit(dev, recorder: Recorder) -> dict:
    """Part (a) of ``page_split``: B1 and B2 with ``page_shards`` in
    SPLIT_SHARDS (those that divide P) against the single-stage kernel on
    the inputs captured at P = 768, 3,072 and 8,832, the seeded cases,
    the fuzz cases and the split cases at P = 8,832 with vmax = 2,048
    (the whole-row kernels): mismatches in the mask, the bytes and the
    count; and B1-B3 at P = 20,000 against their plain versions."""
    from repro_torch.kernels import cases as kcases
    from repro_torch.kernels import ops
    from repro_torch.kernels.pbm_timeline import lane_paths
    inputs = seeded_split_cases(dev)
    for (name, P), samples in recorder.samples.items():
        if name in inputs and P <= 8832:
            inputs[name] += samples
    split = kcases.split_cases()
    for name in inputs:
        for case in kcases.CASES[name]() + [
                c for c in split[name] if c["shards"]]:
            inputs[name].append(
                (_to_dev(case, kcases.TENSOR_FIELDS[name], dev),
                 dict(case["static"])))
    out = {}
    for name, calls in inputs.items():
        fn = getattr(ops, name)
        bad, by_p, paths = 0, {}, {}
        for args, static in calls:
            want = fn(*args, **static)
            P = int(args[0].shape[1])
            for n in SPLIT_SHARDS:
                if P % n:
                    continue
                st = {**static, "page_shards": n}
                got = fn(*args, **st)
                bad += _compare(got, want)[0]
                by_p[P] = by_p.get(P, 0) + 1
                for path in lane_paths(name, args, st):
                    paths[path] = paths.get(path, 0) + 1
        out[name] = {"comparisons": sum(by_p.values()), "mismatches": bad,
                     "shards": list(SPLIT_SHARDS), "lane_paths": paths,
                     "comparisons_by_P": {str(k): v for k, v in
                                          sorted(by_p.items())}}
    fns = kernel_fns()
    for name, cs in split.items():
        kernel, plain = fns[name]
        bad, paths = 0, {}
        for case in [c for c in cs if not c["shards"]]:
            args = _to_dev(case, kcases.TENSOR_FIELDS[name], dev)
            bad += _compare(kernel(*args, **case["static"]),
                            plain(*args, **case["static"]))[0]
            for path in lane_paths(name, args, case["static"]):
                paths[path] = paths.get(path, 0) + 1
        out[f"{name}_beyond_one_block"] = {"P": 20_000, "mismatches": bad,
                                           "lane_paths": paths}
    return out


def tpch_big_run(dev, recorder: Recorder) -> dict:
    """Part (b) of ``page_split``: TPC-H at scale 4.0 (P = 35,328), the
    horizon stepper with ``wake_exact`` over ``tpch_probe``'s lanes, cut
    at ``TPCH_SLICES`` slices; B1-B3 take only the page-split kernels here, and the
    kernels line holds their captured inputs to the plain versions."""
    from repro_torch.kernels.pbm_timeline import split_shards, splits
    cfg = TPCH_BIG
    spec, cfgs, kw = tpch_big_point(dev, cfg["max_slices"])
    if not splits(spec.n_pages):
        fail("page_split", f"tpch_big: P={spec.n_pages} fits one block")
    kw.pop("policies")
    with recorder:
        results, wall, launches, steps, _ = run_sweep_counted(
            spec, cfgs, dev, **kw)
    return {"P": spec.n_pages, "shards": split_shards(spec.n_pages),
            "C": spec.n_cols, "Q": spec.n_queries, **cfg,
            "truncated": True, "wall_s": wall, "batched_steps": steps,
            "ms_per_macro_step": wall / max(1, steps) * 1e3,
            "sim_seconds_covered": max(r.sim_time for r in results),
            "finite": all(r.sim_time == r.sim_time for r in results),
            "launches": launches}


def mesh_runner_check(dev) -> dict:
    """Part (c) of ``page_split``: ``make_runner(mesh=)`` with a
    ``('lanes', 'page')`` mesh of shape (1, 4) on the card at
    ``sim_small``'s point under both steppers, every state leaf against
    ``mesh=None``."""
    import torch
    from repro_torch.core.array_sim import Mesh, make_runner
    spec, cfgs, point = sim_small_point(dev)
    mesh = Mesh([[dev] * 4], ("lanes", "page"))
    out = {"P": spec.n_pages, "mesh": mesh.shape}
    for stepper in ("fixed", "horizon"):
        kw = dict(point, stepper=stepper)
        plain = make_runner(spec, device=dev, **kw)(cfgs)
        runner = make_runner(spec, mesh=mesh, **kw)
        split = runner(cfgs)
        torch.cuda.synchronize()
        a, b = dict(_leaves(plain)), dict(_leaves(split))
        unequal = [k for k in a if not torch.equal(a[k], b[k])]
        out[stepper] = {"leaves": len(a), "unequal": unequal,
                        "page_axis": runner.page_axis}
    return out


def phase_page_split(dev, recorder: Recorder) -> dict:
    """Page-split candidate selection on the card: (a) split against
    unsplit, (b) ``tpch_big``, (c) the mesh runner."""
    out = {"phase": "page_split"}
    out["split_vs_unsplit"] = split_against_unsplit(dev, recorder)
    out["tpch_big"] = tpch_big_run(dev, recorder)
    out["mesh_runner"] = mesh_runner_check(dev)
    out["ok"] = (
        all(v["mismatches"] == 0 for v in out["split_vs_unsplit"].values())
        and out["tpch_big"]["finite"]
        and all(out["mesh_runner"][s]["unequal"] == []
                for s in ("fixed", "horizon")))
    emit(out)
    if not out["ok"]:
        fail("page_split", "a split kernel disagrees with the single-stage "
                           "one, or the mesh runner with mesh=None")
    return out["tpch_big"]["launches"], out["tpch_big"]["ms_per_macro_step"]


# ------------------------------------------------------------ mesh ranks ----

#: the slices (b)'s two ranks, which step eagerly, run of each point
MESH_RANK_SLICES = {"sim_small": 24, "tpch_big": 4}
#: the share of pages evictable in (a)'s check of B1's rank stages (the
#: step's own mask is empty at its first step: nothing is cached yet)
EVICTABLE = 0.7
#: (a)'s child and (b)'s ranks, each start-up and build included (a
#: collective of their groups fails past 60 s on its own)
MESH_CHILD_TIMEOUT_S = 300.0


def sim_small_point(dev, max_slices=None):
    """``sim_small``'s point (scale 0.03, twelve lanes): spec, configs and
    the runner's knobs (run to its end, or cut at ``max_slices``)."""
    scale = 0.03
    spec, ws = micro_workload(scale, 3, 3)
    _, cfgs = sweep_configs(spec, ws, (0.2, 0.4, 0.8), dev)
    kw = dict(time_slice=0.1 * scale, policies=POLICIES)
    if max_slices is not None:
        kw["max_slices"] = max_slices
    return spec, cfgs, kw


def tpch_big_point(dev, max_slices: int):
    """``tpch_big`` (TPC-H at scale 4.0, P = 35,328, 24 lanes, the horizon
    stepper with ``wake_exact``) cut at ``max_slices``: spec, configs and
    the runner's knobs."""
    from repro_torch.core.array_sim import compile_workload
    from repro_torch.core.workload import (
        make_tpch_db, tpch_accessed_bytes, tpch_streams)
    cfg = TPCH_BIG
    db = make_tpch_db(scale=cfg["scale"])
    streams = tpch_streams(db, n_streams=cfg["n_streams"], seed=cfg["seed"])
    spec = compile_workload(db, streams)
    _, cfgs = sweep_configs(spec, tpch_accessed_bytes(db, streams), FRACS,
                            dev, bandwidth=600e6)
    return spec, cfgs, dict(time_slice=0.1, bandwidth_ref=600e6,
                            stepper="horizon", wake_exact=True,
                            max_slices=max_slices, policies=POLICIES)


class Gathers:
    """While active: the buffer each buffer-pool kernel all-gathers across
    a page row (shape, dtype) and a clone of its first call's inputs."""

    KERNELS = ("batched_evict", "fifo_grant")

    def __enter__(self):
        from repro_torch.kernels import collective, ops
        self.sizes, self.calls, self._tag = {}, {}, None
        self._saved = [(collective, "all_gather", collective.all_gather)] + [
            (ops, n, getattr(ops, n)) for n in self.KERNELS]
        gather = collective.all_gather

        def gathered(x, group):
            self.sizes.setdefault(self._tag, (tuple(x.shape), x.dtype))
            return gather(x, group)
        collective.all_gather = gathered
        for mod, name, fn in self._saved[1:]:
            setattr(mod, name, self._tagged(name, fn))
        return self

    def _tagged(self, name, fn):
        def call(*args, **static):
            self.calls.setdefault(name, ([a.clone() for a in args],
                                         dict(static)))
            self._tag = name
            try:
                return fn(*args, **static)
            finally:
                self._tag = None
        return call

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def gather_ms(sizes: dict, group, dev, n: int = 20) -> dict:
    """Wall ms of one all-gather of each buffer over ``group`` (host clock
    around ``n`` calls, synchronised), and on an NCCL group the device ms
    between CUDA events too."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import collective
    out = {}
    for name, (shape, dtype) in sizes.items():
        buf = torch.zeros(shape, dtype=dtype, device=dev)
        collective.all_gather(buf, group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            collective.all_gather(buf, group)
        torch.cuda.synchronize()
        row = {"bytes": buf.numel() * buf.element_size(),
               "ms": (time.perf_counter() - t0) * 1e3 / n,
               "backend": dist.get_backend(group)}
        if row["backend"] == "nccl":
            row["device_ms"] = _time_ms(
                lambda: collective.all_gather(buf, group), dev, n=n)
        out[name] = row
    return out


def rank_stages(calls: dict, dev) -> dict:
    """B1's and B2's rank path at each rank's shard offset of a page row of
    one and of two ranks, on the inputs of ``calls`` (one step's, kept by
    :class:`Gathers`): each rank's stage 1 alone into its own buffer
    (device ms, ``_queued_ms``); the buffers stacked rank-major, as the
    all-gather lays them out; the finish on them (``Ranks{n, stride}``,
    the row zeroed) into outputs planted with a sentinel, so that a row
    it fails to zero shows; and the result against the plain version
    (``ref``) on the same inputs: mismatches of each output, and a check
    whose plain version selects nothing fails."""
    import torch
    from repro_torch.kernels import pbm_timeline as pt
    from repro_torch.kernels import ref
    lib, max_dyn = pt.library(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for name, (args, static) in calls.items():
        key, sizes = args[0], args[1]
        L, P = key.shape
        vmax = int(static["vmax"])
        stride = 0 if sizes.dim() == 1 else P
        evict = name == "batched_evict"
        want = (ref.batched_evict_ref(*args, vmax=vmax),) if evict else \
            ref.fifo_grant_ref(*args, vmax=vmax)
        rows, checks = [], []
        for n_rank in (1, 2):
            n_loc = pt.split_ranks(P, n_rank, max_dyn[3])
            n_sh = n_rank * n_loc
            m_slots, whole = pt._head_slots(P, vmax, n_sh)
            if whole:
                continue
            words = L * n_loc * m_slots
            bufs = []
            for rank in range(n_rank):
                own = torch.empty(words + (0 if evict else L * n_loc),
                                  dtype=torch.int64, device=dev)
                if evict:
                    fn = (lib.pbm_split_evict_cand_f32
                          if key.dtype == torch.float32
                          else lib.pbm_split_evict_cand_i32)
                    call = functools.partial(
                        fn, key.data_ptr(), args[2].data_ptr(),
                        args[3].data_ptr(), L, P, vmax, n_sh, rank * n_loc,
                        n_loc, m_slots, own.data_ptr(), stream)
                else:
                    call = functools.partial(
                        lib.pbm_split_grant_cand, key.data_ptr(),
                        sizes.data_ptr(), stride, args[3].data_ptr(),
                        own.data_ptr(), own[words:].data_ptr(), L, P, vmax,
                        n_sh, rank * n_loc, n_loc, m_slots, stream)
                if call() != 0:
                    fail("mesh_ranks", f"{name} stage 1 refused a launch")
                rows.append({"ranks": n_rank, "rank": rank,
                             "shards": [rank * n_loc, n_loc, n_sh],
                             "m_slots": m_slots,
                             "device_ms": _queued_ms(call)[0]})
                bufs.append(own)
            every = torch.stack(bufs)
            got = (torch.ones((L, P), dtype=torch.bool, device=dev),)
            if evict:
                err = lib.pbm_split_evict_finish(
                    every.data_ptr(), sizes.data_ptr(), stride,
                    args[2].data_ptr(), args[3].data_ptr(),
                    got[0].data_ptr(), L, P, vmax, n_sh * m_slots, n_rank,
                    every.shape[1], stream)
            else:
                got += (torch.full((L,), -7.0, device=dev),
                        torch.full((L,), -7, dtype=torch.int32, device=dev))
                err = lib.pbm_split_grant_finish(
                    every.data_ptr(), every[0, words:].data_ptr(),
                    sizes.data_ptr(), stride, args[2].data_ptr(),
                    args[3].data_ptr(), got[0].data_ptr(), got[1].data_ptr(),
                    got[2].data_ptr(), L, P, vmax, n_sh, n_sh * m_slots,
                    n_rank, every.shape[1], stream)
            torch.cuda.synchronize()
            checks.append({
                "ranks": n_rank, "rc": err,
                "selected": int(got[0].sum()),
                "want_selected": int(want[0].sum()),
                "mismatches": [int((g != w).sum())
                               for g, w in zip(got, want)]})
            checks[-1]["ok"] = (err == 0 and checks[-1]["want_selected"] > 0
                                and not any(checks[-1]["mismatches"]))
        out[name] = {"L": L, "P": P, "vmax": vmax, "rows": rows,
                     "finish": checks,
                     "ok": any(c["ranks"] == 2 for c in checks)
                     and all(c["ok"] for c in checks)}
    out["ok"] = bool(calls) and all(v["ok"] for v in out.values())
    return out


def _rendezvous(tmp: str) -> str:
    return f"file://{os.path.join(tmp, 'rendezvous')}"


def nccl_rank_run(dev) -> dict:
    """Part (a) of ``mesh_ranks``, in a fresh process (its own NCCL group;
    the profiler counts reliably early in a process): ``tpch_big`` cut at
    ``TPCH_SLICES`` on a (1, 1) ('lanes', 'page') DeviceMesh of one NCCL
    rank, its steps replayed from captured graphs with the all-gathers
    inside, against ``mesh=None`` on the same card: every leaf; ms a
    macro-step of each, the first run (captures included, as ``page_split``
    (b) times it) and then one more each, warm; the CUDA kernels of each
    captured graph against its eager body (``_graph_rows``) and beyond the
    one-process graph (:func:`collective_in_graphs`); the all-gather's
    time a call; and B1's and B2's stages at one and two ranks' shard
    offsets, the finish held to the plain versions (:func:`rank_stages`).
    ``seconds_parts`` says where the child's time went."""
    import tempfile

    import torch
    from repro_torch.core.array_sim import make_runner
    from repro_torch.core.array_sim.dist import close_mesh, init_mesh
    from repro_torch.kernels import ops
    t_phase = time.time()
    parts = {}

    def lap(name, t=[t_phase]):
        parts[name] = time.time() - t[0]
        t[0] = time.time()
    spec, cfgs, kw = tpch_big_point(dev, TPCH_SLICES)
    lap("setup")
    out = {"point": "tpch_big", "P": spec.n_pages,
           "L": int(cfgs.policy.shape[0]), "max_slices": TPCH_SLICES,
           "mesh": [1, 1], "backend": "nccl"}

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.time()
        state = run(cfgs)
        torch.cuda.synchronize()
        steps = run.stats["cheap_steps"] + run.stats["refresh_steps"]
        return state, (time.time() - t0) / max(1, steps) * 1e3, steps

    plain = make_runner(spec, device=dev, **kw)
    want, out["plain_first_ms_per_macro_step"], out["macro_steps"] = \
        timed(plain)
    tmp = tempfile.mkdtemp(prefix="mesh_ranks_")
    try:
        mesh = init_mesh((1, 1), ("lanes", "page"), "cuda",
                         init_method=_rendezvous(tmp), rank=0, world_size=1)
        run = make_runner(spec, mesh=mesh, **kw)
        ops.reset_launch_counts()
        got, out["first_ms_per_macro_step"], steps = timed(run)
        out["launches"] = {k: v for k, v in ops.launch_counts().items()
                           if k in SIM_KERNELS}
        turns = {"plain": [], "rank": []}
        unequal = set(unequal_leaves(want, got))
        for tag in ("rank", "plain"):
            state, ms, _ = timed(plain if tag == "plain" else run)
            turns[tag].append(ms)
            if tag == "rank":
                unequal |= set(unequal_leaves(want, state))
        out["plain_ms_per_macro_step"] = turns["plain"]
        out["ms_per_macro_step"] = turns["rank"]
        out["unequal_leaves"] = sorted(unequal)
        out["steps_equal"] = steps == out["macro_steps"]
        lap("runs")
        one = run.runners[run.device]
        with Gathers() as g:
            one.cheap(one.init_carry(cfgs), cfgs)
            torch.cuda.synchronize()
        out["gather"] = gather_ms(g.sizes, mesh.get_group("page"), dev)
        args, static = g.calls["batched_evict"]     # every lane freeing
        pick = torch.Generator(device=dev).manual_seed(TPCH_BIG["seed"])
        g.calls["batched_evict"] = (
            [*args[:2], torch.rand(args[2].shape, generator=pick,
                                   device=dev) < EVICTABLE,
             torch.full_like(args[3], float(16 << 20))], static)
        args, static = g.calls["fifo_grant"]        # every lane popping
        g.calls["fifo_grant"] = (
            [*args[:2], torch.full_like(args[2], float(1 << 30)),
             torch.full_like(args[3], int(static["vmax"]))], static)
        out["stage1"] = rank_stages(g.calls, dev)
        out["stage1"]["batched_evict"].update(need_free=16 << 20,
                                              evictable=EVICTABLE)
        out["stage1"]["fifo_grant"].update(budget=1 << 30, pops="vmax")
        lap("gather_and_stages")
        rows = out["graphs"] = _graph_rows(one)
        out["collective"] = collective_in_graphs(rows, plain)
        lap("graphs")
    finally:
        close_mesh()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    out["seconds_parts"] = parts
    out["ok"] = (not out["unequal_leaves"] and out["steps_equal"]
                 and all(r["ok"] for r in rows) and out["collective"]["ok"]
                 and out["stage1"]["ok"]
                 and all(v > 0 for v in out["launches"].values()))
    return out


def mesh_rank_child(rank: int, world: int, tmp: str, backend: str) -> dict:
    """One rank of part (b) of ``mesh_ranks``: the (1, 2) ('lanes',
    'page') and (2,) ('lanes',) DeviceMeshes over ``world`` = 2 processes
    (``backend`` ``gloo`` on CUDA tensors: both ranks on the one card;
    ``nccl``: one card a rank), ``sim_small``'s point under both steppers
    and ``tpch_big`` on (1, 2), each cut at ``MESH_RANK_SLICES``.  The
    (2,) mesh goes through ``make_runner(mesh=)`` itself (each rank's
    lane shard replayed from its graphs, the lanes all-gathered); on the
    (1, 2) mesh each rank drives its steps with :func:`eager_loop`, as a
    ``gloo`` collective cannot be captured (``make_runner`` refuses that
    page group on a CUDA device, which this records).  Every state goes
    to ``<tmp>/rank<r>.pt``."""
    import inspect

    import torch
    from repro_torch.core.array_sim import make_runner, sim
    from repro_torch.core.array_sim.dist import close_mesh, init_mesh
    from repro_torch.core.array_sim.mesh import mesh_ranks
    knobs = {k: p.default for k, p in
             inspect.signature(make_runner).parameters.items()
             if k not in ("spec", "mesh", "sanitize", "device")}
    res = {"rank": rank, "backend": backend, "runs": {}, "stats": {},
           "refused": None}
    states = {}
    try:
        meshes = {"1x2": init_mesh((1, 2), ("lanes", "page"), "cuda",
                                   backend=backend,
                                   init_method=_rendezvous(tmp), rank=rank,
                                   world_size=world),
                  "2": init_mesh((2,), ("lanes",), "cuda", backend=backend,
                                 init_method=_rendezvous(tmp), rank=rank,
                                 world_size=world)}
        dev = torch.device("cuda", torch.cuda.current_device())
        res["device"] = str(dev)
        small = sim_small_point(dev, MESH_RANK_SLICES["sim_small"])
        big = tpch_big_point(dev, MESH_RANK_SLICES["tpch_big"])
        if backend == "gloo":
            try:
                make_runner(small[0], mesh=meshes["1x2"], **small[2])
            except ValueError as e:
                res["refused"] = str(e)
        cases = [("sim_small", "1x2", s) for s in ("fixed", "horizon")] + [
            ("sim_small", "2", s) for s in ("fixed", "horizon")] + [
            ("tpch_big", "1x2", "horizon")]
        for point, name, stepper in cases:
            spec, cfgs, kw = small if point == "sim_small" else big
            me = mesh_ranks(meshes[name])
            t0 = time.time()
            if me.page_group is None:       # the entry point, replayed
                run = make_runner(spec, mesh=meshes[name],
                                  **{**kw, "stepper": stepper})
                state = run(cfgs)
                torch.cuda.synchronize()
                wall, stats = time.time() - t0, dict(run.stats)
            else:                           # a gloo page row, eager
                one = sim._runner(spec, dev, page_group=me.page_group,
                                  **{**knobs, **kw, "stepper": stepper})
                with Gathers() as g:
                    state, stats = eager_loop(one, spec, cfgs)
                torch.cuda.synchronize()
                wall = time.time() - t0
            states[point, name, stepper] = sim._tree_map(
                lambda x: x.cpu(), state)
            steps = stats["cheap_steps"] + stats["refresh_steps"]
            row = {"driven": "eager_loop" if me.page_group is not None
                   else "make_runner", "stats": stats, "wall_s": wall,
                   "ms_per_macro_step": wall / max(1, steps) * 1e3}
            if me.page_group is not None and point == "tpch_big":
                row["gather"] = gather_ms(g.sizes, me.page_group, dev)
            res["runs"][f"{point}/{name}/{stepper}"] = row
        torch.save(states, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        close_mesh()
    return res


def two_ranks_one_card(dev) -> dict:
    """Part (b) of ``mesh_ranks``: two processes of :func:`mesh_rank_child`
    (``gloo`` on the one card; ``nccl`` one card a rank where the machine
    has two), every state leaf of both ranks against ``mesh=None`` run on
    this process's card."""
    import tempfile

    import torch
    from repro_torch.core.array_sim import make_runner, sim
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards > 1 else "gloo"
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="mesh_ranks_")
    try:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             str(r), "2", tmp, backend], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
        outs = []
        deadline = time.time() + MESH_CHILD_TIMEOUT_S
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.time())))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, (so, se)) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or not so.strip():
                fail("mesh_ranks", f"rank {r} of (b) exited {p.returncode}: "
                                   f"{so[-800:]} {se[-2500:]}")
        ranks = [json.loads(so.strip().splitlines()[-1]) for so, _ in outs]
        states = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                             weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ranks_s = time.time() - t0
    small = sim_small_point(dev, MESH_RANK_SLICES["sim_small"])
    big = tpch_big_point(dev, MESH_RANK_SLICES["tpch_big"])
    want = {}
    unequal = {}
    for key in states[0]:
        point, name, stepper = key
        spec, cfgs, kw = small if point == "sim_small" else big
        if (point, stepper) not in want:
            run = make_runner(spec, device=dev, **{**kw, "stepper": stepper})
            want[point, stepper] = sim._tree_map(lambda x: x.cpu(),
                                                 run(cfgs))
        unequal["/".join(key)] = [
            unequal_leaves(want[point, stepper], st[key]) for st in states]
    return {"backend": backend, "ranks": ranks, "unequal_leaves": unequal,
            "seconds_parts": {"ranks": ranks_s,
                              "mesh_none": time.time() - t0 - ranks_s},
            "ok": all(not u for per in unequal.values() for u in per)
            and len(unequal) == 5
            and (backend != "gloo" or all(
                r["refused"] and "nccl" in r["refused"].lower()
                for r in ranks))}


def phase_mesh_ranks(dev, page_split_ms=None) -> dict:
    """The simulator's mesh across processes on the card: (a) one NCCL
    rank at ``tpch_big`` (:func:`nccl_rank_run`, a child process); (b) two
    ranks on the one card (:func:`two_ranks_one_card`).  No run across
    separate cards exists while the machine has one: ``cross_card`` says
    so."""
    import torch
    t0 = time.time()
    out = {"phase": "mesh_ranks", "device_count": torch.cuda.device_count(),
           "gpu": nvidia_smi_line()}
    if out["device_count"] == 1:
        out["cross_card"] = "not run: one card"
        out["nccl_capture"] = (
            "one rank only: NCCL runs a one-rank all-gather as a device "
            "copy, so no capture of an NCCL collective across two or more "
            "ranks has run")
    out["a"] = json_child("--mesh-nccl", "mesh_ranks", MESH_CHILD_TIMEOUT_S)
    out["a"]["page_split_b_ms_per_macro_step"] = page_split_ms
    t_b = time.time()
    out["b"] = two_ranks_one_card(dev)
    out["b"]["seconds"] = time.time() - t_b
    out["seconds"] = time.time() - t0
    out["ok"] = out["a"]["ok"] and out["b"]["ok"]
    emit(out)
    if not out["ok"]:
        fail("mesh_ranks", "a rank's state differs from mesh=None, a rank "
                           "stage's finish differs from its plain version, "
                           "a graph lacks its kernels or its all-gathers, or "
                           "(b)'s refusal is missing")
    return out


# ------------------------------------------------------------------ main ----

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="",
                    help="comma-separated subset of the phases (development)")
    ap.add_argument("--full-max-slices", type=int, default=None,
                    help="cut sim_full at this many slices")
    ap.add_argument("--count-launches", metavar="PATH",
                    help=argparse.SUPPRESS)     # the kernels phase's child
    ap.add_argument("--count-graph-kernels", action="store_true",
                    help=argparse.SUPPRESS)     # the sim_graphs phase's
    ap.add_argument("--mesh-nccl", action="store_true",
                    help=argparse.SUPPRESS)     # mesh_ranks (a)
    ap.add_argument("--mesh-rank", nargs=4, help=argparse.SUPPRESS,
                    metavar=("RANK", "WORLD", "DIR", "BACKEND"))  # (b)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    if args.count_launches:
        print(json.dumps(count_launches(args.count_launches,
                                        torch.device("cuda"))), flush=True)
        return 0
    if args.count_graph_kernels:
        print(json.dumps(count_graph_kernels(torch.device("cuda"))),
              flush=True)
        return 0
    if args.mesh_nccl:
        print(json.dumps(nccl_rank_run(torch.device("cuda"))), flush=True)
        return 0
    if args.mesh_rank:
        rank, world, tmp, backend = args.mesh_rank
        print(json.dumps(mesh_rank_child(int(rank), int(world), tmp,
                                         backend)), flush=True)
        return 0
    dev = torch.device("cuda")
    # full-f32 matrix products on the serving path (PyTorch's default,
    # stated): TF32 would not meet the f32 tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.analysis.kernels import build_gate
    from repro_torch.kernels import (
        _build, flash_attention, mamba2_scan, mlstm, paged_attention,
        pbm_timeline)

    all_phases = ["env", "build", "contracts", "kernels_fuzz", "paged_fuzz",
                  "model_fuzz", "sim_small", "sim_graphs", "sanitize",
                  "serve_small",
                  "model_serve", "sim_calibrated", "sim_fixed",
                  "sim_telemetry", "serve_full", "train", "examples",
                  "sim_full", "tpch_probe", "page_split", "mesh_ranks",
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
        gate = build_gate(libraries)
        out["resource_usage"], out["sass"] = (gate["resource_usage"],
                                              gate["sass"])
        # ptxas -v of the builds this process ran (none for a library
        # found built): extra output, the gate reads the binaries
        out["ptxas"] = _build.ptxas_usage
        out["warnings"] = {k: v for k, v in _build.build_warnings.items() if v}
        out["ok"] = gate["ok"]
        emit(out)
        if not out["ok"]:
            fail("build", gate["why"])

    if "contracts" in phases:
        phase_contracts(dev)
    if "kernels_fuzz" in phases:
        phase_kernels_fuzz(dev)
    if "paged_fuzz" in phases:
        phase_paged_fuzz(dev)
    if "model_fuzz" in phases:
        phase_model_fuzz(dev)
    if "sim_small" in phases:
        phase_sim_small(dev)
    if "sim_graphs" in phases:
        phase_sim_graphs(dev)
    if "sanitize" in phases:
        phase_sanitize(dev)
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
            by_phase["sim_fixed"] = phase_sim_fixed(dev, events)
    finally:
        if events is not None:
            events.close()
    if "sim_telemetry" in phases:
        by_phase["sim_telemetry"] = phase_sim_telemetry(dev)
    if "serve_full" in phases:
        serve_full = phase_serve_full(dev, serve_recorder)
    train = (phase_train(dev, FirstCalls()) if "train" in phases
             else None)
    if "examples" in phases:
        phase_examples(dev)
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
    page_split_ms = None
    if "page_split" in phases:
        by_phase["tpch_big"], page_split_ms = phase_page_split(dev, recorder)
    if "mesh_ranks" in phases:
        phase_mesh_ranks(dev, page_split_ms)

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
            entries += model_kernel_entries(dev, model_calls, model_serve,
                                            train)
        if train is not None:           # the training path's own counts
            for e in entries:
                if e["name"] in MODEL_KERNELS:
                    e["launches_train"] = train_launches(train, e["name"])
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
