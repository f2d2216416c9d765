"""Where the dry run's predicted peak of a training step and the card's
measured peak part: ``chip_smoke.py``'s ``train`` (b) step (qwen2_1_5b at
28 layers, f32, 8 x 1,024 tokens in 4 microbatches) run once on the card
under ``launch.counting.StepCounter``, with the allocator read after
every operator.

    PYTHONPATH=src python3 tools/dryrun_peak_gap.py [--seq 1024]

The counter's live set on the card's tensors (``live``: the storages the
step's operators allocated and that are still referenced) is set beside
``torch.cuda.memory_allocated()`` above the step's start (``card``) after
each operator; ``build_cell``'s meta run of the same step gives the
prediction.  So the gap splits into what the meta run counts differently
from the same counter over the card's operators (the kernels' wrappers
allocate their own outputs and scratch where the meta run has one
stand-in), and what the allocator holds beyond the live storages (its
rounding, storages no operator made).  A warm-up step runs first, so the
cuBLAS workspace and the kernels' libraries exist before the counted
step.  The same step then runs twice more, each peak above its own
start: with no dispatch mode (as the card runs it in ``launch.train``)
and under a mode that only calls each operator, so what the counter's
presence costs is told from what its bookkeeping costs.  Prints the
card's name and power limit, then one JSON line: the peaks with the
operator each was reached at, the largest gaps either way and the meta
prediction.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys


def main(argv=None) -> int:
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.counting import StepCounter
    from repro_torch.models import build_model, init_params
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    from torch.utils._python_dispatch import TorchDispatchMode

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1_5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--microbatches", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    shape = ShapeConfig("gap", args.seq, args.batch, "train")
    meta = dryrun.build_cell(args.arch, "gap", shape=shape,
                             param_dtype=torch.float32,
                             microbatches=args.microbatches)["bytes"]
    model = build_model(cfg)
    params = init_params(model.param_specs, 0, torch.float32, dev)
    opt = init_opt_state(params)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int32)).to(dev)}
    step = make_train_step(model, OptimizerConfig(), args.microbatches)
    step(params, opt, batch)                      # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    trace = []

    class Reading(StepCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            trace.append((str(func), self.live,
                          torch.cuda.memory_allocated() - base))
            return out

    state = dryrun.state_of(params, batch, {"opt_state": opt})
    counter = Reading((), state)
    with counter:
        step(params, opt, batch)
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated() - base

    class Bare(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    alone = {}                # the same step with no mode, then a bare one
    for name, mode in (("no_mode", contextlib.nullcontext()),
                       ("bare_mode", Bare())):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        with mode:
            step(params, opt, batch)
        torch.cuda.synchronize()
        alone[name] = torch.cuda.max_memory_allocated() - start
    i_live = max(range(len(trace)), key=lambda i: trace[i][1])
    i_card = max(range(len(trace)), key=lambda i: trace[i][2])
    gaps = sorted(range(len(trace)), key=lambda i: trace[i][2] - trace[i][1])
    row = {
        "arch": args.arch, "batch": args.batch, "seq": args.seq,
        "microbatches": args.microbatches, "operators": len(trace),
        "meta_activations_peak": meta["activations_peak"],
        "meta_peak": meta["peak"],
        "state_bytes": meta["peak"] - meta["activations_peak"],
        "live_peak_on_card": counter.activations_peak,
        "live_peak_at": [i_live, trace[i_live][0], trace[i_live][2]],
        "card_peak_above_start": card_peak,
        "card_peak_at_an_operator": [i_card, trace[i_card][0],
                                     trace[i_card][1], trace[i_card][2]],
        "start_bytes": base,
        "card_over_live_most": [trace[gaps[-1]][0],
                                trace[gaps[-1]][2] - trace[gaps[-1]][1]],
        "live_over_card_most": [trace[gaps[0]][0],
                                trace[gaps[0]][1] - trace[gaps[0]][2]],
        "card_peak_above_start_no_mode": alone["no_mode"],
        "card_peak_above_start_bare_mode": alone["bare_mode"],
        "device": torch.cuda.get_device_name(0)}
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
