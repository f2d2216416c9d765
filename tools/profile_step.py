"""Profile the simulator's step on the card: the runner's replays of its
captured graphs beside the same steps driven eagerly.

    python3 tools/profile_step.py [--scale 0.25] [--slices 12]
                                  [--stepper horizon] [--telemetry]

The lanes are ``chip_smoke.py``'s calibrated sweep (every policy, the
cooperative one included, at every buffer fraction), the runner cut at
``--slices`` slices.  ``--stepper fixed`` profiles the fixed-dt stepper
instead of the horizon macro-step (one graph a fine step, replayed
n_inner - 1 times, then the refresh step's); ``--telemetry`` builds the
runner with the carried counters of ``repro_torch.obs`` on.

For each way of running the steps (``graphs``: the runner's own runs, the
first of which captures; ``eager``: ``chip_smoke.nest_steps`` over as
many steps), one
JSON object: the host's ms a step (host clock around runs that end in a
synchronise), and from one run under ``torch.profiler`` the device kernels
a step, the device's busy ms a step and its idle share, and the
hand-written kernels' share of the device time; then the operators of
the eager step sorted by device time.  The card's name and power limit
come first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)


def profiled(fn, steps: int, ms_per_step: float) -> tuple:
    """``fn()`` once under the profiler: the summary over ``steps`` steps
    and the device's rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    dev_total = hand_total = 0.0
    launches = hand_launches = 0
    for k in prof.key_averages():
        dev_us = getattr(k, "self_device_time_total", 0.0) or 0.0
        if k.device_type == DeviceType.CUDA:
            # an event of the device's own timeline: a kernel, a copy or a
            # fill that the step put on the stream.  (An operator's row
            # repeats the device time of the kernels it launched: only the
            # device's own rows are summed.)
            launches += k.count
            dev_total += dev_us
            if any(name in k.key for name in cs.REPLACES):
                hand_launches += k.count
                hand_total += dev_us
        rows.append({"op": k.key, "per_step": k.count / steps,
                     "host_us_per_step": k.self_cpu_time_total / steps,
                     "device_us_per_step": dev_us / steps})
    busy_ms = dev_total / steps / 1e3
    return {
        "device_kernels_per_step": launches / steps,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / ms_per_step,
        "hand_kernels_per_step": hand_launches / steps,
        "hand_kernel_device_ms_per_step": hand_total / steps / 1e3,
        "hand_kernel_share_of_device_time": hand_total / max(dev_total, 1e-9),
    }, rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--slices", type=int, default=12)
    ap.add_argument("--stepper", choices=("horizon", "fixed"),
                    default="horizon")
    ap.add_argument("--telemetry", action="store_true",
                    help="build the runner with telemetry=True")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.core.array_sim import make_runner

    dev = torch.device("cuda")
    spec, ws = cs.micro_workload(args.scale, 8, 16)
    _, cfgs = cs.sweep_configs(spec, ws, cs.FRACS, dev)
    L = cfgs.policy.shape[0]
    print(json.dumps({"gpu": cs.nvidia_smi_line(), "P": spec.n_pages,
                      "L": L, "stepper": args.stepper,
                      "slices": args.slices, "telemetry": args.telemetry}),
          flush=True)

    def runner():
        return make_runner(spec, policies=cs.POLICIES, device=dev,
                           time_slice=0.1 * args.scale, stepper=args.stepper,
                           telemetry=args.telemetry, max_slices=args.slices)

    run = runner()
    t0 = time.time()
    run(cfgs)                           # captures every graph it takes
    torch.cuda.synchronize()
    first_s = time.time() - t0
    steps = run.stats["cheap_steps"] + run.stats["refresh_steps"]
    t0 = time.time()
    run(cfgs)
    torch.cuda.synchronize()
    ms = (time.time() - t0) / steps * 1e3
    summary, _ = profiled(lambda: run(cfgs), steps, ms)
    print(json.dumps({
        "way": "graphs", "steps": steps, "host_reads": run.stats["host_reads"],
        "graphs": sorted(str(k) for rep in run._replays.values()
                         for k in rep.graphs),
        "first_run_s": first_s, "ms_per_step": ms, **summary}), flush=True)

    run = runner()
    lc = run.cheap.lane_consts(cfgs)
    live = torch.ones(L, dtype=torch.bool, device=dev)

    def eager():
        # the runner's own nest, without its reads (chip_smoke.nest_steps)
        return cs.nest_steps(run, cfgs, lc, live, run.init_carry(cfgs),
                             steps)
    eager()
    torch.cuda.synchronize()
    t0 = time.time()
    eager()
    torch.cuda.synchronize()
    ms = (time.time() - t0) / steps * 1e3
    summary, rows = profiled(eager, steps, ms)
    print(json.dumps({"way": "eager", "steps": steps, "ms_per_step": ms,
                      **summary}), flush=True)
    rows.sort(key=lambda r: -r["device_us_per_step"])
    for r in rows[:30]:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
