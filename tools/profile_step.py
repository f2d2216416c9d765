"""Profile the simulator's step on the card: how many device kernels
one step launches, by operator, and what a step costs on the host clock.

    python3 tools/profile_step.py [--scale 0.25] [--steps 40] [--stepper horizon]
                                  [--telemetry]

The lanes are ``chip_smoke.py``'s calibrated sweep (every policy, the
cooperative one included, at every buffer fraction); ``--stepper fixed``
profiles the fixed-dt step instead of the horizon macro-step, and
``--telemetry`` the step with the carried counters of ``repro_torch.obs``
on (without it the runner is built as before: telemetry off).

Prints one JSON object per line: the card, the step's wall time (host
clock around steps that end in a synchronise), then for one profiled
window the device launches per step, the device's busy time and idle share,
the hand-written kernels' share of the device time, and the operators
sorted by device time and by launch count.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--warm", type=int, default=400)
    ap.add_argument("--stepper", choices=("horizon", "fixed"),
                    default="horizon")
    ap.add_argument("--telemetry", action="store_true",
                    help="build the runner with telemetry=True")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.core.array_sim import make_runner

    dev = torch.device("cuda")
    spec, ws = cs.micro_workload(args.scale, 8, 16)
    _, cfgs = cs.sweep_configs(spec, ws, cs.FRACS, dev)
    run = make_runner(spec, policies=cs.POLICIES, device=dev,
                      time_slice=0.1 * args.scale, stepper=args.stepper,
                      telemetry=args.telemetry)
    lc = run.cheap.lane_consts(cfgs)
    carry = run.init_carry(cfgs)
    live = torch.ones(cfgs.policy.shape[0], dtype=torch.bool, device=dev)
    count = [0]

    def slice_of_steps(carry, n):
        # the runner's own nest, without its reads (chip_smoke.nest_steps);
        # every step counts towards the fixed stepper's slice ends
        carry = cs.nest_steps(run, cfgs, lc, live, carry, n, count[0])
        count[0] += n
        return carry

    print(json.dumps({"gpu": cs.nvidia_smi_line(), "P": spec.n_pages,
                      "L": int(live.shape[0]), "stepper": args.stepper,
                      "telemetry": args.telemetry}),
          flush=True)
    carry = slice_of_steps(carry, args.warm)
    torch.cuda.synchronize()
    for mode in ("plain", "inference_mode"):
        t0 = time.time()
        if mode == "plain":
            carry = slice_of_steps(carry, args.steps)
        else:
            with torch.inference_mode():
                slice_of_steps(carry, args.steps)
        torch.cuda.synchronize()
        ms = (time.time() - t0) / args.steps * 1e3
        if mode == "plain":
            ms_plain = ms
        print(json.dumps({"mode": mode, "steps": args.steps,
                          "ms_per_step": ms}), flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        carry = slice_of_steps(carry, args.steps)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
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
        rows.append({"op": k.key, "per_step": k.count / args.steps,
                     "host_us_per_step": k.self_cpu_time_total / args.steps,
                     "device_us_per_step": dev_us / args.steps})
    rows.sort(key=lambda r: -r["device_us_per_step"])
    busy_ms = dev_total / args.steps / 1e3
    print(json.dumps({
        "device_launches_per_step": launches / args.steps,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share_of_plain_step": 1.0 - busy_ms / ms_plain,
        "hand_kernel_launches_per_step": hand_launches / args.steps,
        "hand_kernel_device_ms_per_step": hand_total / args.steps / 1e3,
        "hand_kernel_share_of_device_time": hand_total / max(dev_total, 1e-9),
    }), flush=True)
    for r in rows[:40]:
        print(json.dumps(r), flush=True)
    rows.sort(key=lambda r: -r["per_step"])
    print(json.dumps({"by_count": [(r["op"], r["per_step"]) for r in rows[:60]]}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
