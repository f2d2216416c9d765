"""Time the queue kernels, fifo_grant (B2) and wake_solve (B3), on the card
at the simulator's page counts, on inputs shaped like its own.

    python3 tools/time_queue_kernels.py [--repeat 5]

For P = 768, 3072 and 8832: 18 lanes (a sweep's {lru, pbm, opt} x six
buffer fractions) of queue keys as the simulator builds them (stamp * 32768
+ tie), the lanes wanting from 0.2 % to all of their pages (spaced
geometrically: the simulator's own queues hold a few dozen pages, a full
queue runs every pass of the radix select), whole page sizes; fifo_grant
at vmax 384 with pops from 6 to 384, wake_solve at h_cap 64 and 6 pops a
step.  Each kernel is first held to its plain version (outputs
equal), then timed ``--repeat`` times by ``chip_smoke._queued_ms`` (20 calls
queued behind a sleep kernel: the device's time per call).  Prints the
card's name and power limit, then one JSON line per (kernel, P) with the
median and every repeat.  To compare two trees on one card, run it from
each in one call, in turns.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

PAGE_COUNTS = (768, 3072, 8832)


def inputs(P: int, dev, seed: int = 0):
    """(fifo_grant args, static), (wake_solve args, static) at P pages."""
    import numpy as np
    import torch
    from repro_torch.kernels import cases

    rng = np.random.default_rng(seed)
    fractions = np.geomspace(0.002, 1.0, 18)
    key = cases.queue_keys(rng, fractions, P).astype(np.int32)
    sizes = rng.integers(1, 9, P).astype(np.float32)     # one shared row

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    pops = rng.choice([6, 24, 96, 384], 18).astype(np.int32)
    grant = ([t(key), t(sizes), t(rng.uniform(100, 2000, 18), np.float32),
              t(pops)], {"vmax": 384})
    wake = ([t(key), t(sizes), t(rng.uniform(0, 9, 18), np.float32),
             t(rng.uniform(2, 40, 18), np.float32),
             t(np.full(18, 6, np.int32))], {"h_cap": 64})
    return grant, wake


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    for P in PAGE_COUNTS:
        grant, wake = inputs(P, dev)
        for name, (call_args, static) in (("fifo_grant", grant),
                                          ("wake_solve", wake)):
            kernel = getattr(ops, name)
            plain = getattr(ref, f"{name}_ref")
            bad, _ = cs._compare(kernel(*call_args, **static),
                                 plain(*call_args, **static))
            if bad:
                print(json.dumps({"kernel": name, "P": P,
                                  "mismatches": bad}), flush=True)
                return 1
            runs = [cs._queued_ms(lambda: kernel(*call_args, **static))[0]
                    for _ in range(args.repeat)]
            print(json.dumps({
                "kernel": name, "P": P, "L": 18, **static,
                "paths": cs.path_counts(name, [(call_args, static)]),
                "device_ms": statistics.median(runs), "runs": runs,
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
