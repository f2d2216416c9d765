"""Time B1 and B2 on the page-split path of one card, at the page count of
``chip_smoke.py``'s ``tpch_big`` (P = 35,328: three shards a lane), on
inputs shaped like the simulator's.

    python3 tools/time_split_kernels.py [--src DIR] [--repeat 5]

24 lanes (the sweep's four policies x six buffer fractions): B1 over f32
keys with 70 % of the pages evictable, each lane freeing 0.5-64 MB of
whole page sizes, at vmax 64 and 256; B2 over queue keys as the simulator
builds them (stamp * 32768 + tie, the lanes wanting 0.2 % to all of their
pages), at vmax 16 and 384 with 6 to 384 pops.  Each call is first held to
its plain version (outputs equal), then timed ``--repeat`` times by
``chip_smoke._queued_ms`` (20 calls queued behind a sleep kernel: the
device's time a call).  ``--src`` imports ``repro_torch`` from another
tree's ``src`` (a parent's, unpacked with ``git archive``), so that two
trees are timed on one card in one call: run it from each, in turns.
Prints the card's name and power limit, then one JSON line per (kernel,
vmax) with the median and every repeat.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

P, L = 35_328, 24


def inputs(dev, seed: int = 0) -> list:
    """``[(name, args, static), ...]`` of B1 and B2 at P pages."""
    import numpy as np
    import torch
    from repro_torch.kernels import cases

    rng = np.random.default_rng(seed)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    sizes = rng.choice([524288.0, 131072.0, 4096.0], P).astype(np.float32)
    fkey = rng.random((L, P)).astype(np.float32)
    ev = rng.random((L, P)) < 0.7
    need = np.geomspace(0.5e6, 64e6, L).astype(np.float32)
    qkey = cases.queue_keys(rng, np.geomspace(0.002, 1.0, L), P).astype(
        np.int32)
    budget = rng.uniform(1e6, 2e8, L).astype(np.float32)
    pops = rng.choice([6, 24, 96, 384], L).astype(np.int32)
    out = []
    for vmax in (64, 256):
        out.append(("batched_evict", [t(fkey), t(sizes), t(ev), t(need)],
                    {"vmax": vmax}))
    for vmax in (16, 384):
        out.append(("fifo_grant", [t(qkey), t(sizes), t(budget), t(pops)],
                    {"vmax": vmax}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(HERE, "src"),
                    help="the tree whose repro_torch is timed")
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    plain = {"batched_evict": ref.batched_evict_ref,
             "fifo_grant": ref.fifo_grant_ref}
    for name, call_args, static in inputs(dev):
        kernel = getattr(ops, name)
        bad, _ = cs._compare(kernel(*call_args, **static),
                             plain[name](*call_args, **static))
        if bad:
            print(json.dumps({"kernel": name, **static, "mismatches": bad}),
                  flush=True)
            return 1
        runs = [cs._queued_ms(lambda: kernel(*call_args, **static))[0]
                for _ in range(args.repeat)]
        print(json.dumps({
            "kernel": name, "src": args.src, "P": P, "L": L, **static,
            "paths": cs.path_counts(name, [(call_args, static)]),
            "device_ms": statistics.median(runs), "runs": runs,
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
