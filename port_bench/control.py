"""The readings that a cell's limits are set from (``limits/<cell>.json``),
at the cell's own size, on each seed given, in one process:

* ``sound``: the program's prefix sweep against the plain reference, as a
  run reads it (the lower readings);
* ``control``: the reference put in the program's place with one
  guarantee of the configuration broken, each lane's pool unbounded
  (nothing is ever evicted), read against the reference (the upper);
* ``faults``: the program's answers broken as a faulty timed path would
  break them, read against the reference: every lane's state left
  unchanged (nothing consumed or loaded), half the lanes answered with
  the other half's mean, the first and last lanes' answers swapped, each
  lane answered with the next policy's lane at its pool.

    python3 port_bench/control.py --workload <cell> --seeds 1 2 3

from the root of a checkout, on a card (``--device cpu`` elsewhere); one
JSON line a seed, with each lane's answers of the program and of the
reference.  The benchmark's runs do not run it.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from portbench import cells, check, harness, program, workloads  # noqa: E402


def faults(lanes, got):
    """Each fault's answers, from the program's sound ``got``."""
    L = len(got)
    half = got[: L // 2]
    mean = check.LaneResult(statistics.fmean(r.sim_s for r in half),
                            statistics.fmean(r.io_bytes for r in half),
                            statistics.fmean(r.tuples for r in half))
    swapped = list(got)
    swapped[0], swapped[-1] = got[-1], got[0]
    pols = list(dict.fromkeys(p for p, _f in lanes))
    where = {lane: i for i, lane in enumerate(lanes)}
    rotated = [got[where[(pols[(pols.index(p) + 1) % len(pols)], f)]]
               for p, f in lanes]
    return {
        "state_unchanged": [check.LaneResult(r.sim_s, 0.0, 0.0) for r in got],
        "half_mean": half + [mean] * (L - L // 2),
        "swap_ends": swapped,
        "policy_rotated": rotated,
    }


def readings(got, want):
    return {n: v for n, (v, _i) in check.worst(got, want).items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    root = Path.cwd()
    cell = cells.load(root, args.workload)
    harness._environment(root)
    harness._import_program(root)
    lanes = program.lanes(cell.traffic)
    for seed in args.seeds:
        t0 = time.time()
        work = workloads.generate(cell.config, seed)
        T = workloads.prefix_time(cell.config, cell.traffic, work)
        sweep = program.Sweep(cell.config, cell.traffic, work, args.device)
        state, _stats = sweep.run(sweep.configs(T))
        got = check.answers(state, work)
        del sweep, state
        t1 = time.time()
        want = check.reference_answers(cell.config, work, lanes, T, args.device)
        t2 = time.time()
        ctrl = check.reference_answers(cell.config, work, lanes, T, args.device,
                                       scale=check.UNBOUNDED)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "sound": readings(got, want),
            "control": readings(ctrl, want),
            "faults": {k: readings(v, want) for k, v in faults(lanes, got).items()},
            "seconds": {"program": t1 - t0, "reference": t2 - t1,
                        "control": time.time() - t2},
            "lanes": ["%s@%s" % lane for lane in lanes],
            "program": [[r.tuples, r.io_bytes, r.sim_s] for r in got],
            "reference": [[r.tuples, r.io_bytes, r.sim_s] for r in want],
        }), flush=True)


if __name__ == "__main__":
    main()
