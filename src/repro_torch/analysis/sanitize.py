"""Runtime half of the contract checker: the sanitized smoke sweep.

Counterpart of the JAX package's ``repro.analysis.sanitize``, at the same
points: the micro workload at 4 M tuples (2 streams x 2 queries, seed 3)
and TPC-H at scale 0.02 (2 streams, seed 7), each with a buffer of 0.4 of
its accessed set at 700 MB/s.  For each point and each stepper one
``make_runner(sanitize=True)`` runs the whole sweep of every array policy
(one lane each, one batched call) and the smoke requires:

* no sanitizer error (no NaN in any float leaf of the carry or any float
  row handed to B1-B3, no index leaf outside its extent);
* one config signature per runner (``runner.trace_count() == 1``);
* no truncated lane (the livelock guard firing at a known-good point
  means the sanitized step diverged from the plain one).

It also reports, per lane, how many of the keys handed to B1 were -0.0:
B1's oracle and the Pallas body order -0.0 and +0.0 differently, so a
policy that produces -0.0 is where the two would disagree.

``python -m repro_torch.analysis --sanitize-smoke`` runs it (on ``cuda``
unless ``--device`` says otherwise).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

__all__ = ["sanitize_smoke"]

#: buffer fraction of the accessed set at the smoke points
_BUFFER_FRAC = 0.4
_BANDWIDTH = 700e6


def _smoke_points():
    """``[(name, db, streams, capacity_bytes)]``: the JAX package's two
    sanitize points."""
    from ..core.workload import (
        make_lineitem_db, make_tpch_db, micro_accessed_bytes, micro_streams,
        tpch_accessed_bytes, tpch_streams,
    )

    db = make_lineitem_db(scale_tuples=4_000_000)
    streams = micro_streams(db, n_streams=2, queries_per_stream=2, seed=3)
    tdb = make_tpch_db(scale=0.02)
    tstreams = tpch_streams(tdb, n_streams=2, seed=7)
    return [
        ("micro", db, streams, _BUFFER_FRAC * micro_accessed_bytes(db)),
        ("tpch", tdb, tstreams,
         _BUFFER_FRAC * tpch_accessed_bytes(tdb, tstreams)),
    ]


def sanitize_smoke(
    steppers: Sequence[str] = ("fixed", "horizon"),
    policies: Optional[Sequence[str]] = None,
    log: Optional[Callable[[str], None]] = print,
    device="cuda",
    rows: Optional[list] = None,
) -> List[str]:
    """Run the sanitized smoke sweep; returns a list of failure strings
    (empty = clean).  ``policies`` defaults to every registered array
    policy.  ``rows``, when given, receives one dict per (point, stepper):
    its steps, lanes, signatures, seconds and -0.0 counts per policy."""
    import torch

    from ..core import policy_registry
    from ..core.array_sim import (
        compile_workload, make_config, make_runner, result_from_state,
        stack_configs,
    )
    from ..core.array_sim.convert import resolve_device

    dev = resolve_device(device)
    if policies is None:
        policies = policy_registry.names(backend="array")
    failures: List[str] = []
    for wl_name, db, streams, capacity in _smoke_points():
        spec = compile_workload(db, streams)
        for stepper in steppers:
            tag = f"{wl_name}/{stepper}"
            runner = make_runner(spec, bandwidth_ref=_BANDWIDTH,
                                 stepper=stepper, sanitize=True, device=dev)
            cfgs = stack_configs([
                make_config(spec, capacity, _BANDWIDTH, p, device=dev)
                for p in policies])
            t0 = time.perf_counter()
            try:
                state = runner(cfgs)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            except Exception as exc:  # noqa: BLE001 — report, keep going
                failures.append(f"{tag}: {type(exc).__name__}: {exc}")
                continue
            wall = time.perf_counter() - t0
            neg_zero = runner.stats["neg_zero_keys"]
            lanes = []
            for i, pol in enumerate(policies):
                res = result_from_state(state, pol, dt_ref=runner.dt_ref,
                                        lane=i)
                if res.extras["truncated"]:
                    failures.append(
                        f"{tag}/{pol}: truncated "
                        f"({res.extras['unfinished_streams']} unfinished)")
                lanes.append({"policy": pol, "steps": res.steps,
                              "truncated": res.extras["truncated"],
                              "neg_zero_keys": neg_zero[i]})
                if log is not None:
                    log(f"  {tag}/{pol}: {res.steps} steps, "
                        f"{res.total_io_bytes / 1e9:.2f} GB io, "
                        f"{neg_zero[i]} B1 keys of -0.0")
            traces = runner.trace_count()
            if traces != 1:
                failures.append(
                    f"{tag}: {traces} config signatures for one "
                    f"{len(policies)}-policy sweep (expected exactly 1)")
            if rows is not None:
                rows.append({
                    "point": wl_name, "stepper": stepper,
                    "batched_steps": (runner.stats["cheap_steps"]
                                      + runner.stats["refresh_steps"]),
                    "host_reads": runner.stats["host_reads"],
                    "signatures": traces, "seconds": wall, "lanes": lanes})
    return failures
