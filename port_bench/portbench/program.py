"""The system under test: the port's batched simulator, driven through its
public entry points (``compile_workload``, ``make_config`` /
``stack_configs``, ``make_runner``).

Everything of the program that the benchmark touches is here; the rest of
the harness reads only what :class:`Sweep` hands back: the runner's step
counts and the final state, whose ``qidx``, ``pos``, ``t`` and
``io_bytes`` the check reads (:func:`portbench.check.answers`).
"""

from __future__ import annotations

from typing import List, Tuple

from .workloads import Workload


def to_program(work: Workload):
    """The same tables and scans in the program's own types."""
    from repro_torch.core.pages import Database
    from repro_torch.core.scans import ScanSpec

    db = Database()
    for t in work.db.tables.values():
        db.add_table(t.name, n_tuples=t.n_tuples,
                     columns={c.name: c.bytes_per_tuple for c in t.columns.values()},
                     chunk_tuples=t.chunk_tuples, page_bytes=t.page_bytes)
    streams = [[ScanSpec(table=s.table, columns=tuple(s.columns),
                         ranges=tuple(s.ranges), tuple_rate=s.tuple_rate,
                         stream=s.stream) for s in stream]
               for stream in work.streams]
    return db, streams


def lanes(traffic: dict) -> List[Tuple[str, float]]:
    """The sweep's lanes, policy-major: ``(policy, pool fraction)``."""
    return [(p, float(f)) for p in traffic["policies"] for f in traffic["fractions"]]


class Sweep:
    """One runner over every lane of a cell, built once in set-up."""

    def __init__(self, cfg: dict, traffic: dict, work: Workload, device):
        from repro_torch.core.array_sim import (
            compile_workload, make_config, make_runner, stack_configs)

        self.device = device
        self.lanes = lanes(traffic)
        db, streams = to_program(work)
        self.spec = compile_workload(db, streams)
        self.runner = make_runner(
            self.spec, bandwidth_ref=float(cfg["bandwidth"]),
            time_slice=float(cfg["time_slice"]), policies=tuple(traffic["policies"]),
            stepper=traffic["stepper"], wake_exact=bool(cfg["wake_exact"]),
            device=device)
        bw = float(cfg["bandwidth"])

        def configs(max_time: float):
            return stack_configs([
                make_config(self.spec, int(f * work.accessed_bytes), bw, p,
                            max_time=max_time, device=device)
                for p, f in self.lanes])
        self.configs = configs

    def run(self, cfgs):
        """One prefix sweep: every lane from t = 0 to its ``max_time``.
        Returns the final state (on the device) and the runner's step
        counts of this run."""
        state = self.runner(cfgs)
        return state, dict(self.runner.stats)
