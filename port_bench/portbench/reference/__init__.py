"""The benchmark's plain reference: the batched simulator's horizon
stepper in plain PyTorch, frozen.

A frozen copy of the program's batched simulator at commit 7b98c78
(``src/repro_torch/core/array_sim/{sim,policies,coop,spec,compiler}.py``
and the plain B1-B3 of ``kernels/ref.py``), cut to the horizon stepper
the cells run, with B1-B3 in plain PyTorch and the loop nest written out
eagerly (no CUDA graph, no kernel of the program).  It imports nothing
of the program, lowers the benchmark's own tables and scans itself
(:func:`.compiler.compile_workload`) and runs the lanes of a sweep, as
the measured runner does, from t = 0 to the prefix time.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from .compiler import compile_workload
from .pages import Database
from .scans import ScanSpec
from .sim import SimState, make_config, run, stack_configs

__all__ = ["Database", "ScanSpec", "SimState", "sweep"]


def sweep(db: Database, streams: Sequence[Sequence[ScanSpec]],
          lanes: Sequence[Tuple[str, int]], bandwidth: float,
          time_slice: float, max_time: float, device) -> SimState:
    """The final state of a sweep whose lane ``i`` runs policy
    ``lanes[i][0]`` with a pool of ``lanes[i][1]`` bytes, every lane from
    t = 0 to ``max_time``."""
    spec = compile_workload(db, streams)
    cfg = stack_configs([make_config(spec, float(cap), bandwidth, policy,
                                     max_time, device)
                         for policy, cap in lanes])
    policies = tuple(dict.fromkeys(policy for policy, _cap in lanes))
    return run(spec, cfg, policies, bandwidth, time_slice, device)
