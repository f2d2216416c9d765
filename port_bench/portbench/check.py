"""What decides ``correct``: each lane of each prefix sweep against the
plain reference (:mod:`portbench.reference`, the simulator's horizon
stepper frozen in plain PyTorch), run once after the window on the same
tables, scans, pools, bandwidth and prefix, on the same device.

Two numbers are compared, each the largest over every lane of every
sweep in the window.  ``tuples_err``: the relative gap between the tuples
the lane's streams consumed by its end and the reference lane's (the
lane's progress: what every policy decision and B1-B3's grants and
evictions come to).  ``io_err``: the relative gap between the bytes the
lane loaded and the reference lane's (the paper's I/O volume).  A third,
``short_s``, is how far any lane ended short of the prefix time (limit
0).  The limit of each cell is in ``limits/<cell>.json``, with the
readings it was set from.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import reference, workloads

#: the numbers compared against a limit, besides ``short_s``
NUMBERS = ("tuples_err", "io_err")


@dataclass
class LaneResult:
    """One lane's answer, as the comparison reads it."""

    sim_s: float          # the lane's simulated clock at its end
    io_bytes: float       # bytes the lane's I/O server loaded
    tuples: float         # tuples consumed over all its streams


def answers(state, work: workloads.Workload) -> List[LaneResult]:
    """Each lane's answer from a final state (the program's or the
    reference's: the fields ``qidx``, ``pos``, ``t`` and ``io_bytes``):
    the tuples of the queries a stream has finished plus its cursor in
    the current one."""
    n_q = np.array([len(s) for s in work.streams])
    lens = np.zeros((len(work.streams), n_q.max() + 1))
    for i, s in enumerate(work.streams):
        lens[i, 1:len(s) + 1] = [spec.total_tuples for spec in s]
    before = np.cumsum(lens, axis=1)           # tuples before query q
    qidx = state.qidx.cpu().numpy()
    pos = state.pos.double().cpu().numpy()
    t = state.t.double().cpu().numpy()
    io = state.io_bytes.double().cpu().numpy()
    out = []
    for i in range(qidx.shape[0]):
        q = np.minimum(qidx[i], n_q)
        done = before[np.arange(len(q)), q]
        tuples = float(np.sum(done + np.where(q < n_q, pos[i], 0.0)))
        out.append(LaneResult(float(t[i]), float(io[i]), tuples))
    return out


def lane_bytes(lanes: Sequence[Tuple[str, float]], accessed: int,
               scale: float = 1.0) -> List[Tuple[str, int]]:
    """Each lane's ``(policy, pool bytes)``: its fraction of the accessed
    bytes, times ``scale``."""
    return [(p, int(f * scale * accessed)) for p, f in lanes]


def reference_answers(cfg: dict, work: workloads.Workload,
                      lanes: Sequence[Tuple[str, float]], max_time: float,
                      device, scale: float = 1.0) -> List[LaneResult]:
    """The reference's answer of each lane, every lane run to
    ``max_time``; ``scale`` multiplies every pool."""
    state = reference.sweep(
        work.db, work.streams, lane_bytes(lanes, work.accessed_bytes, scale),
        float(cfg["bandwidth"]), float(cfg["time_slice"]), max_time, device)
    return answers(state, work)


#: the control's pool, as a multiple of each lane's: one no sweep fills,
#: so nothing is ever evicted
UNBOUNDED = 1e6


def gaps(got: Sequence[LaneResult], want: Sequence[LaneResult]) -> Dict[str, List[float]]:
    """Each lane's relative gap, per number compared."""
    def rel(g, w):
        return abs(g - w) / max(abs(w), 1.0)
    return {"tuples_err": [rel(g.tuples, w.tuples) for g, w in zip(got, want)],
            "io_err": [rel(g.io_bytes, w.io_bytes) for g, w in zip(got, want)]}


def worst(got: Sequence[LaneResult], want: Sequence[LaneResult]) -> Dict[str, Tuple[float, int]]:
    """Per number compared, the largest gap over lanes and its lane."""
    out = {}
    for name, g in gaps(got, want).items():
        i = max(range(len(g)), key=g.__getitem__)
        out[name] = (g[i], i)
    return out
