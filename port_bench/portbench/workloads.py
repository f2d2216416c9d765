"""The benchmark's workload generator: the scan streams of a configuration,
drawn from the run's seed.

A frozen copy of the generators of ``src/repro_torch/core/workload.py``
at commit 7b98c78 (``make_lineitem_db``, ``micro_query``,
``micro_streams``, ``micro_accessed_bytes``; ``make_tpch_db``,
``_template_specs``, ``tpch_streams``, ``tpch_accessed_bytes``), with the
constants read from the configuration's file instead of the module: the
same seed and the same file draw the same queries, in the same order of
random draws.  It builds the reference's own page model
(:mod:`portbench.reference.pages`); the program gets the same tables and
scans through :func:`portbench.program.to_program`.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List

from .reference.pages import Database
from .reference.scans import ScanSpec


@dataclass
class Workload:
    """What a configuration and a seed make: the database, every stream's
    scans in order, and the accessed bytes that size the pools."""

    db: Database
    streams: List[List[ScanSpec]]
    accessed_bytes: int


def _chunk_tuples(cfg: dict, n_tuples: int) -> int:
    return max(int(cfg["chunk_tuples_min"]), n_tuples // int(cfg["chunks_per_table"]))


def _micro(cfg: dict, seed: int) -> Workload:
    db = Database()
    n = int(cfg["n_tuples"])
    table = db.add_table(cfg["table"], n_tuples=n, columns=dict(cfg["columns"]),
                         chunk_tuples=_chunk_tuples(cfg, n),
                         page_bytes=int(cfg["page_bytes"]))
    q1, q6 = tuple(cfg["q1_columns"]), tuple(cfg["q6_columns"])
    fracs = [float(f) for f in cfg["range_fractions"]]
    rng = random.Random(seed)

    def query(stream: int) -> ScanSpec:
        frac = rng.choice(fracs)
        length = max(1, int(table.n_tuples * frac))
        start = rng.randrange(0, max(1, table.n_tuples - length + 1))
        if rng.random() < 0.5:
            cols, rate = q1, float(cfg["q1_rate"])
        else:
            cols, rate = q6, float(cfg["q6_rate"])
        return ScanSpec(table=table.name, columns=cols,
                        ranges=((start, start + length),), tuple_rate=rate,
                        stream=stream)

    streams = [[query(s) for _ in range(int(cfg["queries_per_stream"]))]
               for s in range(int(cfg["n_streams"]))]
    accessed = table.total_bytes(sorted(set(q1) | set(q6)))
    return Workload(db, streams, accessed)


def _tpch(cfg: dict, seed: int) -> Workload:
    db = Database()
    for name, tuples, cols in cfg["tables"]:
        n = max(1, int(tuples))
        db.add_table(name, n_tuples=n, columns=dict(cols),
                     chunk_tuples=_chunk_tuples(cfg, n),
                     page_bytes=int(cfg["page_bytes"]))
    templates = cfg["queries"]
    rng = random.Random(seed)
    streams: List[List[ScanSpec]] = []
    base = list(range(len(templates)))
    for s in range(int(cfg["n_streams"])):
        order = base[s % len(base):] + base[: s % len(base)]
        rng.shuffle(order)
        specs: List[ScanSpec] = []
        for qi in order:
            table, n_cols, frac, rate, extra = templates[qi]
            for tname, ncols, tfrac in [(table, n_cols, frac), *extra]:
                t = db.tables[tname]
                cols = tuple(sorted(t.columns.keys())[:int(ncols)])
                length = max(1, int(t.n_tuples * float(tfrac)))
                start = rng.randrange(0, max(1, t.n_tuples - length + 1))
                specs.append(ScanSpec(table=tname, columns=cols,
                                      ranges=((start, start + length),),
                                      tuple_rate=float(rate), stream=s))
        streams.append(specs)
    seen, accessed = set(), 0
    for stream in streams:
        for spec in stream:
            t = db.tables[spec.table]
            for c in spec.columns:
                for a, b in spec.ranges:
                    for p in t.columns[c].pages_for_range(a, b):
                        if p.pid not in seen:
                            seen.add(p.pid)
                            accessed += p.size_bytes
    return Workload(db, streams, accessed)


GENERATORS = {"micro": _micro, "tpch": _tpch}


def generate(cfg: dict, seed: int) -> Workload:
    """The workload of configuration ``cfg`` (its file's contents) at
    ``seed``."""
    return GENERATORS[cfg["generator"]](cfg, int(seed))


def prefix_time(cfg: dict, traffic: dict, work: Workload) -> float:
    """The simulated time every lane of a prefix sweep runs to: the time
    the I/O server needs to load the accessed bytes ``prefix_loads``
    times."""
    return float(traffic["prefix_loads"]) * work.accessed_bytes / float(cfg["bandwidth"])
