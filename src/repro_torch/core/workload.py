"""Workload generators reproducing the paper's §4 evaluation setups.

**Microbenchmark** (paper §4.1): TPC-H Q1/Q6-style range scans over
``lineitem`` at SF30 (~180M tuples).  Queries are parameterised with a tuple
range starting at a random position; range length drawn from
{1%, 10%, 50%, 100%} of the table.  1–32 concurrent streams of 16-query
batches.  The accessed column set is Q1's / Q6's; per-column compressed
byte widths are sized so the total accessed volume is ~1550 MB, matching
the paper's default operating point (buffer = 40% of that, 700 MB/s I/O,
8 streams).

**TPC-H throughput** (paper §4.2): 8 tables / 61 columns, 22 query
templates of varying CPU intensity touching different tables/columns;
streams are rotated permutations (qgen-style).  Default operating point:
buffer 2250 MB = 30% of the ~7500 MB accessed by 8 streams, 600 MB/s.

CPU rates are calibrated so the LRU system turns CPU-bound at the paper's
crossover points (micro: ≥80% buffer at 700 MB/s; TPC-H: ≥1200 MB/s) —
absolute times differ from the paper's 2009 hardware, trend shapes are the
reproduction target (see EXPERIMENTS.md).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .pages import Database, Table
from .scans import ScanSpec

# ---------------------------------------------------------------------------
# Microbenchmark: lineitem @ SF30
# ---------------------------------------------------------------------------

LINEITEM_TUPLES = 180_000_000  # SF30
# Compressed bytes/tuple for the Q1/Q6 column set, scaled so the union
# accessed volume is ~1550MB (paper §4.1).
LINEITEM_COLUMNS: Dict[str, float] = {
    "l_quantity": 1.0,
    "l_extendedprice": 2.4,
    "l_discount": 0.7,
    "l_tax": 0.7,
    "l_returnflag": 0.3,
    "l_linestatus": 0.3,
    "l_shipdate": 1.6,
    "l_orderkey": 1.6,
}

Q1_COLUMNS = (
    "l_quantity",
    "l_extendedprice",
    "l_discount",
    "l_tax",
    "l_returnflag",
    "l_linestatus",
    "l_shipdate",
)
Q6_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate")

# tuples/sec when CPU-bound, 8-way intra-query parallelism folded in.
# Q1 does ~2x the per-tuple work of Q6 (aggregates 8 expressions vs 1).
Q1_RATE = 120e6
Q6_RATE = 240e6


def make_lineitem_db(
    scale_tuples: int = LINEITEM_TUPLES,
    page_bytes: int = 512 << 10,
    chunk_tuples: Optional[int] = None,
) -> Database:
    if chunk_tuples is None:
        # ~90 chunks regardless of scale (SF30 -> the paper-ish 2M tuples)
        chunk_tuples = max(20_000, scale_tuples // 90)
    db = Database()
    db.add_table(
        "lineitem",
        n_tuples=scale_tuples,
        columns=LINEITEM_COLUMNS,
        chunk_tuples=chunk_tuples,
        page_bytes=page_bytes,
    )
    return db


def micro_query(
    table: Table,
    rng: random.Random,
    fraction: Optional[float] = None,
    stream: int = 0,
) -> ScanSpec:
    """One microbenchmark query: Q1 or Q6 over a random range."""
    frac = fraction if fraction is not None else rng.choice([0.01, 0.1, 0.5, 1.0])
    length = max(1, int(table.n_tuples * frac))
    start = rng.randrange(0, max(1, table.n_tuples - length + 1))
    if rng.random() < 0.5:
        cols, rate = Q1_COLUMNS, Q1_RATE
    else:
        cols, rate = Q6_COLUMNS, Q6_RATE
    return ScanSpec(
        table=table.name,
        columns=cols,
        ranges=((start, start + length),),
        tuple_rate=rate,
        stream=stream,
    )


def micro_streams(
    db: Database,
    n_streams: int = 8,
    queries_per_stream: int = 16,
    fraction: Optional[float] = None,
    seed: int = 42,
) -> List[List[ScanSpec]]:
    table = db.tables["lineitem"]
    rng = random.Random(seed)
    return [
        [
            micro_query(table, rng, fraction=fraction, stream=s)
            for _ in range(queries_per_stream)
        ]
        for s in range(n_streams)
    ]


def micro_accessed_bytes(db: Database) -> int:
    """Upper bound of the microbenchmark working set (all Q1∪Q6 columns)."""
    t = db.tables["lineitem"]
    cols = sorted(set(Q1_COLUMNS) | set(Q6_COLUMNS))
    return t.total_bytes(cols)


# ---------------------------------------------------------------------------
# TPC-H-like throughput run
# ---------------------------------------------------------------------------

# (table, tuples@SF30, {column: bytes/tuple}) — 8 tables, 61 columns total,
# compressed widths chosen to give TPC-H-like relative sizes.
_TPCH_TABLES: List[Tuple[str, int, Dict[str, float]]] = [
    ("lineitem", 180_000_000, {f"l_c{i}": w for i, w in enumerate(
        [1.0, 2.4, 0.7, 0.7, 0.3, 0.3, 1.6, 1.6, 2.0, 1.2, 1.6, 1.6, 0.8, 0.8, 2.8, 1.0])}),
    ("orders", 45_000_000, {f"o_c{i}": w for i, w in enumerate(
        [1.6, 1.2, 0.3, 2.4, 1.6, 1.0, 0.8, 2.6, 0.6])}),
    ("partsupp", 24_000_000, {f"ps_c{i}": w for i, w in enumerate(
        [1.6, 1.6, 1.2, 2.4, 3.0])}),
    ("part", 6_000_000, {f"p_c{i}": w for i, w in enumerate(
        [1.6, 3.2, 1.0, 1.0, 1.2, 0.8, 1.0, 2.4, 2.8])}),
    ("customer", 4_500_000, {f"c_c{i}": w for i, w in enumerate(
        [1.6, 2.6, 2.8, 0.6, 1.8, 2.4, 0.8, 2.8])}),
    ("supplier", 300_000, {f"s_c{i}": w for i, w in enumerate(
        [1.6, 2.4, 2.8, 0.6, 1.8, 2.4, 2.8])}),
    ("nation", 25, {f"n_c{i}": w for i, w in enumerate([4.0, 16.0, 4.0, 32.0])}),
    ("region", 5, {f"r_c{i}": w for i, w in enumerate([4.0, 16.0, 32.0])}),
]


@dataclass
class _QueryTemplate:
    table: str
    n_cols: int           # leading columns touched
    fraction: float       # of the table scanned
    rate: float           # tuples/sec (CPU intensity)
    extra_tables: Tuple[Tuple[str, int, float], ...] = ()  # joins: (table, cols, frac)


# 22 templates with TPC-H-flavoured access patterns: lineitem-heavy,
# CPU-intensive, some dimension lookups; rates in tuples/s.
_TPCH_QUERIES: List[_QueryTemplate] = [
    _QueryTemplate("lineitem", 7, 0.98, 60e6),                                  # Q1
    _QueryTemplate("partsupp", 4, 0.8, 40e6, (("part", 3, 0.2), ("supplier", 4, 1.0))),  # Q2
    _QueryTemplate("lineitem", 4, 0.54, 80e6, (("orders", 4, 0.5), ("customer", 2, 0.2))),  # Q3
    _QueryTemplate("orders", 3, 0.4, 70e6, (("lineitem", 3, 0.4),)),             # Q4
    _QueryTemplate("lineitem", 3, 0.6, 70e6, (("orders", 3, 0.6), ("customer", 3, 1.0), ("supplier", 3, 1.0))),  # Q5
    _QueryTemplate("lineitem", 4, 0.45, 120e6),                                  # Q6
    _QueryTemplate("lineitem", 5, 0.6, 60e6, (("supplier", 2, 1.0), ("orders", 2, 0.6))),  # Q7
    _QueryTemplate("lineitem", 4, 0.35, 60e6, (("part", 2, 0.1), ("orders", 3, 0.5))),     # Q8
    _QueryTemplate("lineitem", 6, 0.9, 50e6, (("part", 3, 0.3), ("partsupp", 3, 0.6))),    # Q9
    _QueryTemplate("lineitem", 4, 0.25, 80e6, (("orders", 4, 0.3), ("customer", 6, 1.0))), # Q10
    _QueryTemplate("partsupp", 4, 1.0, 60e6, (("supplier", 2, 1.0),)),           # Q11
    _QueryTemplate("lineitem", 5, 0.3, 90e6, (("orders", 2, 0.3),)),             # Q12
    _QueryTemplate("orders", 3, 1.0, 50e6, (("customer", 1, 1.0),)),             # Q13
    _QueryTemplate("lineitem", 4, 0.08, 110e6, (("part", 2, 0.6),)),             # Q14
    _QueryTemplate("lineitem", 4, 0.25, 100e6, (("supplier", 3, 1.0),)),         # Q15
    _QueryTemplate("partsupp", 3, 0.9, 70e6, (("part", 4, 0.5),)),               # Q16
    _QueryTemplate("lineitem", 3, 0.15, 90e6, (("part", 2, 0.05),)),             # Q17
    _QueryTemplate("lineitem", 3, 0.95, 60e6, (("orders", 3, 0.9), ("customer", 2, 0.4))), # Q18
    _QueryTemplate("lineitem", 5, 0.12, 90e6, (("part", 4, 0.15),)),             # Q19
    _QueryTemplate("lineitem", 3, 0.4, 80e6, (("partsupp", 3, 0.5), ("part", 2, 0.2))),    # Q20
    _QueryTemplate("lineitem", 4, 0.7, 55e6, (("orders", 2, 0.7), ("supplier", 3, 1.0))),  # Q21
    _QueryTemplate("customer", 4, 1.0, 80e6, (("orders", 2, 0.5),)),             # Q22
]


def make_tpch_db(
    scale: float = 1.0,
    page_bytes: int = 512 << 10,
    chunk_tuples: Optional[int] = None,
) -> Database:
    db = Database()
    for name, tuples, cols in _TPCH_TABLES:
        n = max(1, int(tuples * scale))
        db.add_table(
            name,
            n_tuples=n,
            columns=cols,
            chunk_tuples=chunk_tuples or max(10_000, n // 90),
            page_bytes=page_bytes,
        )
    return db


def _template_specs(
    db: Database, q: _QueryTemplate, rng: random.Random, stream: int
) -> List[ScanSpec]:
    """One query = one scan per touched table (plan leaves)."""
    out = []
    parts: List[Tuple[str, int, float]] = [(q.table, q.n_cols, q.fraction)]
    parts += list(q.extra_tables)
    for tname, ncols, frac in parts:
        t = db.tables[tname]
        cols = tuple(sorted(t.columns.keys())[:ncols])
        length = max(1, int(t.n_tuples * frac))
        start = rng.randrange(0, max(1, t.n_tuples - length + 1))
        out.append(
            ScanSpec(
                table=tname,
                columns=cols,
                ranges=((start, start + length),),
                tuple_rate=q.rate,
                stream=stream,
            )
        )
    return out


def tpch_streams(
    db: Database,
    n_streams: int = 8,
    seed: int = 7,
) -> List[List[ScanSpec]]:
    """qgen-style rotated permutations of the 22 templates; every query may
    expand to several table scans, run back-to-back within the stream."""
    rng = random.Random(seed)
    base = list(range(len(_TPCH_QUERIES)))
    streams: List[List[ScanSpec]] = []
    for s in range(n_streams):
        order = base[s % len(base):] + base[: s % len(base)]
        rng.shuffle(order)
        specs: List[ScanSpec] = []
        for qi in order:
            specs.extend(_template_specs(db, _TPCH_QUERIES[qi], rng, s))
        streams.append(specs)
    return streams


def tpch_accessed_bytes(db: Database, streams: Sequence[Sequence[ScanSpec]]) -> int:
    """Unique bytes touched by the given streams (the '100%' reference)."""
    seen = set()
    total = 0
    for stream in streams:
        for spec in stream:
            t = db.tables[spec.table]
            for c in spec.columns:
                for a, b in spec.ranges:
                    for p in t.columns[c].pages_for_range(a, b):
                        if p.pid not in seen:
                            seen.add(p.pid)
                            total += p.size_bytes
    return total
