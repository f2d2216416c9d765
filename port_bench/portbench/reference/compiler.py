"""Workload compiler: lower ANY event-engine workload to the array sim.

A frozen copy of ``src/repro_torch/core/array_sim/compiler.py`` at
commit 7b98c78.

Own copy of the JAX package's ``repro.core.array_sim.compiler`` (numpy
only; the port imports nothing from that package).  This module is the
general lowering — the one place that turns the event engine's object
world (a :class:`~repro_torch.core.pages.Database` of several tables, streams
whose queries name different tables and column sets, qgen-style rotated
permutations) into the fixed-shape dense arrays the batched step consumes:

* **global page indexing** — pages of every referenced (table, column)
  pair are laid out contiguously in one global id space; ``col_start``
  records each column's offset so the existing one-divide cursor→page
  mapping (``floor(cur / col_tpp) + col_start``) generalizes unchanged.
* **global column axis** — the per-query column mask ``q_cols`` spans the
  union of all referenced tables' columns.  A query's mask only ever
  selects columns of its own table, so every per-column computation in
  the step (frontier cursors, advance limits, next-consumption estimates)
  is automatically restricted to the query's table: the step needs no
  explicit table id.  Tuple coordinates stay *per table* — a cursor is a
  position in the current query's table, and pages of other tables are
  masked out before their (meaningless) local indices matter.
* **per-query rows** — each :class:`~repro_torch.core.scans.ScanSpec` becomes
  one ``(table, start, len, rate, column-mask)`` row; a TPC-H template
  that expands to several table scans contributes several consecutive
  rows of its stream, exactly like the event engine runs them.

Tables never referenced by any query are left out of the page space (they
would only pad every per-page array).  The single-table lowering is the
degenerate case: ``build_spec`` delegates here after its one-table
check, so there is exactly one lowering in the package
(``tests/test_torch_compiler.py`` pins array-for-array agreement with
the JAX package's compiler).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .pages import Database
from .scans import ScanSpec
from .spec import PAGE_PAD, SimSpec


def referenced_tables(db: Database, streams: Sequence[Sequence[ScanSpec]],
                      ) -> List[str]:
    """Tables named by at least one query, in ``db.tables`` order (the
    deterministic global layout order of the compiled page space)."""
    used = {s.table for stream in streams for s in stream}
    missing = used - set(db.tables)
    if missing:
        raise ValueError(f"streams reference unknown tables: {sorted(missing)}")
    return [t for t in db.tables if t in used]


def compile_workload(
    db: Database,
    streams: Sequence[Sequence[ScanSpec]],
    n_groups: int = 10,
    buckets_per_group: int = 4,
    tables: Optional[Sequence[str]] = None,
) -> SimSpec:
    """Lower a multi-table workload into a :class:`SimSpec`.

    ``tables`` overrides the compiled table set (default: the tables the
    streams reference).  Every column of every compiled table enters the
    global page space — untouched columns cost padding only, and keeping
    them makes the single-table output bit-identical to the seed
    ``build_spec`` arrays.
    """
    tnames = list(tables) if tables is not None \
        else referenced_tables(db, streams)
    if not tnames:
        raise ValueError("empty workload: no stream references any table")

    # ---- global column axis: (table, column) pairs in layout order -------
    tindex = {t: i for i, t in enumerate(tnames)}
    col_names: List[Tuple[str, str]] = []   # (table, column)
    for tname in tnames:
        for cname in db.tables[tname].columns:
            col_names.append((tname, cname))
    cindex: Dict[Tuple[str, str], int] = {
        tc: i for i, tc in enumerate(col_names)
    }
    C = len(col_names)

    # ---- per-page constants with per-column global offsets ---------------
    sizes: List[float] = []
    firsts: List[float] = []
    lasts: List[float] = []
    pcols: List[int] = []
    page_rows: List[Tuple[int, float]] = []   # (table idx, first tuple)
    col_start = np.zeros(C, np.int32)
    col_npages = np.zeros(C, np.int32)
    col_tpp = np.zeros(C, np.float32)
    col_ntuples = np.zeros(C, np.float32)
    col_table = np.zeros(C, np.int32)
    off = 0
    for ci, (tname, cname) in enumerate(col_names):
        table = db.tables[tname]
        col = table.columns[cname]
        if not col.pages:
            raise ValueError(
                f"column {table.name}.{cname} has zero pages; every column "
                "needs at least one page to define its tuples-per-page grid "
                "(re-run Column.build_pages or drop the column)"
            )
        col_start[ci] = off
        col_npages[ci] = len(col.pages)
        col_tpp[ci] = col.n_tuples / len(col.pages)
        col_ntuples[ci] = float(table.n_tuples)
        col_table[ci] = tindex[tname]
        for p in col.pages:
            sizes.append(p.size_bytes)
            firsts.append(p.first_tuple)
            lasts.append(p.last_tuple)
            pcols.append(ci)
            page_rows.append((tindex[tname], p.first_tuple))
        off += len(col.pages)

    P = ((off + PAGE_PAD - 1) // PAGE_PAD) * PAGE_PAD
    pad = P - off
    page_size = np.asarray(sizes + [0] * pad, np.float32)
    page_first = np.asarray(firsts + [0] * pad, np.float32)
    page_last = np.asarray(lasts + [0] * pad, np.float32)
    page_col = np.asarray(pcols + [0] * pad, np.int32)
    page_valid = np.asarray([True] * off + [False] * pad, bool)

    # ---- chunk geometry (the cooperative substrate's unit) ---------------
    from .coop import chunk_geometry

    n_chunks, chunk_first, chunk_last, chunk_table, page_chunk0 = \
        chunk_geometry(db, tnames, page_rows)
    page_chunk = np.zeros(P, np.int32)
    page_chunk[:off] = page_chunk0

    # ---- per-stream query rows -------------------------------------------
    S = len(streams)
    Q = max(len(s) for s in streams)
    q_start = np.zeros((S, Q), np.float32)
    q_len = np.ones((S, Q), np.float32)
    q_rate = np.full((S, Q), 1.0, np.float32)
    q_cols = np.zeros((S, Q, C), bool)
    q_table = np.zeros((S, Q), np.int32)
    n_q = np.zeros(S, np.int32)
    # per-column trigger geometry for the event-horizon stepper: the
    # fastest rate that can ever advance a cursor over this column bounds
    # how many of its page triggers one macro-step can cross
    col_max_rate = np.zeros(C, np.float32)
    for si, stream in enumerate(streams):
        n_q[si] = len(stream)
        for qi, spec in enumerate(stream):
            if len(spec.ranges) != 1:
                raise ValueError("array backend supports single-range scans")
            if spec.table not in tindex:
                raise ValueError(
                    f"query table {spec.table!r} is not in the compiled "
                    f"table set {tnames} (tables= override too narrow?)"
                )
            a, b = spec.ranges[0]
            q_start[si, qi] = a
            q_len[si, qi] = b - a
            q_rate[si, qi] = spec.tuple_rate
            q_table[si, qi] = tindex[spec.table]
            for c in spec.columns:
                key = (spec.table, c)
                if key not in cindex:
                    raise ValueError(
                        f"query column {spec.table}.{c} is not in the "
                        f"compiled table set {tnames}"
                    )
                ci = cindex[key]
                q_cols[si, qi, ci] = True
                col_max_rate[ci] = max(col_max_rate[ci],
                                       float(spec.tuple_rate))

    return SimSpec(
        n_pages=P,
        n_streams=S,
        n_queries=Q,
        n_cols=C,
        n_groups=n_groups,
        buckets_per_group=buckets_per_group,
        page_size=page_size,
        page_first=page_first,
        page_last=page_last,
        page_col=page_col,
        page_valid=page_valid,
        col_start=col_start,
        col_npages=col_npages,
        col_tpp=col_tpp,
        col_ntuples=col_ntuples,
        q_start=q_start,
        q_len=q_len,
        q_rate=q_rate,
        q_cols=q_cols,
        n_q=n_q,
        n_tables=len(tnames),
        table_names=tuple(tnames),
        col_table=col_table,
        q_table=q_table,
        n_chunks=n_chunks,
        page_chunk=page_chunk,
        chunk_first=chunk_first,
        chunk_last=chunk_last,
        chunk_table=chunk_table,
        col_max_rate=col_max_rate,
    )
