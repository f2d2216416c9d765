"""Cooperative-scan (array-CScan) substrate: host geometry only, so far.

The chunk-granular ABM substrate of the JAX package
(``repro.core.array_sim.coop``: per-(stream, chunk) consumption state,
the choose-chunk / choose-scan relevance loop, chunk-at-a-time loads) is
still to port.  This module keeps the one host-numpy function the
workload compiler calls, so a compiled :class:`SimSpec` carries the same
chunk geometry in both packages.
"""

from __future__ import annotations

import numpy as np


def chunk_geometry(db, tnames, page_rows):
    """Compiler helper: global chunk ids for the compiled tables.

    Returns ``(n_chunks, chunk_first, chunk_last, chunk_table,
    page_chunk)`` where ``page_rows`` is the compiled page list as
    ``(table_index, first_tuple)`` pairs in global page order.  A page
    belongs to the chunk containing its first tuple ("one page contains
    data from multiple adjacent chunks" — unique ownership by first
    tuple).
    """
    chunk_first, chunk_last, chunk_table = [], [], []
    offs = []
    for ti, tname in enumerate(tnames):
        t = db.tables[tname]
        offs.append(len(chunk_first))
        for ch in range(t.n_chunks):
            lo, hi = t.chunk_range(ch)
            chunk_first.append(float(lo))
            chunk_last.append(float(hi))
            chunk_table.append(ti)
    page_chunk = np.zeros(len(page_rows), np.int32)
    for gi, (ti, first) in enumerate(page_rows):
        t = db.tables[tnames[ti]]
        local = min(int(first // t.chunk_tuples), t.n_chunks - 1)
        page_chunk[gi] = offs[ti] + local
    return (
        len(chunk_first),
        np.asarray(chunk_first, np.float32),
        np.asarray(chunk_last, np.float32),
        np.asarray(chunk_table, np.int32),
        page_chunk,
    )
