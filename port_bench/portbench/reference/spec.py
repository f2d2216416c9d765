"""Static, fixed-shape array description of a scan workload.

A frozen copy of ``src/repro_torch/core/array_sim/spec.py`` at commit
7b98c78 (``build_spec`` left out: the reference lowers through
:func:`.compiler.compile_workload`), with ``spec_to_torch`` of
``array_sim/convert.py`` beside it.

The event engine walks Python dicts of :class:`~repro_torch.core.pages.Page`
objects; the array backend flattens the same storage model into dense
arrays once, up front, so the simulation step is pure array math:

* **pages** — one slot per physical page of the table, padded to a
  multiple of 128 (``page_valid`` masks the padding).  Per-page constants:
  byte size, covered tuple range, owning column.
* **columns** — tuples-per-page and the page-id offset of each column,
  which turn a cursor position into a page index with one divide
  (the array analogue of :meth:`Column.pages_for_range`).
* **streams** — each stream's queries as ``(table, start, length, rate,
  column mask)`` rows, padded to the longest stream.

Workloads over several tables (the paper's §4.2 TPC-H throughput run:
8 tables / 61 columns, 22 rotated query templates per stream) lower
through :mod:`repro_torch.core.array_sim.compiler`, which lays the pages of
every referenced (table, column) pair out in one global id space; the
``multitable`` extension fields below record the table geometry.  Tuple
coordinates stay per table — each query's cursor lives in its own
table's coordinate system, and the global column mask restricts every
per-column computation to that table.  ``build_spec`` remains the
single-table entry point (the microbenchmark shape of Figs 11-13) and
delegates to the same compiler, so there is exactly one lowering.

Own copy of the JAX package's ``repro.core.array_sim.spec`` (numpy only);
the port imports nothing from that package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

PAGE_PAD = 128


class SimSpec(NamedTuple):
    """Immutable workload description consumed by ``array_sim.sim``.

    Array fields are plain numpy; ``convert.spec_to_torch`` moves them to
    the device once, when a step is built.
    """

    # ---- static dims -----------------------------------------------------
    n_pages: int          # P (padded)
    n_streams: int        # S
    n_queries: int        # Q (padded per-stream query count)
    n_cols: int           # C
    # ---- PBM bucket geometry (paper Fig. 10) -----------------------------
    n_groups: int
    buckets_per_group: int
    # ---- per-page constants (P,) -----------------------------------------
    page_size: np.ndarray     # f32 bytes
    page_first: np.ndarray    # f32 first tuple (absolute)
    page_last: np.ndarray     # f32 last tuple, exclusive
    page_col: np.ndarray      # i32 owning column
    page_valid: np.ndarray    # bool
    # ---- per-column constants (C,) ---------------------------------------
    col_start: np.ndarray     # i32 page-id offset of the column
    col_npages: np.ndarray    # i32
    col_tpp: np.ndarray       # f32 tuples per page
    col_ntuples: np.ndarray   # f32
    # ---- per-stream queries (S, Q) ---------------------------------------
    q_start: np.ndarray       # f32 first tuple (in the query table's coords)
    q_len: np.ndarray         # f32 tuples scanned
    q_rate: np.ndarray        # f32 tuples/sec CPU rate
    q_cols: np.ndarray        # bool (S, Q, C) column mask
    n_q: np.ndarray           # i32 (S,) valid queries per stream
    # ---- multitable extension (compiler.py) ------------------------------
    # The step itself resolves everything through the per-column offset
    # tables above; these record the table geometry for introspection,
    # validation, and result attribution.
    n_tables: int = 1
    table_names: Tuple[str, ...] = ()
    col_table: Optional[np.ndarray] = None   # i32 (C,) owning table
    q_table: Optional[np.ndarray] = None     # i32 (S, Q) table of each query
    # ---- chunk geometry (cooperative substrate, compiler.py) -------------
    # The paper's logical chunks (a tuple range, NOT a page set): global
    # chunk ids across the compiled tables; a page belongs to the chunk
    # containing its first tuple (ABM's unique-ownership rule).  Consumed
    # by ``array_sim.coop`` for the array-CScan policy.
    n_chunks: int = 0
    page_chunk: Optional[np.ndarray] = None   # i32 (P,) owning chunk
    chunk_first: Optional[np.ndarray] = None  # f32 (CH,) table-local tuples
    chunk_last: Optional[np.ndarray] = None   # f32 (CH,) exclusive
    chunk_table: Optional[np.ndarray] = None  # i32 (CH,) owning table
    # ---- per-column trigger geometry (compiler.py, horizon stepper) ------
    # Fastest CPU rate of any query that actually scans each column.  The
    # event-horizon stepper sizes its trigger window for macro-steps of
    # up to ~h_max fine steps; bounding the crossing count with the
    # per-column rate (instead of the global max rate) keeps the window
    # from exploding on dense columns only slow scans ever touch.
    col_max_rate: Optional[np.ndarray] = None  # f32 (C,)

    @property
    def nb(self) -> int:
        """Number of requested buckets in the PBM timeline."""
        return self.n_groups * self.buckets_per_group

    @property
    def not_requested(self) -> int:
        """Bucket sentinel for resident pages no active scan wants."""
        return self.nb

    @property
    def max_rate(self) -> float:
        """Fastest CPU consumption rate of any query (tuples/sec)."""
        return float(np.max(self.q_rate))

    @property
    def min_tpp(self) -> float:
        """Fewest tuples per page of any column — the densest page grid."""
        return float(np.min(self.col_tpp))

    def trigger_window(self, dt: float, tight: bool = False) -> int:
        """Static per-column page-trigger lookahead for one step of length
        ``dt``: the most page boundaries the fastest scan can cross in the
        densest column, plus one so the conservative advance cap
        (``W``-th trigger) never throttles an unblocked scan.

        Computed per column and capped at the column's page count: a tiny
        dimension table (a handful of tuples per page, one page per
        column) has a dense tuple grid but nothing beyond its last page,
        so it must not inflate the global window the way a naive
        ``max_rate / min_tpp`` bound would in a multi-table spec.

        ``tight`` additionally bounds each column by the fastest rate of
        a query that actually scans it (``col_max_rate``, compiled per
        column) — still sufficient (no scan of the column is faster),
        but much smaller for the long macro-steps of the event-horizon
        stepper when the densest columns belong to slow scans only.
        """
        rate = self.max_rate
        if tight and self.col_max_rate is not None:
            rate = np.maximum(self.col_max_rate, 1.0)
        need = np.ceil(
            1.1 * rate * float(dt) / self.col_tpp
        ).astype(np.int64) + 1
        need = np.minimum(need, self.col_npages.astype(np.int64) + 1)
        return max(1, int(np.max(need)))


class TorchSpec(NamedTuple):
    """The array fields of a :class:`SimSpec` on a device."""

    page_size: torch.Tensor    # (P,) f32
    page_first: torch.Tensor   # (P,) f32
    page_last: torch.Tensor    # (P,) f32
    page_col: torch.Tensor     # (P,) i64
    page_valid: torch.Tensor   # (P,) bool
    col_start: torch.Tensor    # (C,) i64
    col_npages: torch.Tensor   # (C,) i64
    col_tpp: torch.Tensor      # (C,) f32
    q_start: torch.Tensor      # (S, Q) f32
    q_len: torch.Tensor        # (S, Q) f32
    q_rate: torch.Tensor       # (S, Q) f32
    q_cols: torch.Tensor       # (S, Q, C) bool
    n_q: torch.Tensor          # (S,) i64


def spec_to_torch(spec: SimSpec, device) -> TorchSpec:
    dev = torch.device(device)

    def to(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=dev, dtype=dtype)

    f32, i64 = torch.float32, torch.int64
    return TorchSpec(
        page_size=to(spec.page_size, f32),
        page_first=to(spec.page_first, f32),
        page_last=to(spec.page_last, f32),
        page_col=to(spec.page_col, i64),
        page_valid=to(spec.page_valid, torch.bool),
        col_start=to(spec.col_start, i64),
        col_npages=to(spec.col_npages, i64),
        col_tpp=to(spec.col_tpp, f32),
        q_start=to(spec.q_start, f32),
        q_len=to(spec.q_len, f32),
        q_rate=to(spec.q_rate, f32),
        q_cols=to(spec.q_cols, torch.bool),
        n_q=to(spec.n_q, i64),
    )
