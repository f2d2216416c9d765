"""Columnar storage model: tables, columns, chunks and pages.

This module reproduces the storage abstractions that the paper's buffer
management policies operate on (paper §2):

* A **table** is a set of columns over ``n_tuples`` tuples.
* Each **column** stores a (possibly compressed) byte stream; because columns
  compress differently, the *same* logical tuple range occupies a very
  different number of pages per column ("one column ... on a single page,
  while other columns ... thousands of pages").
* A **page** is the unit of I/O and buffering (fixed byte size).
* A **chunk** is a *logical tuple range* (>= a few hundred thousand tuples),
  NOT a set of pages — the paper is explicit about this for column stores.
  Chunk→page translation happens per column via :meth:`Table.chunk_pages`.

The same abstractions back the ML-side integrations: a dataset shard is a
"table" whose pages front a slow storage tier, and a paged KV cache reuses
:class:`Page` identity semantics (see the serving slice, still to port).

Frozen copy of ``src/repro_torch/core/pages.py`` at commit 7b98c78, part of
the benchmark's plain reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class PageId:
    """Globally unique page identity: (table, column, index within column)."""

    table: str
    column: str
    index: int

    def __repr__(self) -> str:  # compact for traces
        return f"{self.table}.{self.column}[{self.index}]"


@dataclass
class Page:
    """A physical page of one column.

    ``first_tuple``/``last_tuple`` delimit the tuple range whose values the
    page stores (half-open).  One page may span multiple adjacent chunks
    (paper: "one page contains data from multiple adjacent chunks").
    """

    pid: PageId
    size_bytes: int
    first_tuple: int
    last_tuple: int  # exclusive

    @property
    def tuple_count(self) -> int:
        return self.last_tuple - self.first_tuple

    def __hash__(self) -> int:
        return hash(self.pid)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Page) and self.pid == other.pid


@dataclass
class Column:
    """One column of a table.

    ``bytes_per_tuple`` models width after compression; it drives how many
    pages the column occupies and therefore how much I/O a scan of this
    column costs.
    """

    name: str
    bytes_per_tuple: float
    table_name: str = ""
    n_tuples: int = 0
    page_bytes: int = 1 << 20
    pages: List[Page] = field(default_factory=list, repr=False)

    def build_pages(self) -> None:
        total_bytes = int(math.ceil(self.n_tuples * self.bytes_per_tuple))
        n_pages = max(1, int(math.ceil(total_bytes / self.page_bytes)))
        self.pages = []
        # Uniform tuples-per-page (integer boundaries, exact cover).
        for i in range(n_pages):
            first = (self.n_tuples * i) // n_pages
            last = (self.n_tuples * (i + 1)) // n_pages
            if last <= first:
                last = first + 1
            size = min(self.page_bytes, total_bytes - i * self.page_bytes)
            self.pages.append(
                Page(
                    pid=PageId(self.table_name, self.name, i),
                    size_bytes=max(1, size),
                    first_tuple=first,
                    last_tuple=last,
                )
            )

    def pages_for_range(self, first: int, last: int) -> List[Page]:
        """All pages overlapping tuple range [first, last)."""
        if not self.pages or last <= first:
            return []
        n_pages = len(self.pages)
        tup_per_page = self.n_tuples / n_pages
        lo = min(n_pages - 1, int(first / tup_per_page))
        while lo > 0 and self.pages[lo].first_tuple > first:
            lo -= 1
        while lo < n_pages - 1 and self.pages[lo].last_tuple <= first:
            lo += 1
        out = []
        i = lo
        while i < n_pages and self.pages[i].first_tuple < last:
            out.append(self.pages[i])
            i += 1
        return out


@dataclass
class Table:
    """A columnar table partitioned into logical chunks of tuples."""

    name: str
    n_tuples: int
    columns: Dict[str, Column] = field(default_factory=dict)
    chunk_tuples: int = 100_000
    page_bytes: int = 1 << 20

    def add_column(self, name: str, bytes_per_tuple: float) -> Column:
        col = Column(
            name=name,
            bytes_per_tuple=bytes_per_tuple,
            table_name=self.name,
            n_tuples=self.n_tuples,
            page_bytes=self.page_bytes,
        )
        col.build_pages()
        self.columns[name] = col
        return col

    # ---- chunks -----------------------------------------------------------
    @property
    def n_chunks(self) -> int:
        return max(1, int(math.ceil(self.n_tuples / self.chunk_tuples)))

    def chunk_range(self, chunk_id: int) -> Tuple[int, int]:
        first = chunk_id * self.chunk_tuples
        last = min(self.n_tuples, first + self.chunk_tuples)
        return first, last

    def chunks_for_range(self, first: int, last: int) -> List[int]:
        if last <= first:
            return []
        lo = first // self.chunk_tuples
        hi = (last - 1) // self.chunk_tuples
        return list(range(lo, hi + 1))

    def chunk_pages(self, chunk_id: int, columns: Sequence[str]) -> List[Page]:
        """Translate a logical chunk into pages, per column (paper §2)."""
        first, last = self.chunk_range(chunk_id)
        out: List[Page] = []
        for c in columns:
            out.extend(self.columns[c].pages_for_range(first, last))
        return out

    def scan_bytes(self, columns: Sequence[str], first: int, last: int) -> int:
        """Unique bytes a scan of [first,last) over ``columns`` touches."""
        total = 0
        for c in columns:
            for p in self.columns[c].pages_for_range(first, last):
                total += p.size_bytes
        return total

    def total_bytes(self, columns: Optional[Sequence[str]] = None) -> int:
        cols = columns if columns is not None else list(self.columns)
        return sum(
            sum(p.size_bytes for p in self.columns[c].pages) for c in cols
        )


@dataclass
class Database:
    """A set of tables — the unit the engine and workloads operate on."""

    tables: Dict[str, Table] = field(default_factory=dict)

    def add_table(
        self,
        name: str,
        n_tuples: int,
        columns: Dict[str, float],
        chunk_tuples: int = 100_000,
        page_bytes: int = 1 << 20,
    ) -> Table:
        t = Table(
            name=name,
            n_tuples=n_tuples,
            chunk_tuples=chunk_tuples,
            page_bytes=page_bytes,
        )
        for cname, bpt in columns.items():
            t.add_column(cname, bpt)
        self.tables[name] = t
        return t

    def all_pages(self) -> Iterable[Page]:
        for t in self.tables.values():
            for c in t.columns.values():
                yield from c.pages
