"""Sharded token datasets over paged storage.

A dataset is a set of shards; each shard is a sequence of fixed-size token
pages materialised on demand from a deterministic generator (offline
container: no external corpora — the generator is a keyed hash so any page
is reproducible from (shard, page) alone, which is also what makes restore-
after-failure trivial: a data position is just (shard, page, offset)).

The storage geometry reuses ``repro_torch.core.pages``: one table per dataset,
one column per shard — so the paper's policies (PBM/LRU/OPT) manage the
host page cache untouched (DESIGN.md §2 mapping: epochs = scans).
A copy of ``repro.data.dataset``: :func:`generate_page` gives the JAX
package's bits (the same keyed hash seeds numpy's generator).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..core.pages import Database

PAGE_TOKENS = 32_768          # tokens per storage page
TOKEN_BYTES = 4


@dataclass(frozen=True)
class DatasetSpec:
    name: str = "synthetic"
    n_shards: int = 16
    pages_per_shard: int = 64
    vocab_size: int = 50_304
    seed: int = 0

    @property
    def tokens_per_shard(self) -> int:
        return self.pages_per_shard * PAGE_TOKENS

    @property
    def total_tokens(self) -> int:
        return self.n_shards * self.tokens_per_shard


def make_dataset_db(spec: DatasetSpec) -> Database:
    """Storage-geometry view: one column per shard, PAGE_TOKENS*4B pages."""
    db = Database()
    db.add_table(
        spec.name,
        n_tuples=spec.tokens_per_shard,
        columns={f"shard{s}": float(TOKEN_BYTES) for s in range(spec.n_shards)},
        chunk_tuples=PAGE_TOKENS * 4,
        page_bytes=PAGE_TOKENS * TOKEN_BYTES,
    )
    return db


def generate_page(spec: DatasetSpec, shard: int, page: int) -> np.ndarray:
    """Deterministic 'disk read': tokens for (shard, page) from a keyed hash.

    Zipf-ish marginal over the vocab so losses behave like text, cheap to
    produce, identical across restarts (fault-tolerant data position).
    """
    key = f"{spec.name}/{spec.seed}/{shard}/{page}".encode()
    seed = int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "little")
    rng = np.random.default_rng(seed)
    u = rng.random(PAGE_TOKENS)
    # inverse-CDF of a truncated zipf(1.1)
    ranks = ((u ** -2.0) - 1.0)
    toks = np.clip(ranks.astype(np.int64), 0, spec.vocab_size - 1)
    return toks.astype(np.int32)


def page_of(spec: DatasetSpec, token_pos: int) -> Tuple[int, int, int]:
    """Global token position -> (shard, page, offset)."""
    shard = token_pos // spec.tokens_per_shard
    rem = token_pos % spec.tokens_per_shard
    return shard, rem // PAGE_TOKENS, rem % PAGE_TOKENS
