"""Multi-stream training data pipeline with straggler mitigation.

Streams (train replicas, eval, the catch-up reader of a restarted node) pull
fixed-shape (B, T) batches by walking dataset pages through the shared
:class:`HostPageCache`.  Two paper-derived mechanisms:

* **Starved-stream priority** (QueryRelevance reused): the scheduler hands
  the next batch-build slot to the stream furthest behind its expected
  position — a restarted/straggling data-parallel reader catches up first
  because its pages are the soonest-consumed (PBM keeps them hot).
* **Work stealing**: `steal_from` lets a healthy reader take over a failed
  reader's remaining page range; the cache's registered plan is swapped
  accordingly (unregister + register), so eviction priorities follow.

Deterministic restart: a stream's position is (epoch, shard_idx, page,
offset) — `state_dict`/`load_state_dict` round-trips it (checkpointable).
A copy of ``repro.data.pipeline``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .cache import HostPageCache
from .dataset import PAGE_TOKENS


@dataclass
class StreamState:
    stream_id: int
    shard_order: List[int]
    shard_idx: int = 0
    page: int = 0
    offset: int = 0
    tokens_consumed: int = 0
    epoch: int = 0

    def position(self) -> Tuple[int, int, int, int]:
        return (self.epoch, self.shard_idx, self.page, self.offset)


class DataStream:
    """One sequential reader producing (B, T) token batches."""

    def __init__(
        self,
        cache: HostPageCache,
        shard_order: List[int],
        batch: int,
        seq_len: int,
        name: str = "train",
    ) -> None:
        self.cache = cache
        self.batch = batch
        self.seq_len = seq_len
        self.name = name
        sid = cache.register_stream(shard_order)
        self.state = StreamState(stream_id=sid, shard_order=list(shard_order))
        self._buf = np.empty((0,), np.int32)
        self._skip = 0  # tokens to drop after a mid-page restore

    # ------------------------------------------------------------------ io
    def _advance_page(self) -> np.ndarray:
        st = self.state
        spec = self.cache.spec
        shard = st.shard_order[st.shard_idx]
        toks = self.cache.get_page(st.stream_id, shard, st.page)
        if self._skip:
            toks = toks[self._skip:]
            self._skip = 0
        st.page += 1
        if st.page >= spec.pages_per_shard:
            st.page = 0
            st.shard_idx += 1
            if st.shard_idx >= len(st.shard_order):
                st.shard_idx = 0
                st.epoch += 1  # re-scan: a new "query" over the same table
        return toks

    def next_batch(self) -> np.ndarray:
        need = self.batch * self.seq_len
        while self._buf.size < need:
            self._buf = np.concatenate([self._buf, self._advance_page()])
        out = self._buf[:need].reshape(self.batch, self.seq_len)
        self._buf = self._buf[need:]
        self.state.tokens_consumed += need
        self.cache.report_position(self.state.stream_id, self.state.tokens_consumed)
        return out

    # ------------------------------------------------- checkpoint/restart
    def state_dict(self) -> Dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: Dict) -> None:
        """Exact mid-page resume: the canonical position is tokens_consumed;
        (shard, page, offset) are recomputed from it so a restore lands on
        the precise next token even though the in-memory read buffer of the
        failed reader is gone."""
        from .dataset import PAGE_TOKENS

        sid = self.state.stream_id
        st = StreamState(**{**d, "stream_id": sid})
        pp = self.cache.spec.pages_per_shard
        n_order = max(1, len(st.shard_order))
        pages_done = st.tokens_consumed // PAGE_TOKENS
        st.epoch = pages_done // (pp * n_order)
        rem = pages_done % (pp * n_order)
        st.shard_idx = rem // pp
        st.page = rem % pp
        st.offset = st.tokens_consumed % PAGE_TOKENS
        self.state = st
        self._buf = np.empty((0,), np.int32)
        self._skip = st.offset


class MultiStreamLoader:
    """Schedules several streams over one shared cache (straggler-aware)."""

    def __init__(self, cache: HostPageCache):
        self.cache = cache
        self.streams: Dict[str, DataStream] = {}
        self._expected: Dict[str, int] = {}

    def add_stream(self, stream: DataStream) -> None:
        self.streams[stream.name] = stream
        self._expected[stream.name] = 0

    def next_round(self) -> Dict[str, np.ndarray]:
        """One batch per stream; most-behind (starved) stream served first."""
        order = sorted(
            self.streams,
            key=lambda n: self.streams[n].state.tokens_consumed - self._expected[n],
        )
        out = {}
        for name in order:
            out[name] = self.streams[name].next_batch()
            self._expected[name] += self.streams[name].batch * self.streams[name].seq_len
        return out

    def steal_from(self, failed: str, healthy: str) -> None:
        """Work stealing: ``healthy`` adopts ``failed``'s remaining range."""
        f = self.streams.pop(failed)
        self.cache.unregister_stream(f.state.stream_id)
        h = self.streams[healthy]
        # extend the healthy stream's shard order with the failed remainder
        remaining = f.state.shard_order[f.state.shard_idx:]
        h.state.shard_order.extend(remaining)
        self._expected.pop(failed, None)
