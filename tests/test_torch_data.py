"""The port's data pipeline (``repro_torch.data``) against the JAX package's
(``repro.data``, numpy only): the same pages bit for bit, and under LRU,
PBM and OPT with one deterministic clock injected into both caches, the
same hits, misses, miss bytes and resident set after every round, and
bit-equal batches; the exact mid-page resume and work stealing."""

import itertools

import numpy as np
import pytest

from repro.data import (DataStream as JDataStream, DatasetSpec as JSpec,
                        HostPageCache as JCache,
                        MultiStreamLoader as JLoader,
                        generate_page as jgenerate_page)
from repro_torch.data import (DataStream, DatasetSpec, HostPageCache,
                              MultiStreamLoader, PAGE_TOKENS, generate_page)

POLICIES = ("lru", "pbm", "opt")


def _clock():
    """A clock that advances 1 ms a reading, the same in both packages."""
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


@pytest.mark.parametrize("spec_kw, shard, page", [
    ({}, 0, 0), ({"seed": 7}, 3, 5), ({"name": "eval", "vocab_size": 512},
                                      15, 63)])
def test_generate_page_gives_the_reference_bits(spec_kw, shard, page):
    got = generate_page(DatasetSpec(**spec_kw), shard, page)
    want = jgenerate_page(JSpec(**spec_kw), shard, page)
    assert got.dtype == want.dtype and got.shape == (PAGE_TOKENS,)
    np.testing.assert_array_equal(got, want)


def _loader(pkg, policy, spec_kw):
    Spec, Cache, Stream, Loader = pkg
    spec = Spec(**spec_kw)
    cache = Cache(spec, capacity_pages=5, policy=policy, clock=_clock())
    loader = Loader(cache)
    # three concurrent readers over overlapping shards, of different rates
    for name, order, batch, seq in (("train", [0, 1, 2, 3], 4, 4097),
                                    ("eval", [2, 3, 0], 2, 2049),
                                    ("catchup", [1, 0], 8, 1025)):
        loader.add_stream(Stream(cache, order, batch, seq, name=name))
    return cache, loader


def _resident(cache):
    return sorted((p.table, p.column, p.index) for p in cache.pool.resident)


PORT = (DatasetSpec, HostPageCache, DataStream, MultiStreamLoader)
JAX = (JSpec, JCache, JDataStream, JLoader)


@pytest.mark.parametrize("policy", POLICIES)
def test_cache_and_loader_equal_the_reference_round_by_round(policy):
    spec_kw = dict(n_shards=4, pages_per_shard=3, vocab_size=1000, seed=3)
    c_t, l_t = _loader(PORT, policy, spec_kw)
    c_j, l_j = _loader(JAX, policy, spec_kw)
    evicting = False
    for _ in range(12):
        got, want = l_t.next_round(), l_j.next_round()
        assert list(got) == list(want)          # the same service order
        for name in want:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name])
        assert (c_t.hit_pages, c_t.miss_pages, c_t.miss_bytes) == \
            (c_j.hit_pages, c_j.miss_pages, c_j.miss_bytes)
        assert _resident(c_t) == _resident(c_j)
        evicting |= c_t.pool.total_evictions > 0
    assert evicting and c_t.hit_pages > 0       # the policy had choices


def test_mid_page_resume_lands_on_the_same_next_batch():
    spec_kw = dict(n_shards=2, pages_per_shard=4)
    outs = []
    for Spec, Cache, Stream, _ in (PORT, JAX):
        spec = Spec(**spec_kw)
        s = Stream(Cache(spec, capacity_pages=8), [0, 1], batch=3,
                   seq_len=5000)
        for _ in range(7):
            s.next_batch()
        state = s.state_dict()
        assert state["tokens_consumed"] % PAGE_TOKENS      # mid-page
        want = s.next_batch()
        s2 = Stream(Cache(spec, capacity_pages=8), [0, 1], batch=3,
                    seq_len=5000)
        s2.load_state_dict(state)
        np.testing.assert_array_equal(s2.next_batch(), want)
        outs.append((state, want))
    (st_t, b_t), (st_j, b_j) = outs
    # the stream id is a process-wide scan counter's, not a position
    st_t.pop("stream_id"), st_j.pop("stream_id")
    assert st_t == st_j
    np.testing.assert_array_equal(b_t, b_j)


def test_work_stealing_extends_the_same_range():
    got = []
    for Spec, Cache, Stream, Loader in (PORT, JAX):
        spec = Spec(n_shards=4, pages_per_shard=2)
        cache = Cache(spec, capacity_pages=8, clock=_clock())
        loader = Loader(cache)
        a = Stream(cache, [0, 1], batch=1, seq_len=40_000, name="a")
        b = Stream(cache, [2, 3], batch=1, seq_len=40_000, name="b")
        loader.add_stream(a)
        loader.add_stream(b)
        loader.next_round()
        loader.steal_from("b", "a")
        rounds = [loader.next_round()["a"] for _ in range(6)]
        got.append((list(loader.streams), a.state.shard_order, rounds,
                    cache.miss_pages, cache.hit_pages))
    (names_t, order_t, r_t, *c_t), (names_j, order_j, r_j, *c_j) = got
    assert names_t == names_j == ["a"]
    # b had read all of shard 2 into its buffer: only shard 3 remains
    assert order_t == order_j == [0, 1, 3]
    assert c_t == c_j
    for x, y in zip(r_t, r_j):
        np.testing.assert_array_equal(x, y)
