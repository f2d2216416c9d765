"""The port's event engine (its own copy of the JAX package's pure-Python
dict/heapq machine: ``core/engine.py``, ``scans.py``, ``stats.py`` and
``policies/``) against the JAX package's ``run_workload``: the same
workload, built by each package from the same seed, under LRU, PBM, OPT
and CScan (the ABM), and the registry's event-only MRU, PBM/LRU and
Attach&Throttle, at two buffer points.  Both are plain Python over
equal inputs, so every metric must be EQUAL, not close."""

import functools

import pytest

from repro.core import engine as JE
from repro.core import stats as JS
from repro.core import workload as JW
from repro_torch.core import engine as TE
from repro_torch.core import stats as TS
from repro_torch.core import workload as TW

SCALE = 0.05
POLICIES = ("lru", "pbm", "opt", "cscan", "mru", "pbm_lru", "attach")
PAPER = ("lru", "pbm", "opt", "cscan")
FRACS = (0.2, 0.5)


@functools.lru_cache(maxsize=None)
def _run(pkg, policy, frac, tpch=False):
    W, E = (JW, JE) if pkg == "jax" else (TW, TE)
    if tpch:
        db = W.make_tpch_db(scale=0.01)
        streams = W.tpch_streams(db, n_streams=3, seed=7)
        ws = W.tpch_accessed_bytes(db, streams)
        ts = 0.001
    else:
        db = W.make_lineitem_db(scale_tuples=int(180_000_000 * SCALE))
        streams = W.micro_streams(db, n_streams=4, queries_per_stream=4,
                                  seed=3)
        ws = W.micro_accessed_bytes(db)
        ts = 0.1 * SCALE
    cfg = E.EngineConfig(buffer_bytes=max(1 << 22, int(frac * ws)),
                         pbm_time_slice=ts, sample_interval=0.05,
                         record_trace=True)
    return E.run_workload(db, streams, policy, cfg)


def _assert_same(got, want):
    assert got.policy == want.policy
    assert got.stream_times == want.stream_times
    assert got.avg_stream_time == want.avg_stream_time
    assert got.query_latencies == want.query_latencies
    assert got.total_io_bytes == want.total_io_bytes
    assert got.total_loads == want.total_loads
    assert got.total_hits == want.total_hits
    assert got.total_evictions == want.total_evictions
    assert got.sim_time == want.sim_time
    assert got.sharing_samples == want.sharing_samples
    # page ids are each package's own class: compare their fields
    assert [_pid(p) for p in got.trace] == [_pid(p) for p in want.trace]
    assert {_pid(p): n for p, n in got.page_sizes.items()} == \
        {_pid(p): n for p, n in want.page_sizes.items()}


def _pid(p):
    return p.table, p.column, p.index


@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("policy", POLICIES)
def test_event_engine_equals_the_jax_package_engine(policy, frac):
    _assert_same(_run("torch", policy, frac), _run("jax", policy, frac))


@pytest.mark.parametrize("policy", POLICIES)
def test_event_engine_equals_on_the_multitable_workload(policy):
    _assert_same(_run("torch", policy, 0.3, tpch=True),
                 _run("jax", policy, 0.3, tpch=True))


def test_sharing_potential_and_belady_replay_equal():
    got, want = _run("torch", "lru", 0.2), _run("jax", "lru", 0.2)
    assert TS.sharing_potential(got).by_count == \
        JS.sharing_potential(want).by_count
    assert TS.summarize([got]) == JS.summarize([want])
    from repro.core.policies.opt import simulate_belady as j_belady
    from repro_torch.core.policies.opt import simulate_belady as t_belady
    cap = 8 << 20
    assert len(got.trace) > 0
    assert t_belady(got.trace, page_sizes=got.page_sizes,
                    capacity_bytes=cap) == \
        j_belady(want.trace, page_sizes=want.page_sizes, capacity_bytes=cap)


def test_the_paper_ordering_holds_in_the_port_engine():
    """CScan loads the least at a small pool, OPT no more than LRU."""
    io = {p: _run("torch", p, 0.2).total_io_bytes for p in PAPER}
    assert io["cscan"] < min(io["lru"], io["pbm"], io["opt"])
    assert io["opt"] <= io["lru"]
