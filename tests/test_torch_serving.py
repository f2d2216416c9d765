"""The port's serving path against the JAX package's.

* ``PagePool`` / ``RequestKV`` / ``PolicyDriver`` / ``ServingEngine``:
  driven by the stub ``step_fn`` at the serving benchmark's default
  operating point under all four policies, the two engines give identical
  ``EngineStats``, token gaps, finish order and scheduler events.
* The cases of ``tests/test_serving_policy.py``, restated on the port.
* ``PagedTinyLM``: with the JAX model's weights carried across by
  ``load_jax_params``, the port's per-token logits are within 1e-5 of the
  JAX model's (backend ``reference``), on a token sequence and across a
  forced preemption and resume; a whole small engine run with the model
  gives equal stats and logits within 1e-4.

Greedy tokens alone would not show whether attention is right: at these
widths the argmax is nearly always the input token, so logits are
compared, with a stated tolerance.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.serving as jserving  # noqa: E402
from benchmarks.serving_bench import DEFAULT_POINT  # noqa: E402
from repro.core import policy_registry as jregistry  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serving import model as jmodel  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from repro_torch.core import policy_registry  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    PagePool, Request, RequestKV, ServingEngine, prefix_hash,
)
from repro_torch.serving.model import PagedTinyLM, TinyConfig  # noqa: E402

POLICIES = ("lru", "cscan", "pbm", "opt")


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    # the model's ops are tiny: intra-op threads only contend for the CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference_backend():
    """The JAX model through its jnp oracle.  ``ops.paged_attention`` is
    ``jax.jit``-cached on shapes and reads the backend only while tracing,
    so the cache is cleared on both sides of the switch."""
    before = jops.get_backend()
    jops.set_backend("reference")
    jops.paged_attention.clear_cache()
    yield
    jops.set_backend(before)
    jops.paged_attention.clear_cache()


def _stub(reqs):
    return [int((r.kv.length * 2654435761) % 50000) for r in reqs]


def _plan(pkg, *, n_requests, page_size, prefix_len, share_ratio, gen_lo,
          gen_hi, seed, vocab=None, **_):
    """The serving benchmark's requests, with explicit request ids so that
    the two packages number them alike.  With ``vocab`` every token id is
    taken modulo it (the benchmark's unshared prefixes use ids 1000 + i,
    outside a small model's vocabulary); that keeps which prompts share a
    prefix."""
    rng = np.random.default_rng(seed)
    common = list(range(prefix_len))
    lengths = rng.integers(gen_lo, gen_hi, n_requests)
    shared = rng.random(n_requests) < share_ratio
    plan = []
    for i in range(n_requests):
        prefix = common if shared[i] else [1000 + i] * prefix_len
        prompt = prefix + [int(t) for t in rng.integers(0, 100, 16)]
        if vocab is not None:
            prompt = [t % vocab for t in prompt]
        plan.append(pkg.Request(prompt=prompt,
                                max_new_tokens=int(lengths[i]), rid=i))
    return plan


def _run_point(pkg, policy, step_fn=_stub, point=None, page_bytes=None):
    """One policy at one operating point under timed arrivals (the loop of
    ``benchmarks/serving_bench.run_policy``) with events recorded."""
    p = dict(DEFAULT_POINT if point is None else point)
    pool = pkg.PagePool(
        n_pages=p["pool_pages"], page_size=p["page_size"],
        page_bytes=(p["page_size"] * 2 * 8 * 128 * 2 if page_bytes is None
                    else page_bytes))
    eng = pkg.ServingEngine(pool, step_fn, policy=policy,
                            max_batch=p["max_batch"], record_events=True)
    plan = _plan(pkg, **p)
    due = 0
    while len(eng.finished) < len(plan) and eng.stats.steps < 50_000:
        while due < len(plan) and \
                eng.stats.steps >= due * p["arrival_interval"]:
            eng.submit(plan[due])
            due += 1
        eng.step()
    return eng


def _summary(eng):
    return {
        "stats": dataclasses.asdict(eng.stats),
        "token_gaps": list(eng.token_gaps),
        "finished": [r.rid for r in eng.finished],
        "generated": [list(r.generated) for r in eng.finished],
        "events": eng.events,
        "free": list(eng.pool.free),
    }


# ------------------------------------------------- engine parity with JAX ---

@pytest.mark.parametrize("policy", POLICIES)
def test_engine_equals_jax_engine_at_the_default_point(policy):
    port = _summary(_run_point(tserving, policy))
    ref = _summary(_run_point(jserving, policy))
    assert port == ref
    assert port["stats"]["tokens_generated"] > 0
    assert len(port["finished"]) == DEFAULT_POINT["n_requests"]


def test_registry_serving_names_equal_the_jax_registry():
    assert policy_registry.names(backend="serving") == \
        jregistry.names(backend="serving") == ["lru", "cscan", "pbm", "opt"]
    assert policy_registry.get("cscan").backends == ("array", "serving")
    for name in POLICIES:
        pol = policy_registry.serving_policy(name)
        assert pol.name == name
        assert type(pol).__name__ == \
            type(jregistry.serving_policy(name)).__name__


# ---------------------------------------- test_serving_policy.py restated ---

def test_prefix_release_order_any_interleaving():
    pool = PagePool(n_pages=8, page_size=4, page_bytes=64)
    h = prefix_hash(list(range(4)))
    assert h == jserving.prefix_hash(list(range(4)))
    a = pool.alloc(prefix_hash=h)
    b = pool.alloc(prefix_hash=h)
    c = pool.alloc(prefix_hash=h)
    assert a == b == c and pool.meta[a].ref_count == 3
    assert pool.free_count == 7
    pool.release(b)
    pool.release(a)
    assert pool.meta[a].ref_count == 1
    assert pool.prefix_index[h] == a
    pool.release(c)
    assert a not in pool.meta
    assert h not in pool.prefix_index
    assert pool.free_count == 8


def test_swap_round_trip_with_full_pool():
    pool = PagePool(n_pages=4, page_size=4, page_bytes=64)
    held = [pool.alloc() for _ in range(4)]
    assert held == [3, 2, 1, 0]               # the JAX pool's free-list order
    assert pool.free_count == 0 and pool.alloc() is None
    mapping = pool.swap_out(held[:2])
    uids = [mapping[p] for p in held[:2]]
    assert uids == [-1, -2] and pool.free_count == 2
    filler = [pool.alloc(), pool.alloc()]
    assert pool.swap_in(uids) is None
    assert all(pool.meta[u].on_host for u in uids)
    for p in filler:
        pool.release(p)
    back = pool.swap_in(uids)
    assert back is not None and len(back) == 2
    assert all(not pool.meta[s].on_host for s in back.values())
    assert pool.swap_in_bytes == pool.swap_out_bytes == 2 * 64


def test_alloc_on_host_resident_prefix_takes_fresh_page():
    pool = PagePool(n_pages=4, page_size=4, page_bytes=64)
    h = prefix_hash([1, 2, 3, 4])
    first = pool.alloc(prefix_hash=h)
    uid = pool.swap_out([first])[first]
    fresh = pool.alloc(prefix_hash=h)
    assert fresh is not None and fresh != uid
    assert pool.meta[fresh].ref_count == 1
    assert pool.prefix_index[h] == fresh
    slot = pool.swap_in([uid])[uid]
    assert pool.prefix_index[h] == fresh and slot != fresh
    pool.release(slot)
    assert h in pool.prefix_index
    pool.release(fresh)
    assert h not in pool.prefix_index


def test_engine_resolves_policy_strings_via_registry():
    for name in policy_registry.names(backend="serving"):
        pool = PagePool(n_pages=16, page_size=4, page_bytes=64)
        eng = ServingEngine(pool, _stub, policy=name, max_batch=4)
        assert eng.policy == name
        assert eng.driver.policy.name == name


def test_engine_rejects_unknown_and_non_serving_names(monkeypatch):
    pool = PagePool(n_pages=16, page_size=4, page_bytes=64)
    with pytest.raises(KeyError, match="registered policies"):
        ServingEngine(pool, _stub, policy="belady")
    # the port registers no array-only policy; add one for the check
    monkeypatch.setitem(
        policy_registry._REGISTRY, "array_only",
        policy_registry.PolicyEntry(name="array_only", summary="test",
                                    array_factory=object, array_id=99))
    with pytest.raises(KeyError, match="serving-capable"):
        ServingEngine(pool, _stub, policy="array_only")


def test_resume_falls_through_policy_order_on_empty_machine():
    pool = PagePool(n_pages=10, page_size=4, page_bytes=64)
    eng = ServingEngine(pool, _stub, policy="opt", max_batch=2)
    big = Request(prompt=list(range(4)), max_new_tokens=2)
    small = Request(prompt=[9, 9, 9, 9], max_new_tokens=40)
    for r, npages in ((big, 9), (small, 1)):
        kv = RequestKV(pool, pool.page_size)
        assert kv.attach_prefix(r.prompt) >= 0
        assert kv.append_tokens(4 * (npages - 1))
        r.kv = kv
        eng.active.append(r)
    for r in (big, small):
        eng.active.remove(r)
        r.swapped = True
        mapping = pool.swap_out(r.kv.pages)
        r.kv.pages = [mapping.get(p, p) for p in r.kv.pages]
        eng.swapped.append(r)
    blockers = [pool.alloc() for _ in range(8)]
    assert all(b is not None for b in blockers)
    eng._try_admit()
    assert small in eng.active and big in eng.swapped
    order = eng.driver.resume_order(eng.driver.view(eng))
    assert order and order[0] is big


def test_prefetch_stages_pages_while_batch_full():
    pool = PagePool(n_pages=64, page_size=4, page_bytes=64)
    eng = ServingEngine(pool, _stub, policy="pbm", max_batch=2)
    for _ in range(2):
        eng.submit(Request(prompt=[1, 2, 3, 4], max_new_tokens=30))
    eng.step()
    assert len(eng.active) == 2
    waiting = Request(prompt=[9, 9, 9, 9], max_new_tokens=20)
    kv = RequestKV(pool, pool.page_size)
    assert kv.attach_prefix(waiting.prompt) >= 0
    assert kv.append_tokens(8)
    waiting.kv = kv
    waiting.swapped = True
    mapping = pool.swap_out(kv.pages)
    kv.pages = [mapping.get(p, p) for p in kv.pages]
    assert any(p < 0 for p in kv.pages)
    eng.swapped.append(waiting)
    eng._prefetch_ahead()
    assert waiting.prefetched
    assert all(p >= 0 for p in waiting.kv.pages)
    while waiting not in eng.active and eng.stats.steps < 200:
        eng.step()
    assert waiting in eng.active
    assert waiting.ready_step == waiting.admitted_step
    assert eng.stats.prefetched_resumes == 1


def test_engine_completes_under_every_registry_policy():
    for name in policy_registry.names(backend="serving"):
        pool = PagePool(n_pages=20, page_size=8, page_bytes=128)
        eng = ServingEngine(pool, _stub, policy=name, max_batch=4)
        for _ in range(8):
            eng.submit(Request(prompt=list(range(12)), max_new_tokens=24))
        eng.run_to_completion(max_steps=5_000)
        assert len(eng.finished) == 8, name
        assert pool.free_count == pool.n_pages, name


def test_policy_ordering_at_default_operating_point():
    """PBM strictly beats LRU on swap volume, OPT bounds both, and no
    predictive policy stalls worse than LRU at p95 token gap."""
    rows = {p: _run_point(tserving, p) for p in ("lru", "pbm", "opt")}
    n = DEFAULT_POINT["n_requests"]
    assert all(len(e.finished) == n for e in rows.values())
    swap = {p: e.stats.swap_out_bytes + e.stats.swap_in_bytes
            for p, e in rows.items()}
    assert swap["pbm"] < swap["lru"]
    assert swap["opt"] <= swap["pbm"]
    p95 = {p: float(np.percentile(e.token_gaps, 95)) for p, e in rows.items()}
    assert p95["pbm"] <= p95["lru"] and p95["opt"] <= p95["lru"]


# ---------------------------------------------------------------- model ---

SMALL = dict(vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=128, page_size=4, n_pages=16)


def _jax_params(jlm):
    return {"embed": np.asarray(jlm.params["embed"]),
            "layers": [{k: np.asarray(v) for k, v in lp.items()}
                       for lp in jlm.params["layers"]]}


def _models(cfg_kw, seed=3):
    jlm = jmodel.PagedTinyLM(jmodel.TinyConfig(**cfg_kw), seed=seed)
    tlm = PagedTinyLM(TinyConfig(**cfg_kw), seed=seed + 1, device="cpu")
    tlm.load_jax_params(_jax_params(jlm))
    return jlm, tlm


def test_default_weights_follow_the_jax_draw():
    jlm = jmodel.PagedTinyLM(jmodel.TinyConfig(**SMALL), seed=5)
    tlm = PagedTinyLM(TinyConfig(**SMALL), seed=5, device="cpu")
    want = _jax_params(jlm)
    assert np.array_equal(tlm.embed.numpy(), want["embed"])
    for layer, lp in zip(tlm.layers, want["layers"]):
        for name, w in lp.items():
            assert np.array_equal(getattr(layer, name).numpy(), w), name


def test_model_logits_equal_jax_through_a_preemption(reference_backend):
    """Per-token logits within 1e-5 while a sequence fills three pages,
    then after a swap-out / swap-in that moves its pages to other slots
    (ids only, as in the reference: the new slots' K/V is whatever they
    hold, and both models read the same)."""
    jlm, tlm = _models(SMALL)
    rng = np.random.default_rng(7)
    tokens = [int(t) for t in rng.integers(0, SMALL["vocab"], 20)]
    pool = PagePool(n_pages=SMALL["n_pages"], page_size=SMALL["page_size"],
                    page_bytes=64)
    kv = RequestKV(pool, pool.page_size)
    assert kv.attach_prefix(tokens[:10]) >= 0
    worst = 0.0
    for pos, tok in enumerate(tokens):
        if pos == 13:                     # forced preemption and resume
            other = [pool.alloc() for _ in range(3)]
            mapping = pool.swap_out(kv.pages)
            kv.pages = [mapping.get(p, p) for p in kv.pages]
            for p in other:
                pool.release(p)
            back = pool.swap_in(kv.pages)
            moved = [back.get(p, p) for p in kv.pages]
            assert moved != [p for p in mapping]      # new slots
            kv.pages = moved
        if pos >= kv.length:
            assert kv.append_tokens(1)
        want = np.asarray(jlm._forward_token(tok, kv.pages, pos))
        got = tlm._forward_token(tok, kv.pages, pos).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        worst = max(worst, float(np.abs(got - want).max()))
    assert worst < 1e-5


def test_engine_run_with_the_model_equals_jax(reference_backend):
    """A whole small oversubscribed engine run with the model: equal
    stats, gaps, finish order and events, every forward's logits within
    1e-4."""
    cfg_kw = dict(SMALL, page_size=8, n_pages=12)
    jlm, tlm = _models(cfg_kw)
    logits = {"jax": [], "port": []}

    def recording(lm, key, convert):
        forward = lm._forward_token

        def wrapped(*a, **k):
            out = forward(*a, **k)
            logits[key].append(convert(out))
            return out
        return wrapped

    jlm._forward_token = recording(jlm, "jax", np.asarray)
    tlm._forward_token = recording(tlm, "port", lambda t: t.numpy().copy())
    point = dict(n_requests=6, pool_pages=12, page_size=8, prefix_len=8,
                 share_ratio=0.5, max_batch=3, arrival_interval=1,
                 gen_lo=10, gen_hi=30, seed=2, vocab=SMALL["vocab"])
    ref = _run_point(jserving, "lru", jlm.step_fn, point, page_bytes=64)
    port = _run_point(tserving, "lru", tlm.step_fn, point, page_bytes=64)
    assert port.stats.preemptions > 0
    a, b = _summary(port), _summary(ref)
    assert a == b
    assert len(logits["port"]) == len(logits["jax"]) > 0
    for got, want in zip(logits["port"], logits["jax"]):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_serve_driver_runs_the_model_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--real-model", "--device", "cpu", "--requests", "2",
                "--prefix-len", "8", "--pool-pages", "12"])
    out = capsys.readouterr().out
    assert "policy=pbm served=2" in out
    assert serve.page_bytes(16, TinyConfig()) == 16 * 1 * 128 * 2 * 2
