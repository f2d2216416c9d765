"""The cooperative substrate (array-CScan) of the port against the JAX
package's ``array_sim.coop``, function by function: the same numpy
inputs, made from a seed on a compiled workload, go through the JAX
function (one lane at a time) and the port's (every lane at once).
Integer and bool outputs must be EQUAL; f32 outputs within 1e-6
relative.  The cases include ties at the idle scan's pick (every chunk
available to every scan, equal interest) and a server whose chunk sits
exactly on the Keep < Load boundary (free + bytes held below == bytes
missing)."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.array_sim import coop as JC  # noqa: E402
from repro.core.array_sim.compiler import compile_workload as j_compile  # noqa: E402
from repro.core.workload import (  # noqa: E402
    make_lineitem_db, make_tpch_db, micro_streams, tpch_streams)
from repro_torch.core.array_sim import coop as TC  # noqa: E402

RTOL = 1e-6
L = 4
CASES = ("random", "tied_pick", "keep_load_edge")


@functools.lru_cache(maxsize=None)
def _spec(kind):
    if kind == "micro":
        db = make_lineitem_db(scale_tuples=int(180_000_000 * 0.03))
        return j_compile(db, micro_streams(db, n_streams=4,
                                           queries_per_stream=3, seed=3))
    db = make_tpch_db(scale=0.01)
    return j_compile(db, tpch_streams(db, n_streams=3, seed=7))


def _inputs(spec, case, seed):
    """One lane-major batch of substrate inputs, numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    S, Q, C, P = spec.n_streams, spec.n_queries, spec.n_cols, spec.n_pages
    CH = int(spec.n_chunks)
    qi = rng.integers(0, np.maximum(spec.n_q, 1), size=(L, S))
    if case == "tied_pick":
        qi[:] = 0
    s_idx = np.arange(S)
    start = spec.q_start[s_idx, qi].astype(np.float32)
    length = spec.q_len[s_idx, qi].astype(np.float32)
    rate = spec.q_rate[s_idx, qi].astype(np.float32)
    x = dict(
        active=rng.random((L, S)) < 0.85,
        start=start,
        end=(start + length).astype(np.float32),
        cols=spec.q_cols[s_idx, qi],
        q_tab=spec.q_table[s_idx, qi].astype(np.int32),
        rate_j=(rate * (1.0 + 0.08 * (2 * rng.random((L, S)) - 1))
                ).astype(np.float32),
        dt=(7.5e-4 * rng.integers(1, 9, size=L)).astype(np.float32),
        resident=(rng.random((L, P)) < 0.6) & spec.page_valid,
        done=rng.random((L, S, CH)) < 0.3,
        cur_chunk=np.where(rng.random((L, S)) < 0.5, -1,
                           rng.integers(0, CH, size=(L, S))).astype(np.int32),
        chunk_pos=(rng.random((L, S)) * 2e4).astype(np.float32),
        credit=(rng.random((L, S)) * 1e3).astype(np.float32),
        inflight=np.where(rng.random(L) < 0.3, -1,
                          rng.integers(0, CH, size=L)).astype(np.int32),
        pin_pages=(rng.random((L, P)) < 0.1) & spec.page_valid,
        free=(rng.random(L) * 4 * float(spec.page_size.max())
              ).astype(np.float32),
    )
    if case == "tied_pick":
        x["active"][:] = True
        x["resident"] = spec.page_valid[None].repeat(L, 0)
        x["done"][:] = False
        x["cur_chunk"][:] = -1
    x["credit_cap"] = (x["rate_j"] * x["dt"][:, None]).astype(np.float32)
    return x


def _jax_cpu(spec, cc, x, lane):
    cstate = JC.CoopState(
        done=jnp.asarray(x["done"][lane]),
        cur_chunk=jnp.asarray(x["cur_chunk"][lane]),
        chunk_pos=jnp.asarray(x["chunk_pos"][lane]),
        credit=jnp.asarray(x["credit"][lane]),
        inflight=jnp.int32(x["inflight"][lane]))
    return JC.cpu_phase(
        cc, cstate, active=jnp.asarray(x["active"][lane]),
        start=jnp.asarray(x["start"][lane]), end=jnp.asarray(x["end"][lane]),
        cols=jnp.asarray(x["cols"][lane]), q_tab=jnp.asarray(x["q_tab"][lane]),
        rate_j=jnp.asarray(x["rate_j"][lane]),
        dt=jnp.float32(x["dt"][lane]),
        credit_cap=jnp.asarray(x["credit_cap"][lane]),
        resident=jnp.asarray(x["resident"][lane]),
        page_col=jnp.asarray(spec.page_col),
        page_valid=jnp.asarray(spec.page_valid),
        s_idx=jnp.arange(spec.n_streams))


def _jax_io(spec, cc, x, lane):
    return JC.io_phase(
        cc, done=jnp.asarray(x["done"][lane]),
        cur_chunk=jnp.asarray(x["cur_chunk"][lane]),
        inflight=jnp.int32(x["inflight"][lane]),
        pin_pages=jnp.asarray(x["pin_pages"][lane]),
        active=jnp.asarray(x["active"][lane]),
        start=jnp.asarray(x["start"][lane]), end=jnp.asarray(x["end"][lane]),
        cols=jnp.asarray(x["cols"][lane]), q_tab=jnp.asarray(x["q_tab"][lane]),
        resident=jnp.asarray(x["resident"][lane]),
        free=jnp.float32(x["free"][lane]),
        page_chunk_sizes=jnp.asarray(spec.page_size),
        page_col=jnp.asarray(spec.page_col),
        page_valid=jnp.asarray(spec.page_valid), n_streams=spec.n_streams)


def _t(x, name, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x[name]))
    return t if dtype is None else t.to(dtype)


def _torch_state(x):
    return TC.CoopState(
        done=_t(x, "done"), cur_chunk=_t(x, "cur_chunk", torch.int64),
        chunk_pos=_t(x, "chunk_pos"), credit=_t(x, "credit"),
        inflight=_t(x, "inflight", torch.int64))


def _torch_cpu(spec, x):
    cc = TC.coop_consts(spec, "cpu")
    return TC.cpu_phase(
        cc, _torch_state(x), active=_t(x, "active"), start=_t(x, "start"),
        end=_t(x, "end"), cols=_t(x, "cols"),
        q_tab=_t(x, "q_tab", torch.int64), rate_j=_t(x, "rate_j"),
        dt=_t(x, "dt").unsqueeze(1), credit_cap=_t(x, "credit_cap"),
        resident=_t(x, "resident"),
        page_valid=torch.from_numpy(spec.page_valid))


def _torch_io(spec, x):
    cc = TC.coop_consts(spec, "cpu")
    return TC.io_phase(
        cc, done=_t(x, "done"), cur_chunk=_t(x, "cur_chunk", torch.int64),
        inflight=_t(x, "inflight", torch.int64),
        pin_pages=_t(x, "pin_pages"), active=_t(x, "active"),
        start=_t(x, "start"), end=_t(x, "end"), cols=_t(x, "cols"),
        q_tab=_t(x, "q_tab", torch.int64), resident=_t(x, "resident"),
        free=_t(x, "free"), page_size=torch.from_numpy(spec.page_size),
        page_valid=torch.from_numpy(spec.page_valid))


def _assert_equal_out(got, want, what):
    """``got`` is the port's lane-major NamedTuple, ``want`` a list of the
    JAX package's per-lane NamedTuples with the same field names."""
    for name in type(want[0])._fields:
        g = getattr(got, name).numpy()
        w = np.stack([np.asarray(getattr(o, name)) for o in want])
        assert g.shape == w.shape, (what, name)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0,
                                       err_msg=f"{what} {name}")


def _keep_load_edge(spec, x):
    """Set each lane's ``free`` so that the first chunk with interest and
    missing bytes sits exactly on the Keep < Load boundary (pinning the
    lane's pages where the bytes held below it already exceed them)."""
    cc = JC.coop_consts(spec)

    def on_the_edge(lane):
        interest, _ = JC._interest(
            cc, jnp.asarray(x["active"][lane]), jnp.asarray(x["start"][lane]),
            jnp.asarray(x["end"][lane]), jnp.asarray(x["q_tab"][lane]),
            jnp.asarray(x["done"][lane]))
        interest = np.asarray(interest)
        count = interest.sum(0)
        ucols = (interest[:, :, None] & x["cols"][lane][:, None, :]).any(0)
        pc = spec.page_chunk
        missing = (~x["resident"][lane] & spec.page_valid
                   & ucols[pc, spec.page_col])
        mb = np.zeros(cc.n_chunks)
        np.add.at(mb, pc, np.where(missing, spec.page_size, 0.0))
        base = x["resident"][lane] & spec.page_valid & ~x["pin_pages"][lane]
        held = np.array([spec.page_size[base & (count[pc] < k)].sum()
                         for k in range(spec.n_streams + 2)])
        for c in np.flatnonzero((count > 0) & (mb > 0)):
            free = mb[c] - held[min(count[c], spec.n_streams + 1)]
            if free >= 0:
                x["free"][lane] = np.float32(free)
                assert float(np.float32(free)) == free   # exact in f32
                return True
        return False

    for lane in range(L):
        if not on_the_edge(lane):
            x["pin_pages"][lane] = spec.page_valid
            assert on_the_edge(lane), lane
    return x


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", ["micro", "tpch"])
def test_cpu_phase_equals_jax(kind, case):
    spec = _spec(kind)
    cc = JC.coop_consts(spec)
    x = _inputs(spec, case, seed=11)
    got = _torch_cpu(spec, x)
    want = [_jax_cpu(spec, cc, x, lane) for lane in range(L)]
    _assert_equal_out(got, want, f"cpu_phase {kind}/{case}")
    if case == "tied_pick":
        # every scan idle, every chunk available: ties at the pick, which
        # goes to the fewest interested scans and then the lowest id
        assert bool((got.cur_chunk >= 0).any() | got.done.any())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", ["micro", "tpch"])
def test_io_phase_equals_jax(kind, case):
    spec = _spec(kind)
    cc = JC.coop_consts(spec)
    x = _inputs(spec, case, seed=23)
    if case == "keep_load_edge":
        x["inflight"][:] = -1
        x = _keep_load_edge(spec, x)
    got = _torch_io(spec, x)
    want = [_jax_io(spec, cc, x, lane) for lane in range(L)]
    _assert_equal_out(got, want, f"io_phase {kind}/{case}")
    if case == "keep_load_edge":
        assert bool((got.inflight >= 0).all())


@pytest.mark.parametrize("kind", ["micro", "tpch"])
def test_interest_and_chunk_missing_equal_jax(kind):
    spec = _spec(kind)
    cc = JC.coop_consts(spec)
    tcc = TC.coop_consts(spec, "cpu")
    x = _inputs(spec, "random", seed=5)
    t_int, t_ov = TC._interest(
        tcc, _t(x, "active"), _t(x, "start"), _t(x, "end"),
        _t(x, "q_tab", torch.int64), _t(x, "done"))
    t_miss = TC._chunk_missing(tcc, _t(x, "cols"), _t(x, "resident"),
                               torch.from_numpy(spec.page_valid))
    for lane in range(L):
        j_int, j_ov = JC._interest(
            cc, jnp.asarray(x["active"][lane]), jnp.asarray(x["start"][lane]),
            jnp.asarray(x["end"][lane]), jnp.asarray(x["q_tab"][lane]),
            jnp.asarray(x["done"][lane]))
        j_miss = JC._chunk_missing(
            cc, jnp.asarray(x["cols"][lane]), jnp.asarray(x["resident"][lane]),
            jnp.asarray(spec.page_col), jnp.asarray(spec.page_valid),
            spec.n_cols)
        np.testing.assert_array_equal(t_int[lane].numpy(), np.asarray(j_int))
        np.testing.assert_array_equal(t_ov[lane].numpy(), np.asarray(j_ov))
        np.testing.assert_array_equal(t_miss[lane].numpy(),
                                      np.asarray(j_miss))


@pytest.mark.parametrize("kind", ["micro", "tpch"])
def test_chunk_horizon_equals_jax(kind):
    from repro.core.array_sim.policies import HorizonView as JH
    from repro_torch.core.array_sim.policies import HorizonView as TH

    spec = _spec(kind)
    x = _inputs(spec, "random", seed=7)
    dt_ref = float(np.float32(7.49e-4))
    got = TC.chunk_horizon(
        TC.coop_consts(spec, "cpu"), _torch_state(x),
        TH(spec=spec, active=_t(x, "active"), start=_t(x, "start"),
           end=_t(x, "end"), rate=_t(x, "rate_j"), dt_ref=dt_ref))
    for lane in range(L):
        cstate = JC.CoopState(
            done=jnp.asarray(x["done"][lane]),
            cur_chunk=jnp.asarray(x["cur_chunk"][lane]),
            chunk_pos=jnp.asarray(x["chunk_pos"][lane]),
            credit=jnp.asarray(x["credit"][lane]),
            inflight=jnp.int32(x["inflight"][lane]))
        want = JC.chunk_horizon(spec, cstate, JH(
            spec=spec, active=jnp.asarray(x["active"][lane]),
            start=jnp.asarray(x["start"][lane]),
            end=jnp.asarray(x["end"][lane]),
            rate=jnp.asarray(x["rate_j"][lane]), dt_ref=jnp.float32(dt_ref)))
        np.testing.assert_allclose(got[lane].numpy(), np.asarray(want),
                                   rtol=RTOL, atol=0)


def test_init_state_consts_pick_and_query_change_equal_jax():
    spec = _spec("tpch")
    j_st, t_st = JC.init_coop_state(spec), TC.init_coop_state(spec, L, "cpu")
    for name in JC.CoopState._fields:
        w = np.asarray(getattr(j_st, name))
        g = getattr(t_st, name).numpy()
        assert g.shape == (L,) + w.shape, name
        for lane in range(L):
            np.testing.assert_array_equal(g[lane], w, err_msg=name)
    j_cc, t_cc = JC.coop_consts(spec), TC.coop_consts(spec, "cpu")
    assert j_cc.n_chunks == t_cc.n_chunks
    for name in ("page_chunk", "chunk_first", "chunk_last", "chunk_table"):
        np.testing.assert_array_equal(getattr(t_cc, name).numpy(),
                                      np.asarray(getattr(j_cc, name)))
    rng = np.random.default_rng(3)
    prev, new = rng.integers(-1, 5, size=(2, 64)).astype(np.int32)
    np.testing.assert_array_equal(
        TC.chunk_pick(torch.from_numpy(prev), torch.from_numpy(new)).numpy(),
        np.asarray(JC.chunk_pick(jnp.asarray(prev), jnp.asarray(new))))
    done = rng.random((L, 5, 9)) < 0.5
    fin = rng.random((L, 5)) < 0.5
    got = TC.clear_on_query_change(torch.from_numpy(done),
                                   torch.from_numpy(fin)).numpy()
    for lane in range(L):
        np.testing.assert_array_equal(
            got[lane], np.asarray(JC.clear_on_query_change(
                jnp.asarray(done[lane]), jnp.asarray(fin[lane]))))


def test_a_spec_without_chunk_geometry_is_refused():
    bare = _spec("micro")._replace(page_chunk=None, n_chunks=0)
    with pytest.raises(ValueError, match="chunk geometry"):
        TC.coop_consts(bare, "cpu")
    with pytest.raises(ValueError, match="chunk geometry"):
        TC.init_coop_state(bare, 1, "cpu")
