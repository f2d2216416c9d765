"""The port's carried telemetry (``repro_torch.obs.counters`` and
``make_runner(telemetry=True)``) against the JAX package's.

* ``log2_bin`` (bit length, integer comparisons) equals the JAX function;
* telemetry off is bit-equal to on, and to a runner built without the
  knob, for the four policies under both steppers;
* the integer counters, the integer-valued policy rows (PBM's bucket
  occupancy, OPT's referenced / unreferenced split, CScan's row) and the
  ``summarize`` dicts EQUAL the JAX package's at the tiny point of
  ``tests/test_obs.py`` and at scale 0.03; LRU's resident age mass is an
  f32 sum of f32 ages whose value depends on the order of the sum, and is
  held at rtol 1e-5 (the port sums it in float64 and rounds once);
* ``sum(jump_hist) == macro_steps`` and ``loads`` equal the state's in
  every lane of a mixed 24-lane sweep whose lanes end at very different
  times (a frozen lane adds nothing);
* ``spec_hash`` gives the JAX package's 12 hex characters, and the
  manifest has the port's keys.

The JAX side runs in a process of its own with XLA's algebraic
simplifier off (as ``tests/test_torch_sim_lockstep.py``): with it on, XLA
rewrites a division by a constant into a product with the reciprocal,
and at scale 0.03 one PBM lane then holds a page one bucket later for a
few steps — the occupancy row differs (257 / 138 against 259 / 136 in
buckets 2 / 3) while every result and counter is equal.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.obs import counters as JO  # noqa: E402
from repro_torch.core import array_sim as T  # noqa: E402
from repro_torch.core import workload as TW  # noqa: E402
from repro_torch.obs import counters as TO  # noqa: E402
from repro_torch.obs import collect_manifest, spec_hash  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICIES = ("lru", "cscan", "pbm", "opt")      # resolve_policies(None)
STEPPERS = ("fixed", "horizon")
POINTS = ("tiny", "scale_0.03")
INT_FIELDS = [f for f in JO.Telemetry._fields if f != "pol_obs"]


def _point(name, W):
    """``(db, streams, time_slice, lanes)``: the tiny point of
    ``tests/test_obs.py`` (every policy at 16 MiB), or scale 0.03 of the
    micro workload (the four policies at 0.2 and 0.4 of the working set)."""
    if name == "tiny":
        db = W.make_lineitem_db(scale_tuples=2_000_000)
        streams = W.micro_streams(db, n_streams=2, queries_per_stream=1,
                                  seed=3)
        return db, streams, 0.01, [(p, 16 << 20) for p in POLICIES]
    scale = 0.03
    db = W.make_lineitem_db(scale_tuples=int(180_000_000 * scale))
    streams = W.micro_streams(db, n_streams=3, queries_per_stream=3, seed=3)
    ws = W.micro_accessed_bytes(db)
    return db, streams, 0.1 * scale, [
        (p, int(f * ws)) for p in POLICIES for f in (0.2, 0.4)]


def _tele_to_lists(tele):
    out = {f: np.asarray(getattr(tele, f)).tolist() for f in INT_FIELDS}
    out["pol_obs"] = [np.asarray(r).tolist() for r in tele.pol_obs]
    return out


def _jax_side():
    """The JAX package's telemetry runs (the child process's work)."""
    from repro.core import array_sim as J
    from repro.core import workload as JW

    out = {}
    for name in POINTS:
        db, streams, ts, lanes = _point(name, JW)
        spec = J.compile_workload(db, streams)
        for stepper in STEPPERS:
            runner = J.make_runner(spec, time_slice=ts, stepper=stepper,
                                   telemetry=True)
            cfgs = J.stack_configs([J.make_config(spec, c, 700e6, p)
                                    for p, c in lanes])
            states, tele = jax.block_until_ready(jax.vmap(runner)(cfgs))
            out[f"{name}/{stepper}"] = {
                "tele": _tele_to_lists(tele),
                "steps": np.asarray(states.steps).tolist(),
                "summaries": [
                    JO.summarize(JO.lane_slice(tele, i),
                                 policies=runner.policy_names,
                                 steps=int(states.steps[i]))
                    for i in range(len(lanes))]}
    db, streams, ts, _ = _point("tiny", JW)
    res = J.run_workload_array(db, streams, "pbm", capacity_bytes=16 << 20,
                               time_slice=ts, stepper="horizon",
                               telemetry=True)
    out["run_workload_array"] = res.extras["telemetry"]
    return out


@functools.lru_cache(maxsize=None)
def _jax():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_disable_hlo_passes=algsimp",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH",
                                                              "")]))
    out = subprocess.run([sys.executable, __file__], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-8000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@functools.lru_cache(maxsize=None)
def _torch(name, stepper, telemetry):
    """The port's run of a point: ``(runner, state, tele)``; ``telemetry``
    is True, False, or None for a runner built without the knob."""
    db, streams, ts, lanes = _point(name, TW)
    spec = T.compile_workload(db, streams)
    kw = {} if telemetry is None else {"telemetry": telemetry}
    runner = T.make_runner(spec, time_slice=ts, stepper=stepper,
                           device="cpu", **kw)
    out = runner(T.stack_configs([T.make_config(spec, c, 700e6, p,
                                                device="cpu")
                                  for p, c in lanes]))
    state, tele = out if telemetry else (out, None)
    return runner, state, tele


def _leaves(tree, prefix=""):
    if torch.is_tensor(tree):
        yield prefix, tree
    elif hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{prefix}.{f}")
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")


# ------------------------------------------------------------ log2_bin ----

@pytest.mark.parametrize("lo,hi", [(0, 1 << 20), (-(1 << 20), 1),
                                   ((1 << 31) - (1 << 16), (1 << 31) - 1)],
                         ids=["0..2^20", "negative", "top_of_int32"])
def test_log2_bin_equals_the_jax_function(lo, hi):
    x = np.arange(lo, hi, dtype=np.int64).astype(np.int32)
    want = np.asarray(JO.log2_bin(x))
    got = TO.log2_bin(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() <= TO.N_BINS - 1


# ----------------------------------------------- telemetry off is free ----

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("stepper", STEPPERS)
def test_telemetry_off_is_bit_equal_to_on(stepper, policy):
    """Every SimState leaf of a lane (its policy state included) is equal
    with telemetry on, off, and in a runner built without the knob; the
    counters agree with the state's own counts."""
    lane = POLICIES.index(policy)
    r_on, on, tele = _torch("tiny", stepper, True)
    r_off, off, _ = _torch("tiny", stepper, False)
    _, plain, _ = _torch("tiny", stepper, None)
    assert r_on.telemetry is True and r_off.telemetry is False
    for (name, a), (_, b), (_, c) in zip(_leaves(on), _leaves(off),
                                         _leaves(plain)):
        assert torch.equal(a[lane], b[lane]), name
        assert torch.equal(a[lane], c[lane]), name
    assert int(tele.loads[lane]) == int(on.loads[lane])
    assert int(tele.jump_hist[lane].sum()) == int(on.steps[lane])
    assert int(tele.hits[lane]) + int(tele.misses[lane]) > 0
    for f in INT_FIELDS:
        assert getattr(tele, f).dtype == torch.int32, f


# ------------------------------------------ counters vs the JAX package ----

@pytest.mark.parametrize("stepper", STEPPERS)
@pytest.mark.parametrize("point", POINTS)
def test_counters_equal_the_jax_package(point, stepper):
    runner, state, tele = _torch(point, stepper, True)
    want = _jax()[f"{point}/{stepper}"]
    assert state.steps.tolist() == want["steps"]
    got = _tele_to_lists(tele)
    for f in INT_FIELDS:
        assert got[f] == want["tele"][f], f
    lanes = _point(point, TW)[3]
    for j, name in enumerate(runner.policy_names):
        g = np.asarray(got["pol_obs"][j])
        w = np.asarray(want["tele"]["pol_obs"][j])
        assert g.shape == w.shape, name
        if name == "lru":
            # the resident age mass: an f32 sum whose order differs
            np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=1e-5)
            np.testing.assert_array_equal(g[:, 1], w[:, 1])
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
        # a lane of another policy adds nothing to this policy's row
        other = [i for i, (p, _c) in enumerate(lanes) if p != name]
        assert not g[other].any(), name
    for i in range(len(lanes)):
        got_s = TO.summarize(TO.lane_slice(tele, i),
                             policies=runner.policy_names,
                             steps=int(state.steps[i]))
        want_s = want["summaries"][i]
        lru_g = got_s.get("policy_obs", {}).pop("lru", None)
        lru_w = want_s.get("policy_obs", {}).pop("lru", None)
        assert got_s == want_s, lanes[i]
        if lru_w is not None:
            np.testing.assert_allclose(lru_g, lru_w, rtol=1e-5)


def test_run_workload_array_summary_equals_the_jax_package():
    db, streams, ts, _ = _point("tiny", TW)
    res = T.run_workload_array(db, streams, "pbm", capacity_bytes=16 << 20,
                               time_slice=ts, stepper="horizon",
                               telemetry=True, device="cpu")
    t = res.extras["telemetry"]
    assert t == _jax()["run_workload_array"]
    assert sum(t["jump_hist"]) == res.extras["macro_steps"]
    assert len(t["jump_hist"]) == TO.N_BINS
    assert "pbm" in t["policy_obs"]


# ------------------------------------- the identities in a mixed sweep ----

FRACS = (0.1, 0.2, 0.4, 0.6, 0.8, 1.0)
MIXED = [(p, f) for p in ("lru", "pbm", "opt", "cscan") for f in FRACS]


@functools.lru_cache(maxsize=None)
def _mixed():
    scale = 0.03
    db = TW.make_lineitem_db(scale_tuples=int(180_000_000 * scale))
    streams = TW.micro_streams(db, n_streams=3, queries_per_stream=3, seed=3)
    ws = TW.micro_accessed_bytes(db)
    spec = T.compile_workload(db, streams)
    cfgs = T.stack_configs([T.make_config(spec, int(f * ws), 700e6, p,
                                          device="cpu") for p, f in MIXED])
    runner = T.make_runner(spec, time_slice=0.1 * scale, stepper="horizon",
                           telemetry=True, device="cpu")
    return runner(cfgs)


@pytest.mark.parametrize("lane", range(len(MIXED)),
                         ids=[f"{p}@{f}" for p, f in MIXED])
def test_identities_hold_in_every_lane_of_a_mixed_sweep(lane):
    """lru@0.1 takes several times the macro-steps of cscan@1.0: lanes that
    finished early are frozen, and their counters with them."""
    state, tele = _mixed()
    steps = state.steps.tolist()
    assert max(steps) > 3 * min(steps)
    assert int(tele.jump_hist[lane].sum()) == steps[lane]
    assert int(tele.loads[lane]) == int(state.loads[lane])
    assert int(tele.evict_rank[lane].sum()) == int(tele.evictions[lane])
    assert int(tele.misses[lane]) == int(state.loads_demand[lane])
    policy = MIXED[lane][0]
    assert (int(tele.chunk_picks[lane]) > 0) == (policy == "cscan")


def test_a_policy_without_a_row_keeps_a_zero_width_one():
    """``observe_init`` = None: an ``(L, 0)`` row that the per-lane freeze
    and ``summarize`` pass through."""
    from repro_torch.core.array_sim import ArrayLRU

    class Plain(ArrayLRU):
        def observe_init(self, spec, lanes, device):
            return None

    db, streams, ts, lanes = _point("tiny", TW)
    spec = T.compile_workload(db, streams)
    runner = T.make_runner(spec, time_slice=ts, stepper="horizon",
                           policies=(Plain(), "pbm"), telemetry=True,
                           device="cpu")
    cfgs = T.stack_configs([T.make_config(spec, 16 << 20, 700e6, p,
                                          device="cpu")
                            for p in ("lru", "pbm", "lru")])
    state, tele = runner(cfgs)
    assert tele.pol_obs[0].shape == (3, 0)
    s = TO.summarize(TO.lane_slice(tele, 0), policies=runner.policy_names,
                     steps=int(state.steps[0]))
    assert "policy_obs" not in s           # pbm's row is zero in lane 0
    assert "pbm" in TO.summarize(TO.lane_slice(tele, 1),
                                 policies=runner.policy_names)["policy_obs"]


# --------------------------------------------------------- provenance ----

@pytest.mark.parametrize("workload", ["tiny", "scale_0.03", "tpch"])
def test_spec_hash_equals_the_jax_value(workload):
    from repro.core import array_sim as J
    from repro.core import workload as JW
    from repro.obs import spec_hash as j_spec_hash

    def spec_of(W, C):
        if workload == "tpch":
            db = W.make_tpch_db(scale=0.01)
            return C.compile_workload(db, W.tpch_streams(db, n_streams=3,
                                                         seed=7))
        db, streams, _, _ = _point(workload, W)
        return C.compile_workload(db, streams)

    got = spec_hash(spec_of(TW, T))
    assert len(got) == 12
    assert got == j_spec_hash(spec_of(JW, J))


def test_manifest_fields():
    runner, _, _ = _torch("tiny", "horizon", True)
    db, streams, _, _ = _point("tiny", TW)
    spec = T.compile_workload(db, streams)
    man = collect_manifest(spec=spec, runner=runner, extra_key="x")
    assert set(man) == {"git_sha", "python", "torch", "cuda", "platform",
                        "device", "spec_hash", "stepper", "sanitize",
                        "trace_count", "extra_key"}
    assert man["sanitize"] is False and man["trace_count"] == 1
    for key in ("git_sha", "python", "torch", "platform"):
        assert man[key], key
    assert man["torch"] == torch.__version__
    assert man["cuda"] == torch.version.cuda
    assert man["device"] == "cpu"
    assert man["spec_hash"] == spec_hash(spec)
    assert man["stepper"] == "horizon"
    assert man["extra_key"] == "x"
    other = T.compile_workload(*_point("scale_0.03", TW)[:2])
    assert spec_hash(other) != man["spec_hash"]


if __name__ == "__main__":
    print(json.dumps(_jax_side()))
