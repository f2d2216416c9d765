"""The port's flight recorder (``repro_torch.obs.trace``) against the JAX
package's.

* at scale 0.03, where the port's runs equal the JAX package's, the
  ``TraceSession`` event list and its Chrome export are EQUAL to the JAX
  package's (four policies, both steppers among them);
* at the trace CLI's default point (scale 0.1 of SF1 lineitem, 4 x 4
  streams, seed 3, pbm at 0.4) the recorded eviction total equals the
  telemetry runner's ``evictions`` counter (the same steps, host-looped
  against device-looped) with the same final clock, and is within
  ``ERROR_BARS[(0.4, "pbm")]`` of the port's event engine and of the JAX
  package's ``TraceSession`` (equality is not asked there: ROADMAP §C's
  rounding drift may reach that point);
* the fixed stepper records fine and refresh steps;
* ``serving_events_to_chrome`` equals the JAX output on the same
  ``ServingEngine(record_events=True)`` events;
* the CLI writes the trace and the manifest.
"""

import functools
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import array_sim as J  # noqa: E402
from repro.core import workload as JW  # noqa: E402
from repro.obs import trace as JT  # noqa: E402
from repro_torch.core import EngineConfig, run_workload  # noqa: E402
from repro_torch.core import array_sim as T  # noqa: E402
from repro_torch.core import workload as TW  # noqa: E402
from repro_torch.core.array_sim.validate import ERROR_BARS  # noqa: E402
from repro_torch.obs import trace as TT  # noqa: E402

SCALE = 0.03
CASES = [("pbm", 0.4, "horizon"), ("lru", 0.2, "horizon"),
         ("opt", 0.2, "fixed"), ("cscan", 0.2, "horizon")]


@functools.lru_cache(maxsize=None)
def _workload():
    db = JW.make_lineitem_db(scale_tuples=int(180_000_000 * SCALE))
    streams = JW.micro_streams(db, n_streams=3, queries_per_stream=3, seed=3)
    return J.compile_workload(db, streams), JW.micro_accessed_bytes(db)


@pytest.mark.parametrize("policy,frac,stepper", CASES,
                         ids=[f"{p}@{f}-{s}" for p, f, s in CASES])
def test_trace_equals_the_jax_package(policy, frac, stepper):
    spec, ws = _workload()
    kw = dict(policies=(policy,), stepper=stepper, time_slice=0.1 * SCALE)
    want = JT.TraceSession(spec, **kw)
    want_state = want.run(J.make_config(spec, int(frac * ws), 700e6, policy))
    got = TT.TraceSession(spec, device="cpu", **kw)
    got_state = got.run(T.make_config(spec, int(frac * ws), 700e6, policy,
                                      device="cpu"))
    assert len(got.events) == int(got_state.steps[0]) > 0
    assert got.events == want.events
    assert got.to_chrome() == want.to_chrome()
    assert float(got_state.t[0]) == float(want_state.t)
    assert got.eviction_total() > 0


@functools.lru_cache(maxsize=None)
def _default_point():
    """The trace CLI's default point, recorded and run by the runner."""
    spec, cap = TT._build_point(0.1, 4, 4, 3, 0.4)
    cfg = T.make_config(spec, cap, 700e6, "pbm", device="cpu")
    sess = TT.TraceSession(spec, policies=("pbm",), device="cpu")
    state = sess.run(cfg)
    runner = T.make_runner(spec, bandwidth_ref=700e6, time_slice=0.1,
                           policies=("pbm",), stepper="horizon",
                           telemetry=True, device="cpu")
    st, tele = runner(cfg)
    return spec, cap, sess, state, st, tele


def test_trace_reconstructs_the_runners_eviction_count():
    _, _, sess, state, st, tele = _default_point()
    te = sess.eviction_total()
    assert te > 0, "the point must induce evictions to test anything"
    assert te == int(tele.evictions[0])
    assert float(st.t[0]) == float(state.t[0])
    assert len(sess.events) == int(st.steps[0])
    chrome = sess.to_chrome()
    xs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    assert sum(e["args"]["evicted"] for e in xs) == te
    assert all(e["dur"] > 0 for e in xs)
    assert any(e["ph"] == "C" for e in chrome["traceEvents"])


@pytest.mark.parametrize("reference", ["port_event_engine", "jax_trace"])
def test_trace_evictions_within_the_bar(reference):
    _, cap, sess, _, _, _ = _default_point()
    te = sess.eviction_total()
    if reference == "port_event_engine":
        db = TW.make_lineitem_db(scale_tuples=int(6_001_215 * 0.1))
        streams = TW.micro_streams(db, n_streams=4, queries_per_stream=4,
                                   seed=3)
        ref = run_workload(db, streams, "pbm", EngineConfig(
            bandwidth=700e6, buffer_bytes=cap, sample_interval=2.0,
            pbm_time_slice=0.1)).total_evictions
    else:
        spec, jcap = JT._build_point(0.1, 4, 4, 3, 0.4)
        assert jcap == cap
        jsess = JT.TraceSession(spec, policies=("pbm",))
        jsess.run(J.make_config(spec, cap, 700e6, "pbm"))
        ref = jsess.eviction_total()
    bar = ERROR_BARS[(0.4, "pbm")]
    assert abs(te - ref) <= max(2, bar * ref), (te, ref)


def test_trace_session_fixed_stepper_runs():
    db = TW.make_lineitem_db(scale_tuples=2_000_000)
    streams = TW.micro_streams(db, n_streams=2, queries_per_stream=1, seed=3)
    spec = T.compile_workload(db, streams)
    sess = TT.TraceSession(spec, policies=("lru",), stepper="fixed",
                           time_slice=0.01, device="cpu")
    state = sess.run(T.make_config(spec, 16 << 20, 700e6, "lru",
                                   device="cpu"))
    assert sess.events and len(sess.events) == int(state.steps[0])
    assert all(e["kind"] in ("fine", "refresh") for e in sess.events)
    assert all(e["h"] == 1 for e in sess.events)


def test_trace_session_records_one_lane():
    spec, cap = TT._build_point(0.1, 4, 4, 3, 0.4)
    sess = TT.TraceSession(spec, policies=("pbm",), device="cpu")
    two = T.stack_configs([T.make_config(spec, cap, 700e6, "pbm",
                                         device="cpu")] * 2)
    with pytest.raises(ValueError, match="one lane"):
        sess.run(two)


def _serve(pkg, policy):
    eng = pkg.ServingEngine(
        pkg.PagePool(n_pages=8, page_size=4, page_bytes=256),
        lambda reqs: [0 for _ in reqs], policy=policy, max_batch=4,
        record_events=True)
    for i in range(4):      # rid given: each package counts its own
        eng.submit(pkg.Request(prompt=[1, 2, 3, 4, 5, 6], max_new_tokens=12,
                               rid=i))
    eng.run_to_completion(max_steps=500)
    return eng.events


@pytest.mark.parametrize("policy", ["lru", "cscan", "pbm", "opt"])
def test_serving_events_to_chrome_equals_the_jax_output(policy):
    import repro.serving as jserving
    import repro_torch.serving as tserving

    got, want = _serve(tserving, policy), _serve(jserving, policy)
    assert got == want and any(e["kind"] == "preempt" for e in got)
    chrome = TT.serving_events_to_chrome(got, label=policy)
    assert chrome == JT.serving_events_to_chrome(want, label=policy)
    assert sum(1 for e in chrome["traceEvents"] if e["ph"] == "i") == len(got)


def test_trace_cli_writes_the_trace_and_the_manifest(tmp_path, capsys):
    out, man = tmp_path / "trace.json", tmp_path / "manifest.json"
    assert TT.main(["--scale", "0.05", "--out", str(out), "--manifest",
                    str(man), "--device", "cpu"]) == 0
    trace = json.loads(out.read_text())
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    manifest = json.loads(man.read_text())
    assert manifest["macro_steps"] == len(xs) > 0
    assert manifest["evictions"] == sum(e["args"]["evicted"] for e in xs)
    assert manifest["device"] == "cpu" and manifest["policy"] == "pbm"
    assert len(manifest["spec_hash"]) == 12
    assert "macro-steps" in capsys.readouterr().out


def test_eviction_totals_are_integers_of_the_residency_diff():
    _, _, sess, _, _, _ = _default_point()
    ev = np.array([e["evicted"] for e in sess.events])
    assert ev.dtype.kind == "i" and (ev >= 0).all()
    assert sum(e["loads"] for e in sess.events) > 0
