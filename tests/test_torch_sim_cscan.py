"""The four-policy runner of the port — LRU, PBM, OPT and array-CScan in
one batched call — under both time engines, against the JAX package.

* a lane of the mixed batch equals the same lane run alone (a runner
  built for its policy only);
* whole runs against the JAX runner: inside the repo's array-vs-array
  bars (5 % at fractions >= 0.4, 12 % below), and equal where they are
  equal at this size;
* ``wake_exact=False`` gives the fixed stepper's results at a
  supersaturated point (the JAX package's own contract);
* the entry points default to the fixed stepper, as the JAX package's.

The port's step on the JAX package's own carry, step by step, is
``tests/test_torch_sim_lockstep.py``.
"""

import functools
import inspect

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import array_sim as J  # noqa: E402
from repro.core.workload import (  # noqa: E402
    make_lineitem_db, micro_accessed_bytes, micro_streams)
from repro_torch.core import array_sim as T  # noqa: E402

SCALE = 0.03
POLICIES = ("lru", "pbm", "opt", "cscan")
FRACS = (0.2, 0.4)
LANES = [(p, f) for p in POLICIES for f in FRACS]
IDS = [f"{p}@{f}" for p, f in LANES]
STEPPERS = ("fixed", "horizon")


@functools.lru_cache(maxsize=None)
def _workload():
    db = make_lineitem_db(scale_tuples=int(180_000_000 * SCALE))
    streams = micro_streams(db, n_streams=3, queries_per_stream=3, seed=3)
    return J.compile_workload(db, streams), micro_accessed_bytes(db), db, \
        streams


def _torch_cfgs(lanes=LANES):
    spec, ws = _workload()[:2]
    return T.stack_configs([
        T.make_config(spec, int(f * ws), 700e6, p, device="cpu")
        for p, f in lanes])


def _jax_cfgs(lanes=LANES):
    spec, ws = _workload()[:2]
    return J.stack_configs([
        J.make_config(spec, int(f * ws), 700e6, p) for p, f in lanes])


@functools.lru_cache(maxsize=None)
def _torch_run(stepper):
    spec = _workload()[0]
    runner = T.make_runner(spec, time_slice=0.1 * SCALE, policies=POLICIES,
                           stepper=stepper, device="cpu")
    state = runner(_torch_cfgs())
    return runner, state, [
        T.result_from_state(state, p, dt_ref=runner.dt_ref, lane=i)
        for i, (p, _f) in enumerate(LANES)]


@functools.lru_cache(maxsize=None)
def _jax_results(stepper):
    spec = _workload()[0]
    runner = J.make_runner(spec, time_slice=0.1 * SCALE, policies=POLICIES,
                           stepper=stepper)
    states = jax.block_until_ready(jax.vmap(runner)(_jax_cfgs()))
    return [
        J.result_from_state(jax.tree.map(lambda x: x[i], states), p,
                            dt_ref=runner.dt_ref)
        for i, (p, _f) in enumerate(LANES)]


# ------------------------------------------------ mixed batch vs solo ----

_CORE_FIELDS = [f for f in T.SimState._fields if f != "pstate"]


@pytest.mark.parametrize("stepper", STEPPERS)
@pytest.mark.parametrize("lane", range(len(LANES)), ids=IDS)
def test_mixed_lane_equals_the_same_lane_run_alone(lane, stepper):
    """One runner serves all four policies with no branch for any one of
    them: a lane of the mixed call is bit-equal to that lane run by a
    runner built for its policy alone (no cooperative substrate in it
    unless the lane is array-CScan)."""
    spec = _workload()[0]
    _, mixed, _ = _torch_run(stepper)
    pol = LANES[lane][0]
    runner = T.make_runner(spec, time_slice=0.1 * SCALE, policies=(pol,),
                           stepper=stepper, device="cpu")
    solo = runner(_torch_cfgs([LANES[lane]]))
    for name in _CORE_FIELDS:
        assert torch.equal(getattr(mixed, name)[lane:lane + 1],
                           getattr(solo, name)), name
    own = mixed.pstate[POLICIES.index(pol)]
    for m, s in zip(jax.tree.leaves(own), jax.tree.leaves(solo.pstate[0])):
        assert torch.equal(m[lane:lane + 1], s)


# --------------------------------------------------------- whole runs ----

@pytest.mark.parametrize("stepper", STEPPERS)
@pytest.mark.parametrize("lane", range(len(LANES)), ids=IDS)
def test_whole_run_within_the_bars_of_the_jax_runner(lane, stepper):
    got = _torch_run(stepper)[2][lane]
    want = _jax_results(stepper)[lane]
    tol = 0.12 if LANES[lane][1] < 0.4 else 0.05
    assert not got.extras["truncated"] and not want.extras["truncated"]
    assert got.policy == want.policy == LANES[lane][0]
    for name in ("avg_stream_time", "total_io_bytes", "total_loads"):
        a, b = getattr(got, name), getattr(want, name)
        assert abs(a / b - 1.0) <= tol, (name, a, b)


@pytest.mark.parametrize("stepper", STEPPERS)
def test_whole_run_equality_with_jax_where_it_holds(stepper):
    """At this size every lane of both steppers agrees with the JAX runner
    exactly on the integer results and on the f32 ones to the last
    place (at the calibrated scale they part by rounding and are held to
    the bars instead)."""
    got, want = _torch_run(stepper)[2], _jax_results(stepper)
    for (p, f), a, b in zip(LANES, got, want):
        assert a.total_loads == b.total_loads, (p, f)
        assert a.steps == b.steps, (p, f)
        assert a.extras["slices_done"] == b.extras["slices_done"], (p, f)
        assert a.extras["churn_loads"] == b.extras["churn_loads"], (p, f)
        assert a.total_io_bytes == b.total_io_bytes, (p, f)
        np.testing.assert_allclose(a.stream_times, b.stream_times, rtol=1e-6)


def test_cscan_beats_the_in_order_policies_on_io():
    """The paper's headline at a small pool: cooperative scans load less
    than LRU, PBM and OPT (here at 0.2 of the working set)."""
    res = {LANES[i]: r for i, r in enumerate(_torch_run("fixed")[2])}
    cs = res[("cscan", 0.2)]
    for pol in ("lru", "pbm", "opt"):
        assert cs.total_io_bytes < res[(pol, 0.2)].total_io_bytes, pol


# ------------------------------------------------ wake_exact=False ------

def test_never_jump_equals_the_fixed_stepper_at_a_saturated_point():
    spec, ws = _workload()[:2]
    cap = int(0.1 * ws)
    assert cap < spec.n_streams * 8 * float(np.max(spec.page_size))
    lanes = [(p, 0.1) for p in ("lru", "pbm", "opt")]
    runs = {}
    for tag, kw in (("fixed", dict(stepper="fixed")),
                    ("off", dict(stepper="horizon", wake_exact=False)),
                    ("on", dict(stepper="horizon", wake_exact=True))):
        runner = T.make_runner(spec, time_slice=0.1 * SCALE,
                               policies=("lru", "pbm", "opt"), device="cpu",
                               **kw)
        runs[tag] = runner(_torch_cfgs(lanes))
    for name in ("io_bytes", "loads", "churn"):
        assert torch.equal(getattr(runs["fixed"], name),
                           getattr(runs["off"], name)), name
    # finish times too, for LRU and PBM: OPT's differ in the last place
    # here, as the JAX package's do at this point (the two cadences add
    # up the clock in different float sums)
    assert torch.equal(runs["fixed"].stream_done_t[:2],
                       runs["off"].stream_done_t[:2])
    assert bool((runs["on"].steps <= runs["off"].steps).all())
    assert bool((runs["on"].steps < runs["off"].steps).any())


# ------------------------------------------------------------ defaults ----

@pytest.mark.parametrize("fn", [T.make_step, T.make_runner,
                                T.run_workload_array],
                         ids=["make_step", "make_runner",
                              "run_workload_array"])
def test_entry_points_default_to_the_fixed_stepper(fn):
    assert inspect.signature(fn).parameters["stepper"].default == "fixed"
    ref = getattr(J, fn.__name__)
    assert inspect.signature(ref).parameters["stepper"].default == "fixed"


def test_default_runner_is_the_fixed_stepper_with_every_policy():
    spec, ws, db, streams = _workload()
    runner = T.make_runner(spec, time_slice=0.1 * SCALE, device="cpu")
    assert runner.stepper == "fixed"
    assert runner.policy_names == ("lru", "cscan", "pbm", "opt")
    got = T.run_workload_array(db, streams, "cscan",
                               capacity_bytes=int(0.2 * ws),
                               time_slice=0.1 * SCALE, spec=spec,
                               device="cpu")
    want = _torch_run("fixed")[2][LANES.index(("cscan", 0.2))]
    assert got.total_loads == want.total_loads
    assert got.stream_times == want.stream_times
