"""``make_runner(sanitize=True)`` and ``repro_torch.analysis.sanitize``.

On the CPU, at the tiny telemetry point (2 M tuples, 2 streams x 1
query, 16 MiB, the four policies as four lanes) under both steppers:

* a sanitized run equals the plain run in every carried leaf, reads the
  device as often (``stats["host_reads"]``), and counts one config
  signature for the four-policy sweep;
* a NaN in the scores handed to B1, and an index leaf outside its
  extent, each raise ``SanitizeError`` naming the leaf and the lane;
* a config whose signature differs from the first call's raises
  ``RuntimeError``, and ``sanitize`` with ``mesh`` ``ValueError``;
* the manifest reads ``runner.sanitize``.

The ``gpu``-marked test runs the sanitized smoke sweep on the card
(``pytest -m gpu tests/test_torch_sanitize.py``).
"""

import os

import pytest
import torch

from repro_torch.analysis.sanitize import sanitize_smoke
from repro_torch.core import array_sim as T
from repro_torch.core import workload as TW
from repro_torch.core.array_sim import sim as sim_mod
from repro_torch.core.array_sim.policies import ArrayLRU
from repro_torch.obs import collect_manifest

POLICIES = ("lru", "cscan", "pbm", "opt")
STEPPERS = ("fixed", "horizon")


@pytest.fixture(scope="module")
def spec():
    db = TW.make_lineitem_db(scale_tuples=2_000_000)
    streams = TW.micro_streams(db, n_streams=2, queries_per_stream=1, seed=3)
    return T.compile_workload(db, streams)


def _cfgs(spec, policies=POLICIES):
    return T.stack_configs([T.make_config(spec, 16 << 20, 700e6, p,
                                          device="cpu") for p in policies])


def _run(spec, stepper, sanitize, telemetry=False, policies=None):
    runner = T.make_runner(spec, time_slice=0.01, stepper=stepper,
                           sanitize=sanitize, telemetry=telemetry,
                           policies=policies, device="cpu")
    out = runner(_cfgs(spec))
    return runner, out


@pytest.mark.parametrize("telemetry", [False, True], ids=["plain", "tele"])
@pytest.mark.parametrize("stepper", STEPPERS)
def test_sanitized_run_equals_the_plain_run_and_reads_no_more(
        spec, stepper, telemetry):
    plain, a = _run(spec, stepper, False, telemetry)
    san, b = _run(spec, stepper, True, telemetry)
    la, lb = sim_mod._carry_leaves(a if telemetry else (a,)), \
        sim_mod._carry_leaves(b if telemetry else (b,))
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    assert san.stats["host_reads"] == plain.stats["host_reads"] > 0
    assert san.stats["cheap_steps"] == plain.stats["cheap_steps"]
    assert san.trace_count() == plain.trace_count() == 1
    assert san.sanitize is True and plain.sanitize is False
    assert san.stats["neg_zero_keys"] == [0, 0, 0, 0]
    assert "neg_zero_keys" not in plain.stats


class _NanLane1(ArrayLRU):
    """LRU whose scores hold a NaN in lane 1."""

    def score_victims(self, pstate, ctx):
        s = super().score_victims(pstate, ctx).clone()
        s[1, 3] = float("nan")
        return s


@pytest.mark.parametrize("stepper", STEPPERS)
def test_a_nan_score_raises_naming_the_leaf_and_the_lane(spec, stepper):
    runner = T.make_runner(spec, time_slice=0.01, stepper=stepper,
                           sanitize=True, policies=(_NanLane1(),),
                           device="cpu")
    with pytest.raises(T.sim.SanitizeError,
                       match=r"a NaN in leaf `B1\.keys` of lane 1 at its "
                             r"step 1"):
        runner(_cfgs(spec, ("lru", "lru")))
    # the same policy without the sanitizer runs on with the NaN
    plain = T.make_runner(spec, time_slice=0.01, stepper=stepper,
                          policies=(_NanLane1(),), device="cpu")
    plain(_cfgs(spec, ("lru", "lru")))


@pytest.mark.parametrize("stepper", STEPPERS)
def test_an_index_out_of_its_extent_raises(spec, stepper, monkeypatch):
    real = sim_mod.init_state

    def bad_state(*args, **kw):
        st = real(*args, **kw)
        tie = st.req_tie.clone()
        tie[2, -1] = 40_000          # beyond the 15-bit tie rank
        return st._replace(req_tie=tie)

    monkeypatch.setattr(sim_mod, "init_state", bad_state)
    runner = T.make_runner(spec, time_slice=0.01, stepper=stepper,
                           sanitize=True, device="cpu")
    with pytest.raises(T.sim.SanitizeError,
                       match=r"an index outside \[0, extent\) in leaf "
                             r"`state\.req_tie` of lane 2 at its step 1"):
        runner(_cfgs(spec))


def test_a_changed_config_signature_raises(spec):
    runner = T.make_runner(spec, time_slice=0.01, stepper="horizon",
                           sanitize=True, device="cpu")
    runner(_cfgs(spec, ("lru", "pbm")))
    runner(_cfgs(spec, ("opt", "cscan")))      # the same signature
    assert runner.trace_count() == 1
    with pytest.raises(RuntimeError, match="2 jit traces for one runner"):
        runner(_cfgs(spec, ("lru", "pbm", "opt")))
    # a plain runner counts the signatures and runs on
    plain = T.make_runner(spec, time_slice=0.01, stepper="horizon",
                          device="cpu")
    plain(_cfgs(spec, ("lru",)))
    plain(_cfgs(spec, ("lru", "pbm")))
    assert plain.trace_count() == 2


def test_sanitize_with_a_mesh_raises(spec):
    mesh = T.Mesh(["cpu", "cpu"], ("lanes",))
    with pytest.raises(ValueError, match="does not compose with mesh="):
        T.make_runner(spec, mesh=mesh, sanitize=True, device="cpu")
    runner = T.make_runner(spec, mesh=mesh, time_slice=0.01, device="cpu")
    runner(_cfgs(spec))
    assert runner.sanitize is False and runner.trace_count() == 1


def test_the_manifest_reads_the_runner(spec):
    runner, _ = _run(spec, "horizon", True)
    man = collect_manifest(spec=spec, runner=runner)
    assert man["sanitize"] is True and man["trace_count"] == 1


def test_the_smoke_refuses_to_run_without_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        sanitize_smoke(log=None)


@pytest.mark.gpu
def test_cuda_sanitize_smoke_is_clean():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card: "
                    "pytest -m gpu tests/test_torch_sanitize.py)")
    rows = []
    failures = sanitize_smoke(log=None, device="cuda", rows=rows)
    assert failures == []
    assert len(rows) == 4 and all(r["signatures"] == 1 for r in rows)
    print(os.linesep.join(map(str, rows)))
