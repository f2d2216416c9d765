"""The simulator's runner as replays of captured steps (``sim._Replays``).

On a CUDA device ``make_runner`` captures each step variant its loop nest
takes as a CUDA graph and replays it: the port's counterpart of the JAX
runner's ``jax.jit``.  A graph cannot be captured on the CPU, so these
tests stand a graph in by a body that the replay runs again (with the
kernels' launch counts held still, as a real replay runs no Python), and
drive the same machinery on CPU tensors: the static buffers, the outputs
copied back into the carry's buffers, the loop conditions computed inside
the body, the host's one read between two replays, the sanitizer's
checks inside the body, the launch accounting.  At the tiny telemetry
point (2 M tuples, 2 streams x 1 query, 16 MiB, the four policies) the
replayed run is held to the eager loop the CPU runs: every state leaf
bit-equal, and the same steps, host reads, -0.0 keys and launch counts.

The ``gpu``-marked tests hold the real graphs to the eager steps on the
card (``pytest -m gpu tests/test_torch_sim_graphs.py``).
"""

import pytest
import torch

from repro_torch.core import array_sim as T
from repro_torch.core import workload as TW
from repro_torch.core.array_sim import sim as sim_mod
from repro_torch.core.array_sim.policies import ArrayLRU
from repro_torch.kernels import ops, pbm_timeline

POLICIES = ("lru", "cscan", "pbm", "opt")
STEPPERS = ("fixed", "horizon")
SIM_KERNELS = ("batched_evict", "fifo_grant", "wake_solve")


def _state_tensors(rep):
    """Every tensor a body writes: the runner's buffers, the sanitizer's."""
    b = rep.bufs
    out = sim_mod._tree_leaves(b["carry"]) + [
        b[k] for k in ("live", "inner", "n_live", "n_in")]
    if b["san"] is not None:
        out += [b["san"].hit, b["san"].neg_zero, *b["san"].first.values()]
    return out


class StandInGraph:
    """A captured body that a replay runs again, its kernels' launch
    counts held still (a CUDA graph's replay runs no wrapper).  Its
    capture runs the body as a capture runs the Python, for the launch
    counts, and leaves the buffers as they were: a capture computes
    nothing."""

    captures = 0

    def __init__(self, body, stream, pool):
        StandInGraph.captures += 1
        self.body = body
        rep = next(c.cell_contents for c in body.__closure__
                   if isinstance(c.cell_contents, sim_mod._Replays))
        kept = [t.clone() for t in _state_tensors(rep)]
        before = ops.launch_counts()
        body()
        self.counted = {k: n - before[k]
                        for k, n in ops.launch_counts().items()}
        for t, k in zip(_state_tensors(rep), kept):
            t.copy_(k)

    def replay(self):
        before = ops.launch_counts()
        self.body()
        ops.reset_launch_counts()
        ops.add_launch_counts(before)


@pytest.fixture
def replayed(monkeypatch):
    monkeypatch.setattr(sim_mod, "_captures", lambda dev: True)
    monkeypatch.setattr(sim_mod, "_CudaGraph", StandInGraph)


@pytest.fixture(scope="module")
def spec():
    db = TW.make_lineitem_db(scale_tuples=2_000_000)
    streams = TW.micro_streams(db, n_streams=2, queries_per_stream=1, seed=3)
    return T.compile_workload(db, streams)


def _cfgs(spec, policies=POLICIES):
    return T.stack_configs([T.make_config(spec, 16 << 20, 700e6, p,
                                          device="cpu") for p in policies])


def _leaves(out, telemetry):
    return sim_mod._carry_leaves(out if telemetry else (out,))


def _assert_equal(a, b, telemetry):
    la, lb = _leaves(a, telemetry), _leaves(b, telemetry)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def _run(spec, stepper, **kw):
    runner = T.make_runner(spec, time_slice=0.01, stepper=stepper,
                           policies=POLICIES, device="cpu", **kw)
    return runner, runner(_cfgs(spec))


MODES = {"plain": {}, "telemetry": {"telemetry": True},
         "sanitize": {"sanitize": True},
         "both": {"telemetry": True, "sanitize": True}}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("stepper", STEPPERS)
def test_replayed_run_equals_the_eager_loop(spec, stepper, mode,
                                            monkeypatch):
    kw = MODES[mode]
    eager, want = _run(spec, stepper, **kw)
    assert eager._replays == {}
    monkeypatch.setattr(sim_mod, "_captures", lambda dev: True)
    monkeypatch.setattr(sim_mod, "_CudaGraph", StandInGraph)
    graphed, got = _run(spec, stepper, **kw)
    assert len(graphed._replays) == 1
    _assert_equal(want, got, kw.get("telemetry", False))
    assert graphed.stats == eager.stats
    assert graphed.stats["host_reads"] > 0


@pytest.mark.parametrize("stepper", STEPPERS)
def test_a_second_run_replays_without_capturing_again(spec, stepper,
                                                      replayed):
    runner = T.make_runner(spec, time_slice=0.01, stepper=stepper,
                           policies=POLICIES, device="cpu", sanitize=True)
    first = runner(_cfgs(spec))
    n = StandInGraph.captures
    rep = next(iter(runner._replays.values()))
    assert set(rep.graphs) <= {(k, m) for k in ("cheap", "full")
                               for m in (False, True)}
    second = runner(_cfgs(spec))
    assert StandInGraph.captures == n
    _assert_equal(first, second, False)
    # the returned state is out of the buffers the next run overwrites
    assert all(x.data_ptr() != y.data_ptr() for (_, x), (_, y) in zip(
        _leaves(first, False), _leaves(second, False)))


def _counting(monkeypatch):
    """The buffer-pool kernels' dispatch counting a launch for every call,
    as the card's wrappers do, on the CPU's plain versions: stand-in
    counts."""
    wrappers = {"batched_evict": pbm_timeline.batched_evict_kernel,
                "fifo_grant": pbm_timeline.fifo_grant_kernel,
                "wake_solve": pbm_timeline.wake_solve_kernel}
    for name, wrapper in wrappers.items():
        plain = getattr(ops, name)

        def counted(*a, _plain=plain, _w=wrapper, **k):
            _w.launches += 1
            return _plain(*a, **k)
        monkeypatch.setattr(ops, name, counted)


@pytest.mark.parametrize("stepper", STEPPERS)
def test_captured_counts_times_replays_equal_the_eager_counts(
        spec, stepper, monkeypatch):
    _counting(monkeypatch)
    ops.reset_launch_counts()
    _run(spec, stepper)
    eager = ops.launch_counts()
    # the fixed stepper pops its queue in plain PyTorch: B1 alone
    used = SIM_KERNELS if stepper == "horizon" else ("batched_evict",)
    assert all(eager[k] > 0 for k in used)
    monkeypatch.setattr(sim_mod, "_captures", lambda dev: True)
    monkeypatch.setattr(sim_mod, "_CudaGraph", StandInGraph)
    ops.reset_launch_counts()
    graphed, _ = _run(spec, stepper)
    assert ops.launch_counts() == eager
    # each graph's count is what its capture counted (the warm-up's and
    # the capture's own taken back out), added once a replay
    rep = next(iter(graphed._replays.values()))
    for graph, launches in rep.graphs.values():
        assert launches == {k: n for k, n in graph.counted.items() if n}


def test_launch_counts_add_and_take_back():
    ops.reset_launch_counts()
    ops.add_launch_counts({"fifo_grant": 3, "wake_solve": 2})
    ops.add_launch_counts({"fifo_grant": 3})
    ops.add_launch_counts({"wake_solve": -2})
    got = ops.launch_counts()
    assert got["fifo_grant"] == 6 and got["wake_solve"] == 0
    ops.reset_launch_counts()


class _NanLane1(ArrayLRU):
    """LRU whose scores hold a NaN in lane 1."""

    def score_victims(self, pstate, ctx):
        s = super().score_victims(pstate, ctx).clone()
        s[1, 3] = float("nan")
        return s


@pytest.mark.parametrize("stepper", STEPPERS)
def test_a_hit_inside_a_replay_raises_as_the_eager_loop_does(
        spec, stepper, monkeypatch):
    kw = dict(time_slice=0.01, stepper=stepper, policies=(_NanLane1(),),
              sanitize=True, device="cpu")
    cfgs = _cfgs(spec, ("lru", "lru"))
    with pytest.raises(sim_mod.SanitizeError) as eager:
        T.make_runner(spec, **kw)(cfgs)
    monkeypatch.setattr(sim_mod, "_captures", lambda dev: True)
    monkeypatch.setattr(sim_mod, "_CudaGraph", StandInGraph)
    with pytest.raises(sim_mod.SanitizeError) as graphed:
        T.make_runner(spec, **kw)(cfgs)
    assert str(graphed.value) == str(eager.value)
    assert "lane 1" in str(graphed.value)


def test_copy_into_reads_every_source_before_it_writes():
    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    dst = (a, b)
    _ = sim_mod._copy_into(dst, (b, a))         # a swap through the buffers
    assert a.tolist() == [10.0, 11.0, 12.0, 13.0]
    assert b.tolist() == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(RuntimeError, match="changed a carry leaf"):
        sim_mod._copy_into((a,), (torch.zeros(3),))


# ------------------------------------------------------------- the card --

@pytest.mark.gpu
@pytest.mark.parametrize("telemetry", [False, True], ids=["plain", "tele"])
@pytest.mark.parametrize("stepper", STEPPERS)
def test_cuda_graphs_equal_the_eager_steps(spec, stepper, telemetry):
    """The runner's replays against its own eager steps (``run.cheap`` /
    ``run.full``) driven by the same loop on the card: bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card: "
                    "pytest -m gpu tests/test_torch_sim_graphs.py)")
    dev = torch.device("cuda")
    cfgs = T.stack_configs([T.make_config(spec, 16 << 20, 700e6, p,
                                          device=dev) for p in POLICIES])
    run = T.make_runner(spec, time_slice=0.01, stepper=stepper,
                        policies=POLICIES, telemetry=telemetry, device=dev)
    got = run(cfgs)
    assert len(run._replays) == 1
    L = cfgs.policy.shape[0]
    lc, carry = run.cheap.lane_consts(cfgs), run.init_carry(cfgs)
    while True:
        live = run.cond(carry, cfgs)
        n_live = int(live.sum())
        if n_live == 0:
            break
        mask = None if n_live == L else live
        if stepper == "fixed":
            for _ in range(run.cheap.n_inner - 1):
                carry = run.cheap(carry, cfgs, mask, lc)
            carry = run.full(carry, cfgs, mask, lc)
            continue
        while True:
            inner = live & run.inner_cond(carry)
            n_in = int(inner.sum())
            if n_in == 0:
                break
            carry = run.cheap(carry, cfgs, None if n_in == L else inner, lc)
        carry = run.full(carry, cfgs, mask, lc)
    want = (carry[0], carry[-1]) if telemetry else carry[0]
    _assert_equal(want, got, telemetry)
