"""What decides ``correct``, on the CPU at a quarter of the micro
configuration (P = 768): the reference agrees with the port's runner
there to the bit, the control (the reference with pools that never fill)
fails the limit, and a run whose timed path is broken underneath comes
out not correct, once for each fault a sweep can have.  On the card, a
cell run whole (``gpu``)."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch
from conftest import QUARTER, REPO

import control
from portbench import cells, check, harness, program, workloads

SEED = 3


def _run(root, here, **kw):
    return harness.execute(root, QUARTER, SEED, 0.1, False, time.time(),
                           device="cpu", here=here, **kw)


def test_the_reference_agrees_with_the_cpu_runner(checkout):
    root, here = checkout
    out = _run(root, here)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    for name in check.NUMBERS + ("short_s",):
        assert out["checks"][name]["value"] == 0.0, (name, out["checks"])


def test_the_control_and_the_faults_fail_the_limit(checkout):
    """The reference in the program's place with every lane's pool
    unbounded (the configuration states a capacity), and the program's
    answers broken as each fault breaks them (``control.faults``): every
    reading against the reference is above a limit."""
    root, here = checkout
    cell = cells.load(root, QUARTER, here)
    work = workloads.generate(cell.config, SEED)
    T = workloads.prefix_time(cell.config, cell.traffic, work)
    lanes = program.lanes(cell.traffic)
    want = check.reference_answers(cell.config, work, lanes, T, "cpu")
    ctrl = check.reference_answers(cell.config, work, lanes, T, "cpu",
                                   scale=check.UNBOUNDED)
    limit = {n: cell.limits[n]["limit"] for n in check.NUMBERS}

    def fails(got):
        return any(v > limit[n] for n, (v, _i) in check.worst(got, want).items())
    assert fails(ctrl)
    for name, got in control.faults(lanes, want).items():
        assert fails(got), name


def _state_unchanged(monkeypatch):
    """The step returns its state unchanged: no lane reaches T, the sweep
    never ends."""
    from repro_torch.core.array_sim import sim
    real = sim.make_step

    class Still:
        def __init__(self, step):
            self._step = step

        def __getattr__(self, name):
            return getattr(self._step, name)

        def __call__(self, carry, cfg, mask=None, lc=None):
            return carry
    monkeypatch.setattr(sim, "make_step", lambda *a, **k: Still(real(*a, **k)))


def _wrap_runner(monkeypatch, broken_run):
    """The program's runner replaced by ``broken_run(run, cfg, spec)``."""
    import repro_torch.core.array_sim as A
    real = A.make_runner

    def make(spec, **kw):
        run = real(spec, **kw)

        def broken(cfg):
            out = broken_run(run, cfg, spec)
            broken.stats = run.stats
            return out
        broken.stats = run.stats
        return broken
    monkeypatch.setattr(A, "make_runner", make)


_ANSWERS = ("qidx", "pos", "t", "io_bytes", "loads", "steps",
            "stream_done_t", "churn", "loads_demand", "slices_done")


def _tuples(st, spec) -> torch.Tensor:
    """Each lane's tuples consumed, from its query index and cursor."""
    lens = torch.as_tensor(spec.q_len, dtype=torch.float64)          # (S, Q)
    before = torch.cat([torch.zeros(lens.shape[0], 1, dtype=torch.float64),
                        torch.cumsum(lens, 1)], 1)                   # (S, Q + 1)
    n_q = torch.as_tensor(spec.n_q)
    q = torch.minimum(st.qidx, n_q)
    done = torch.gather(before.expand(q.shape[0], -1, -1), 2,
                        q.unsqueeze(2)).squeeze(2)
    return (done + torch.where(q < n_q, st.pos.double(), 0.0)).sum(1)


def _half_the_lanes(monkeypatch):
    """Half the lanes left out, the mean taken over the rest: the runner
    steps the first half, and each lane of the other half reports the
    first half's mean tuples consumed (its streams' cursors at their share
    of it, in their first query)."""
    def run_half(run, cfg, spec):
        L = cfg.policy.shape[0]
        st = run(type(cfg)(*(x[: L // 2] for x in cfg)))
        out = {f: torch.cat([getattr(st, f)] * 2) for f in _ANSWERS}
        out["qidx"][L // 2:] = 0
        out["pos"][L // 2:] = float(_tuples(st, spec).mean()) / st.pos.shape[1]
        return st._replace(**out)
    _wrap_runner(monkeypatch, run_half)


def _answer_altered(monkeypatch):
    """An answer altered where it is produced: the first lane's and the
    last lane's answers written to each other's place."""
    def run_swapped(run, cfg, spec):
        st = run(cfg)
        idx = torch.arange(cfg.policy.shape[0])
        idx[0], idx[-1] = int(idx[-1]), 0
        return st._replace(**{f: getattr(st, f)[idx] for f in _ANSWERS})
    _wrap_runner(monkeypatch, run_swapped)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_lanes,
                                   _answer_altered])
def test_a_broken_timed_path_is_not_correct(checkout, monkeypatch, fault):
    root, here = checkout
    fault(monkeypatch)
    out = _run(root, here, warm_deadline_s=20.0)
    assert not out["correct"]
    assert out["failed"] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
def test_a_cell_runs_on_the_card_and_is_correct(card):
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "micro_sf30.mixed", "--seed", "2147483999",
                        "--seconds", "3", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
