"""The exactness argument of the CUDA queue kernels' head path.

``fifo_grant`` and ``wake_solve`` in ``csrc/pbm_timeline.cu`` select the
first m entries of a lane's service order and sort only those (m =
min(vmax, P, pops, wanted pages) and min(wanted pages, h_cap * pops)).
That is exact because the plain versions, which define the semantics,
never look further.  Checked here on the plain versions with seeded numpy
inputs (L <= 5, P up to 600, sizes >= 0 with zeros, heavy ties):

(a) wake_solve's output is unchanged when every wanted page at service
    rank >= h_cap * pops is made unwanted;
(b) fifo_grant's mask, bytes and count are unchanged when every wanted
    page at position >= min(vmax, pops) is made unwanted;
(c) for inc >= 0 the f32 thresholds credit0 + k * inc (a rounded
    multiply, then a rounded add) are non-decreasing in k, which the
    head path's binary searches rest on;
(d) every fuzz case that names the path of its lanes takes it by the
    host's computation of m (``pbm_timeline.lane_paths``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import cases, ref
from repro_torch.kernels.pbm_timeline import HEAD_CAP, PATHS, lane_paths

SEEDS = range(12)


def _queue(rng):
    """(L, P) queue keys, lane 0 holding at least half its pages, drawn
    from 3, 50 or 2^29 values (heavy ties to almost none), and whole sizes
    in 0..8."""
    L = int(rng.integers(1, 6))
    P = int(rng.choice([129, 300, 600]))
    frac = np.concatenate([[0.5 + 0.5 * rng.random()], rng.random(L - 1)])
    n_keys = int(rng.choice([3, 50, 2**29]))
    wanted = rng.random((L, P)) < frac.reshape(L, 1)
    key = np.where(wanted, rng.integers(0, n_keys, (L, P)), -1)
    sizes = rng.integers(0, 9, (L, P)).astype(np.float32)
    return torch.from_numpy(key.astype(np.int32)), torch.from_numpy(sizes)


def _service_rank(key):
    """Each page's position in service order (key descending, index
    ascending): the wanted pages hold the first ranks."""
    L, P = key.shape
    order = torch.sort(key, dim=1, descending=True, stable=True)[1]
    return torch.empty_like(order).scatter_(
        1, order, torch.arange(P).expand(L, P).contiguous())


def _cut(key, reach):
    """``key`` with every wanted page at rank >= reach[lane] unwanted;
    fails if that leaves the queue as it was (a vacuous check)."""
    past = (key >= 0) & (_service_rank(key) >= reach.unsqueeze(1))
    assert bool(past.any())
    return torch.where(past, torch.full_like(key, -1), key)


@pytest.mark.parametrize("seed", SEEDS)
def test_wake_solve_reads_only_the_first_h_cap_pops_ranks(seed):
    rng = np.random.default_rng(100 + seed)
    key, sizes = _queue(rng)
    L = key.shape[0]
    h_cap = int(rng.choice([4, 16, 31]))
    pops = torch.from_numpy(rng.integers(-1, 8, L).astype(np.int32))
    pops[0] = 1                     # lane 0 wants more than h_cap pages
    credit0 = torch.from_numpy(rng.uniform(0, 20, L).astype(np.float32))
    inc = torch.from_numpy(
        (rng.uniform(0, 15, L) * (rng.random(L) < 0.8)).astype(np.float32))
    cut = _cut(key, h_cap * pops.long().clamp(min=0))
    want = ref.wake_solve_ref(key, sizes, credit0, inc, pops, h_cap=h_cap)
    got = ref.wake_solve_ref(cut, sizes, credit0, inc, pops, h_cap=h_cap)
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fifo_grant_reads_only_the_first_min_vmax_pops_positions(seed):
    rng = np.random.default_rng(200 + seed)
    key, sizes = _queue(rng)
    L = key.shape[0]
    vmax = int(rng.integers(1, 80))
    pops = torch.from_numpy(rng.integers(-1, 100, L).astype(np.int32))
    pops[0] = 40                    # lane 0 wants more than it may pop
    budget = torch.from_numpy(
        rng.choice([0.0, 50.0, 200.0, 1e9], L).astype(np.float32))
    reach = torch.minimum(pops.long(), torch.tensor(vmax)).clamp(min=0)
    cut = _cut(key, reach)
    want = ref.fifo_grant_ref(key, sizes, budget, pops, vmax=vmax)
    got = ref.fifo_grant_ref(cut, sizes, budget, pops, vmax=vmax)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed", range(4))
def test_thresholds_are_non_decreasing_in_k_for_inc_at_least_0(seed):
    """The plain version's own arithmetic (``ref.wake_solve_ref``): an f32
    multiply k * inc, rounded, then an f32 add, rounded; k up to the
    kernels' largest h_cap (256).  Large credit0 beside a tiny inc is where
    a rounding could step back, if any could."""
    rng = np.random.default_rng(300 + seed)
    n = 400
    credit0 = np.concatenate([
        rng.uniform(-1e6, 1e6, n),
        np.sign(rng.random(n) - 0.5) * 10.0 ** rng.uniform(-3, 38, n),
        [0.0, -0.0, 3e38, -3e38, 2.0**24, -(2.0**24), 1e-45]])
    inc = np.concatenate([
        rng.uniform(0, 100, n),
        10.0 ** rng.uniform(-45, 10, n),
        [0.0, 0.0, 1e-45, 1e-45, 1.0, 0.5, 3.0]])
    credit0 = torch.from_numpy(credit0.astype(np.float32))
    inc = torch.from_numpy(inc.astype(np.float32))
    ks = torch.arange(1, 257)
    thr = credit0.unsqueeze(1) + ks.float().unsqueeze(0) * inc.unsqueeze(1)
    assert bool(torch.isfinite(thr).all())
    assert bool((thr[:, 1:] >= thr[:, :-1]).all())


HEAD_CASES = [(name, case) for name in ("fifo_grant", "wake_solve")
              for case in cases.CASES[name]() if "path" in case]


@pytest.mark.parametrize(
    "name,case", HEAD_CASES,
    ids=[f"{name}-{case['name']}" for name, case in HEAD_CASES])
def test_fuzz_case_takes_the_path_it_names(name, case):
    args = [torch.from_numpy(np.ascontiguousarray(case[f]))
            for f in cases.TENSOR_FIELDS[name]]
    assert lane_paths(name, args, case["static"]) == list(case["path"])


def test_each_queue_kernel_has_cases_on_both_paths():
    assert cases.HEAD_CAP == HEAD_CAP
    for name in ("fifo_grant", "wake_solve"):
        paths = {p for n, case in HEAD_CASES if n == name
                 for p in case["path"]}
        assert paths == set(PATHS[name])
