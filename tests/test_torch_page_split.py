"""Page-split candidate selection (the JAX package's ``page_axis``) in the
port: ``kernels.ref``'s sharded plain versions, ``kernels.ops``'
``page_shards=``, the host's plan of the card's two-stage kernels, and
``make_runner(mesh=)``.

* Ports of the JAX package's four mesh tests (``tests/test_time_engine.py``
  156-266): a one-device mesh and a (1, 1) ``('lanes', 'page')`` mesh are
  bit-equal to no mesh; three axes are refused; the port's 4-shard plain
  versions equal the JAX ``ops.fifo_grant`` / ``ops.batched_evict`` under
  a 4-device ``shard_map`` (a child process with
  ``--xla_force_host_platform_device_count=4``) and the JAX oracles.
* Rows beyond one block (P = 20,000 and 35,328, TPC-H at scale 4.0) at
  the plain level against ``repro.kernels.ref`` for all three kernels,
  with wake_solve lanes that take its whole-row path on the card.
* A numpy model of the two stages' exactness argument on the kernels'
  32-bit key fields: every page of the lane's first m is among its own
  shard's first m, so the gathered candidates sorted by (field, global
  index) begin with the lane's first m; heavy ties across a shard
  boundary, -0.0 / +0.0, i32 keys 2^24 and 2^24 + 1, keys of -1.
* A (1, 4) ``cpu`` mesh runner bit-equal to ``mesh=None`` at the tiny
  point of the telemetry tests, under both steppers.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import array_sim as T
from repro_torch.core import workload as TW
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pbm_timeline as PT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICIES = ("lru", "pbm", "opt", "cscan")


# ------------------------------------------------------------ the runner ----

@functools.lru_cache(maxsize=None)
def _tiny():
    """The tiny point of the telemetry tests: every policy at 16 MiB,
    time slice 0.01 (P = 128)."""
    db = TW.make_lineitem_db(scale_tuples=2_000_000)
    streams = TW.micro_streams(db, n_streams=2, queries_per_stream=1, seed=3)
    return T.compile_workload(db, streams)


def _cfgs(spec, policies=POLICIES, caps=(16 << 20,)):
    return T.stack_configs([T.make_config(spec, c, 700e6, p, device="cpu")
                            for p in policies for c in caps])


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return []


def _bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) and la
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert torch.equal(x, y) or (
            x.is_floating_point() and torch.equal(x.isnan(), y.isnan())
            and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))), i


def _plain(spec, stepper, policies=POLICIES):
    runner = T.make_runner(spec, time_slice=0.01, policies=policies,
                           stepper=stepper, device="cpu")
    return runner(_cfgs(spec, policies))


@pytest.mark.parametrize("stepper", ["fixed", "horizon"])
def test_mesh_single_device_equivalence(stepper):
    """A one-device ``('lanes',)`` mesh is bit-equal to no mesh, and a
    two-device one (both the CPU) splits the lanes and gathers them."""
    spec = _tiny()
    for devices in (["cpu"], ["cpu", "cpu"]):
        mesh = T.Mesh(devices, ("lanes",))
        runner = T.make_runner(spec, time_slice=0.01, policies=("pbm",),
                               stepper=stepper, mesh=mesh)
        assert runner.lane_mesh is mesh and runner.page_axis is None
        cfgs = _cfgs(spec, ("pbm",), (16 << 20, 24 << 20))
        got = runner(cfgs)
        plain = T.make_runner(spec, time_slice=0.01, policies=("pbm",),
                              stepper=stepper, device="cpu")
        _bit_equal(got, plain(cfgs))


def test_mesh_rejects_three_axes_and_what_is_not_a_mesh():
    spec = _tiny()
    mesh = T.Mesh(np.array(["cpu"], dtype=object).reshape(1, 1, 1),
                  ("a", "b", "c"))
    with pytest.raises(ValueError, match="one-axis"):
        T.make_runner(spec, policies=("pbm",), mesh=mesh)
    with pytest.raises(TypeError, match="Mesh"):
        T.make_runner(spec, policies=("pbm",), mesh=True)
    with pytest.raises(ValueError, match="axis names"):
        T.Mesh(["cpu", "cpu"], ("lanes", "page"))


def test_mesh_lane_count_must_divide_and_a_page_row_is_one_card():
    spec = _tiny()
    runner = T.make_runner(spec, time_slice=0.01, policies=("pbm",),
                           mesh=T.Mesh(["cpu", "cpu"], ("lanes",)))
    with pytest.raises(ValueError, match="do not divide"):
        runner(_cfgs(spec, ("pbm",), (16 << 20,) * 3))
    with pytest.raises(NotImplementedError, match="DeviceMesh, one process"):
        T.make_runner(spec, mesh=T.Mesh([["cpu", "meta"]], ("lanes", "page")))
    with pytest.raises(ValueError, match="do not divide"):
        T.make_runner(spec, mesh=T.Mesh([["cpu"] * 3], ("lanes", "page")))


def test_mesh_page_axis_equivalence():
    """A (1, 1) ``('lanes', 'page')`` mesh, horizon stepper: bit-equal."""
    spec = _tiny()
    mesh = T.Mesh([["cpu"]], ("lanes", "page"))
    runner = T.make_runner(spec, time_slice=0.01, policies=("pbm",),
                           stepper="horizon", mesh=mesh)
    assert runner.page_axis == "page" and runner.lane_mesh is mesh
    _bit_equal(runner(_cfgs(spec, ("pbm",))), _plain(spec, "horizon",
                                                      ("pbm",)))


@pytest.mark.parametrize("stepper", ["fixed", "horizon"])
def test_four_page_shards_are_bit_equal_to_no_mesh(stepper):
    """A (1, 4) ``cpu`` mesh: B1 and B2 select their candidates in four
    slices of the pool at every step of all four policies' lanes."""
    spec = _tiny()
    assert spec.n_pages % 4 == 0
    mesh = T.Mesh([["cpu"] * 4], ("lanes", "page"))
    runner = T.make_runner(spec, time_slice=0.01, policies=POLICIES,
                           stepper=stepper, mesh=mesh)
    assert runner.runners[torch.device("cpu")].cheap.device.type == "cpu"
    _bit_equal(runner(_cfgs(spec)), _plain(spec, stepper))


# ------------------------------------------------------- the plain level ----

def _queue_case(rng, L, P, n_keys=1 << 28):
    key = rng.integers(-1, n_keys, (L, P)).astype(np.int32)
    key[:, rng.random(P) < 0.3] = -1
    sizes = rng.choice([524288.0, 4096.0, 0.0], P).astype(np.float32)
    return key, sizes


def test_sharded_plain_versions_equal_the_unsharded_ones():
    rng = np.random.default_rng(11)
    for P, n in ((768, 2), (768, 8), (3072, 4), (1000, 5)):
        key, sizes = _queue_case(rng, 4, P, n_keys=40)
        key, sizes = torch.from_numpy(key), torch.from_numpy(sizes)
        budget = torch.tensor([4e6, 0.0, 1e12, 6e5])
        pops = torch.tensor([9, 3, 2000, 0], dtype=torch.int32)
        for vmax in (1, 16, 300, P):
            want = ref.fifo_grant_ref(key, sizes, budget, pops, vmax=vmax)
            got = ops.fifo_grant(key, sizes, budget, pops, vmax=vmax,
                                 page_shards=n)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        fkey = torch.from_numpy(rng.integers(-3, 3, (4, P)) / 2.0).float()
        ev = torch.from_numpy(rng.random((4, P)) < 0.6)
        need = torch.tensor([3e6, 0.0, 1e12, 1e5])
        for vmax in (1, 64, 500, P):
            assert torch.equal(
                ops.batched_evict(fkey, sizes, ev, need, vmax=vmax,
                                  page_shards=n),
                ref.batched_evict_ref(fkey, sizes, ev, need, vmax=vmax))
    with pytest.raises(ValueError, match="do not divide"):
        ops.batched_evict(fkey, sizes, ev, need, page_shards=7)
    with pytest.raises(ValueError, match="do not divide"):
        ref.page_shard_candidates(fkey, 3, 8)


_JAX_CHILD = """
import sys, numpy as np, jax, jax.numpy as jnp
from functools import partial
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.kernels import ops, ref
ops.set_backend("reference")
case = np.load(sys.argv[1])
mesh = Mesh(np.array(jax.devices()[:4]), ("page",))
grant = jax.jit(shard_map(partial(ops.fifo_grant, vmax=16, page_axis="page"),
                          mesh=mesh, in_specs=(P(), P(), P(), P()),
                          out_specs=(P(), P(), P()), check_rep=False))
evict = jax.jit(shard_map(partial(ops.batched_evict, vmax=64,
                                  page_axis="page"),
                          mesh=mesh, in_specs=(P(), P(), P(), P()),
                          out_specs=P(), check_rep=False))
grant_ref = jax.jit(partial(ref.fifo_grant_ref, vmax=16))
evict_ref = jax.jit(partial(ref.batched_evict_ref, vmax=64))
out = {}
for t in range(int(case["trials"])):
    key, sizes = jnp.asarray(case[f"key{t}"]), jnp.asarray(case[f"sizes{t}"])
    budget, pops = jnp.float32(case[f"budget{t}"]), jnp.int32(case[f"pops{t}"])
    need, ev = jnp.float32(case[f"need{t}"]), jnp.asarray(case[f"ev{t}"])
    fkey = jnp.asarray(case[f"fkey{t}"])
    g = grant(key, sizes, budget, pops)
    gr = grant_ref(key, sizes, budget, pops)
    e = evict(fkey, sizes, ev, need)
    er = evict_ref(fkey, sizes, ev, need)
    for name, v in (("g", g), ("gr", gr), ("e", (e,)), ("er", (er,))):
        for i, x in enumerate(v):
            out[f"{name}{i}_{t}"] = np.asarray(x)
np.savez(sys.argv[2], **out)
print("OK")
"""


def test_four_shard_plain_versions_equal_jax_shard_map(tmp_path):
    """The port's 4-shard plain versions against the JAX package's
    page-sharded ops under a real 4-device ``shard_map`` and against its
    oracles (the JAX side in a child: host devices must exist before JAX
    initialises)."""
    pytest.importorskip("jax")
    rng = np.random.default_rng(5)
    Pn, trials, case = 1024, 4, {"trials": 4}
    for t in range(trials):
        case[f"key{t}"] = rng.integers(-1, 1 << 28, Pn).astype(np.int32)
        case[f"sizes{t}"] = rng.choice([524288.0, 4096.0], Pn).astype(
            np.float32)
        case[f"budget{t}"] = np.float32(4e6)
        case[f"pops{t}"] = np.int32(9)
        case[f"need{t}"] = np.float32(3e6)
        case[f"ev{t}"] = rng.random(Pn) < 0.7
        case[f"fkey{t}"] = rng.random(Pn).astype(np.float32)
    np.savez(tmp_path / "case.npz", **case)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src")]
                                        + sys.path)
    out = subprocess.run(
        [sys.executable, "-c", _JAX_CHILD, str(tmp_path / "case.npz"),
         str(tmp_path / "out.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]
    got = np.load(tmp_path / "out.npz")
    for t in range(trials):
        key = torch.from_numpy(case[f"key{t}"])[None]
        sizes = torch.from_numpy(case[f"sizes{t}"])
        g = ref.grant_page_sharded(key, sizes,
                                   torch.tensor([float(case[f"budget{t}"])]),
                                   torch.tensor([int(case[f"pops{t}"])],
                                                dtype=torch.int32), 4,
                                   vmax=16)
        for name in ("g", "gr"):
            np.testing.assert_array_equal(g[0][0].numpy(), got[f"{name}0_{t}"])
            assert float(g[1][0]) == float(got[f"{name}1_{t}"])
            assert int(g[2][0]) == int(got[f"{name}2_{t}"])
        e = ref.evict_page_sharded(
            torch.from_numpy(case[f"fkey{t}"])[None], sizes,
            torch.from_numpy(case[f"ev{t}"])[None],
            torch.tensor([float(case[f"need{t}"])]), 4, vmax=64)
        for name in ("e", "er"):
            np.testing.assert_array_equal(e[0].numpy(), got[f"{name}0_{t}"])


@pytest.mark.parametrize("P", [20_000, 35_328])
def test_rows_beyond_one_block_match_the_jax_oracles(P):
    """Rows the card splits (``splits``): B1 and B2 through the sharded
    plain versions at the fewest shards the card takes, B3 unsplit, each
    lane against ``repro.kernels.ref`` on the same numpy inputs.  B3's
    lanes include every reason for its whole-row path: a head longer than
    HEAD_CAP, ``inc`` < 0, ``inc`` NaN, a wanted size that is negative or
    not finite."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    assert PT.splits(P)
    n = PT.split_shards(P)
    assert P % n == 0 and n * 16384 >= P
    rng = np.random.default_rng(P)
    L = 6
    key, sizes = _queue_case(rng, L, P, n_keys=1 << 20)
    key[0, :2000] = 7                               # ties across shards
    budget = np.array([4e6, 0, 1e12, 6e5, 1e8, 3e6], np.float32)
    pops = np.array([9, 3, 2000, 0, 600, 40], np.int32)
    fkey = (rng.integers(-5, 5, (L, P)) / 4.0).astype(np.float32)
    ev = rng.random((L, P)) < 0.6
    need = np.array([3e6, 0, 1e12, 1e5, 5e8, 2e7], np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    for vmax in (16, 64, 2048):
        g = ops.fifo_grant(t(key), t(sizes), t(budget), t(pops), vmax=vmax,
                           page_shards=n)
        e = ops.batched_evict(t(fkey), t(sizes), t(ev), t(need), vmax=vmax,
                              page_shards=n)
        for i in range(L):
            want = jref.fifo_grant_ref(jnp.asarray(key[i]), jnp.asarray(sizes),
                                       jnp.float32(budget[i]),
                                       jnp.int32(pops[i]), vmax=vmax)
            np.testing.assert_array_equal(g[0][i].numpy(), np.asarray(want[0]))
            assert float(g[1][i]) == float(want[1])
            assert int(g[2][i]) == int(want[2])
            want = jref.batched_evict_ref(jnp.asarray(fkey[i]),
                                          jnp.asarray(sizes),
                                          jnp.asarray(ev[i]),
                                          jnp.float32(need[i]), vmax=vmax)
            np.testing.assert_array_equal(e[i].numpy(), np.asarray(want))
    wsizes = np.tile(sizes, (L, 1))
    wsizes[4, np.flatnonzero(key[4] >= 0)[3]] = -4096.0
    wsizes[5, np.flatnonzero(key[5] >= 0)[5]] = np.inf
    credit0 = np.array([1e6, 0, 5e6, 2e6, 1e6, 1e6], np.float32)
    inc = np.array([4e5, 1e5, 3e6, -1.0, np.nan, 2e5], np.float32)
    wpops = np.array([6, 1, 40, 5, 5, 5], np.int32)     # lane 2: m > 1024
    paths = PT.lane_paths("wake_solve", [t(key), t(wsizes), t(credit0),
                                         t(inc), t(wpops)], {"h_cap": 64})
    assert paths == ["split_select", "split_select", "split_full",
                     "split_full", "split_full", "split_full"]
    w = ops.wake_solve(t(key), t(wsizes), t(credit0), t(inc), t(wpops),
                       h_cap=64)
    for i in range(L):
        want = jref.wake_solve_ref(jnp.asarray(key[i]), jnp.asarray(wsizes[i]),
                                   jnp.float32(credit0[i]), jnp.float32(inc[i]),
                                   jnp.int32(wpops[i]), h_cap=64)
        np.testing.assert_array_equal(w[i].numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["batched_evict", "fifo_grant",
                                  "wake_solve"])
def test_split_cases_match_the_jax_oracles(name):
    """``cases.split_cases`` (the card's page-split cases: the whole-row
    kernels at P = 8,832 split into 2, 4 and 8 shards; every path beyond
    one block at P = 20,000) on the plain level, each lane against the JAX
    oracle.  -0.0 is read as +0.0 on the JAX side: the port ties the two
    as the Pallas body does, where the oracle's ``top_k`` orders them."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro_torch.kernels import cases
    fields = cases.TENSOR_FIELDS[name]
    jfn = {"batched_evict": jref.batched_evict_ref,
           "fifo_grant": jref.fifo_grant_ref,
           "wake_solve": jref.wake_solve_ref}[name]
    for case in cases.split_cases()[name]:
        args = [torch.from_numpy(np.ascontiguousarray(case[f]))
                for f in fields]
        static = dict(case["static"])
        if "path" in case:
            assert PT.lane_paths(name, args, static) == case["path"]
        got = [getattr(ops, name)(*args, **static, page_shards=n)
               for n in (2, 4, 8)] if case["shards"] \
            else [getattr(ops, name)(*args, **static)]
        for lane in range(case["key"].shape[0]):
            jargs = []
            for f in fields:
                a = case[f]
                a = a if a.ndim == 1 and f == "sizes" else a[lane]
                if f == "key" and a.dtype == np.float32:
                    a = a + np.float32(0.0)         # -0.0 -> +0.0
                jargs.append(jnp.asarray(a))
            want = jfn(*jargs, **static)
            want = want if isinstance(want, tuple) else (want,)
            for out in got:
                out = out if isinstance(out, tuple) else (out,)
                for o, w in zip(out, want):
                    np.testing.assert_array_equal(o[lane].numpy(),
                                                  np.asarray(w))


# ------------------------------------------- the two stages' exactness ----

def _field(key: np.ndarray) -> np.ndarray:
    """The CUDA kernels' 32-bit key field: ~ord(key), ord the
    order-preserving map of the key's bits (an i32 with its sign bit
    flipped; an f32 with -0.0 read as +0.0, then every bit flipped if
    negative, else the sign bit set)."""
    if key.dtype == np.int32:
        u = key.view(np.uint32) ^ np.uint32(0x80000000)
    else:
        b = (key + np.float32(0.0)).view(np.uint32)
        neg = (b & np.uint32(0x80000000)) != 0
        u = np.where(neg, ~b, b | np.uint32(0x80000000))
    return (~u).astype(np.uint32)


def _queue_field(key: np.ndarray) -> np.ndarray:
    """A queue key's field: the key's for k >= 0, 0xffffffff for -1."""
    return np.where(key >= 0, _field(key), np.uint32(0xFFFFFFFF)).astype(
        np.uint32)


def _words(field: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return (field.astype(np.uint64) << np.uint64(31)) | idx.astype(np.uint64)


def _two_stages(field: np.ndarray, n: int, m: int) -> np.ndarray:
    """Stage 1 per shard (its first min(m, P/n) words by (field, index))
    and stage 2 (the gathered words sorted): the first m words."""
    P = field.size
    p_loc = P // n
    cand = []
    for s in range(n):
        idx = np.arange(s * p_loc, (s + 1) * p_loc)
        w = np.sort(_words(field[idx], idx))
        cand.append(w[:min(m, p_loc)])
    return np.sort(np.concatenate(cand))[:m]


def _keys(rng, kind, P):
    if kind == "f32_ties":
        return rng.choice(np.array([-0.0, 0.0, 0.5, -0.5], np.float32), P)
    if kind == "i32_2pow24":
        return rng.choice(np.array([2**24, 2**24 + 1], np.int32), P)
    if kind == "i32_minus_one":
        return rng.choice(np.array([-1, 3, 4], np.int32), P)
    return rng.integers(-2**31, 2**31 - 1, P).astype(np.int32)


@pytest.mark.parametrize("kind", ["f32_ties", "i32_2pow24", "i32_minus_one",
                                  "i32_spread"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_the_first_m_are_among_each_shards_first_m(kind, n):
    rng = np.random.default_rng(n * 31 + len(kind))
    P = 24 * n * 8
    for trial in range(6):
        key = _keys(rng, kind, P)
        if trial % 2:                     # one tie straddles a boundary
            p_loc = P // n
            key[p_loc - 40:p_loc + 40] = key[p_loc]
        field = _queue_field(key) if kind == "i32_minus_one" \
            else _field(key)
        order = np.lexsort((np.arange(P), field))
        for m in (1, 7, P // n - 1, P // n, P // n + 5):
            m = min(m, P)
            np.testing.assert_array_equal(
                _two_stages(field, n, m) & np.uint64(0x7FFFFFFF),
                order[:m].astype(np.uint64))
        if key.dtype == np.float32:       # the f32 order is ref's, -0 == +0
            want = ref._service_order(torch.from_numpy(key)[None])[1][0]
            np.testing.assert_array_equal(order, want.numpy())


def test_host_plan_of_the_split():
    """The single-stage kernel while a row fits one block and no split is
    asked for; else the fewest shards at or above ``page_shards`` that
    divide P and whose slices fit a block; the lanes' paths say so."""
    assert not PT.splits(8832) and not PT.splits(16384)
    assert PT.splits(16385) and PT.splits(768, page_shards=2)
    assert PT.split_shards(35_328) == 3 and PT.split_shards(17_664) == 2
    assert PT.split_shards(20_000) == 2 and PT.split_shards(768, 4) == 4
    assert PT.split_shards(8832, 2) == 2
    with pytest.raises(ValueError, match="do not divide"):
        PT.split_shards(8832, 5)
    key = torch.zeros((2, 2048), dtype=torch.float32)
    args = [key, torch.ones(2048), torch.ones((2, 2048), dtype=torch.bool),
            torch.tensor([1.0, 0.0])]
    assert PT.lane_paths("batched_evict", args, {"vmax": 64}) == [
        "select", "idle"]
    assert PT.lane_paths("batched_evict", args,
                         {"vmax": 64, "page_shards": 4}) == [
        "split_select", "idle"]
    assert PT.lane_paths("batched_evict", args,
                         {"vmax": 2000, "page_shards": 4}) == [
        "split_full", "idle"]
    qkey = torch.full((2, 768), 5, dtype=torch.int32)
    qargs = [qkey, torch.ones(768), torch.tensor([1e9, 1e9]),
             torch.tensor([4, 0], dtype=torch.int32)]
    assert PT.lane_paths("fifo_grant", qargs,
                         {"vmax": 16, "page_shards": 2}) == [
        "split_select", "idle"]
    assert set(PT.SPLIT_PATHS) == {"idle", "split_select", "split_full"}
    assert json.dumps(PT.PATHS)        # unchanged for one block a lane
