"""The simulator's mesh across processes: ``make_runner(mesh=DeviceMesh)``
and B1's / B2's page split across the ranks of a page group, on the CPU
(``gloo``), held to ``mesh=None``, to the one-process ``page_shards`` path
and to the JAX package's ``shard_map`` on 4 host devices.

* The rank-sharded plain versions (``ref.evict_rank_sharded``,
  ``ref.grant_rank_sharded``) over a 4-rank page group equal JAX's
  page-sharded ops under a 4-device ``shard_map`` and the one-process
  ``page_shards=4`` path, in mask, bytes and count: the seeded cases of
  ``tests/test_torch_page_split.py``, i32 keys 2^24 and 2^24 + 1, and
  heavy ties (-0.0 / +0.0 among them).
* Runners over ``(4,)`` lanes and ``(1, 2)``, ``(1, 4)``, ``(2, 2)``
  ``('lanes', 'page')`` DeviceMeshes at the tiny point (8 lanes: four
  policies at two pools) are bit-equal to ``mesh=None`` in every state
  leaf on every rank, under both steppers; each lane shard's stats are
  its own; the JAX package's refusals hold.
* The ``(2, 2)`` ranks against JAX's ``make_runner(mesh=(2, 2))`` under a
  real 4-device ``shard_map`` (XLA's algebraic simplifier off, as
  ``tests/test_torch_sim_lockstep.py``), held as
  ``tests/test_torch_sim_cscan.py`` holds the one-process port.

The ranks are processes of their own (this file run as a script), with a
``file://`` rendezvous under the test's temporary directory and
``init_mesh``'s 60 s page-group timeout; the children are waited for by one
deadline and killed past it.  The JAX sides run in children too: host devices must exist before
JAX initialises.
"""

import functools
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.core import array_sim as T
from repro_torch.kernels import ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICIES = ("lru", "pbm", "opt", "cscan")
CAPS = (16 << 20, 24 << 20)
STEPPERS = ("fixed", "horizon")
#: the meshes the runner is held at, by name: (shape, dimension names,
#: world size of the spawn that runs it)
MESHES = {"4": ((4,), ("lanes",), 4), "1x2": ((1, 2), ("lanes", "page"), 2),
          "1x4": ((1, 4), ("lanes", "page"), 4),
          "2x2": ((2, 2), ("lanes", "page"), 4)}
SPAWN_TIMEOUT_S = 240.0
#: the late-shard case: the page groups' timeout cut to this many seconds,
#: and the first lane shard ending this many seconds after its own run
LATE_TIMEOUT_S, LATE_S = 1.0, 3.0
VMAX = {"grant": 16, "evict": 64}


# ------------------------------------------------------------- the point ----

def _tiny(W):
    """The tiny point of ``tests/test_torch_page_split.py`` (P = 128) from
    the workload module ``W`` (the port's or the JAX package's)."""
    db = W.make_lineitem_db(scale_tuples=2_000_000)
    return db, W.micro_streams(db, n_streams=2, queries_per_stream=1, seed=3)


@functools.lru_cache(maxsize=None)
def _spec():
    from repro_torch.core import workload as TW
    return T.compile_workload(*_tiny(TW))


def _cfgs(spec, lanes=None):
    lanes = lanes or [(p, c) for p in POLICIES for c in CAPS]
    return T.stack_configs([T.make_config(spec, c, 700e6, p, device="cpu")
                            for p, c in lanes])


def _runner(spec, stepper, **kw):
    return T.make_runner(spec, time_slice=0.01, policies=POLICIES,
                         stepper=stepper, **kw)


@functools.lru_cache(maxsize=None)
def _plain(stepper):
    return _runner(_spec(), stepper, device="cpu")(_cfgs(_spec()))


def _leaves(tree, prefix=""):
    if torch.is_tensor(tree):
        yield prefix, tree
    elif hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{prefix}.{f}")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")


def _unequal(a, b) -> list:
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys() and la
    return [k for k in la if not (
        la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape
        and torch.equal(torch.nan_to_num(la[k]), torch.nan_to_num(lb[k]))
        and torch.equal(la[k].isnan() if la[k].is_floating_point()
                        else la[k], lb[k].isnan()
                        if lb[k].is_floating_point() else lb[k]))]


# ------------------------------------------------------------ op cases ----

def _op_cases() -> dict:
    """Lanes of B1 and B2 at P = 1,024: the four seeded trials of
    ``test_four_shard_plain_versions_equal_jax_shard_map``, then the
    integer case (i32 keys 2^24 and 2^24 + 1: the larger must go first)
    and a tie-heavy one (keys from a handful of values, -0.0 and +0.0
    among the floats)."""
    rng = np.random.default_rng(5)
    P, keys, sizes, evs, fkeys = 1024, [], [], [], []
    for _ in range(4):
        keys.append(rng.integers(-1, 1 << 28, P).astype(np.int32))
        sizes.append(rng.choice([524288.0, 4096.0], P).astype(np.float32))
        evs.append(rng.random(P) < 0.7)
        fkeys.append(rng.random(P).astype(np.float32))
    rng = np.random.default_rng(24)
    for kind in ("2^24", "ties"):
        if kind == "2^24":
            keys.append(rng.choice(np.array([1 << 24, (1 << 24) + 1],
                                            np.int32), P))
            fkeys.append(rng.choice(np.array([0.25, 0.5], np.float32), P))
        else:
            keys.append(rng.choice(np.array([-1, 3, 7, 7, 9], np.int32), P))
            fkeys.append(rng.choice(np.array([-0.0, 0.0, 0.5, -0.5],
                                             np.float32), P))
        sizes.append(rng.choice([524288.0, 4096.0, 0.0], P).astype(np.float32))
        evs.append(rng.random(P) < 0.6)
    ikeys = [np.where(k >= 0, k, np.int32(1 << 24)).astype(np.int32)
             for k in keys]
    L = len(keys)
    return {"key": np.stack(keys), "ikey": np.stack(ikeys),
            "fkey": np.stack(fkeys), "sizes": np.stack(sizes),
            "ev": np.stack(evs),
            "budget": np.array([4e6] * 4 + [3e6, 2e6], np.float32),
            "pops": np.array([9] * 4 + [12, 14], np.int32),
            "need": np.array([3e6] * 4 + [2e6, 5e6], np.float32),
            "L": L}


def _port_ops(case, **split) -> dict:
    """B1 (f32 and i32 keys) and B2 through ``kernels.ops`` on the CPU."""
    t = lambda name: torch.from_numpy(np.ascontiguousarray(case[name]))  # noqa: E731,E501
    g = ops.fifo_grant(t("key"), t("sizes"), t("budget"), t("pops"),
                       vmax=VMAX["grant"], **split)
    out = {"grant_mask": g[0], "grant_bytes": g[1], "grant_n": g[2]}
    for name in ("fkey", "ikey"):
        out[f"evict_{name}"] = ops.batched_evict(
            t(name), t("sizes"), t("ev"), t("need"), vmax=VMAX["evict"],
            **split)
    return {k: v.numpy() for k, v in out.items()}


# ------------------------------------------------------------ the ranks ----

def _rank_main(world: int, rank: int, rdv: str, out_dir: str,
               spec_path: str) -> None:
    """One rank of a spawn: every mesh of ``MESHES`` over ``world`` ranks,
    both steppers, the rank-sharded ops (4 ranks) and the refusals; what
    it returns goes to ``<out_dir>/<rank>.pt``."""
    from repro_torch.core.array_sim.dist import close_mesh, init_mesh
    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    cfgs = _cfgs(spec)
    res = {"runs": {}, "stats": {}, "refused": {}}

    def mesh_of(shape, names):
        return init_mesh(shape, names, "cpu", init_method=rdv, rank=rank,
                         world_size=world)
    try:
        for name, (shape, names, n) in MESHES.items():
            if n != world:
                continue
            mesh = mesh_of(shape, names)
            for stepper in STEPPERS:
                run = _runner(spec, stepper, mesh=mesh)
                res["runs"][name, stepper] = run(cfgs)
                res["stats"][name, stepper] = dict(run.stats)
                res["page_axis", name] = run.page_axis
            if name == "1x4":
                res["ops"] = _port_ops(_op_cases(),
                                       page_group=mesh.get_group("page"))
            if name == "2x2":
                res["tele"] = _runner(spec, "horizon", mesh=mesh,
                                      telemetry=True)(cfgs)
            if name == "1x2":
                res["late"] = _late_lane_shard(spec, cfgs, rank, rdv, world)
            if name == "4":
                run = _runner(spec, "fixed", mesh=mesh)
                for what, call in (
                        ("lanes", lambda: run(_cfgs(spec, [("lru", c) for c
                                                           in (1, 2, 3)]))),
                        ("sanitize", lambda: _runner(spec, "fixed",
                                                     mesh=mesh,
                                                     sanitize=True)),
                        ("axes", lambda: _runner(spec, "fixed", mesh=mesh_of(
                            (1, 2, 2), ("a", "b", "c"))))):
                    try:
                        call()
                    except ValueError as e:
                        res["refused"][what] = str(e)
        torch.save(res, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        close_mesh()


class _Late:
    """A lane shard's runner that ends ``LATE_S`` after its run."""

    def __init__(self, one):
        self.one = one

    def __call__(self, cfg):
        out = self.one(cfg)
        time.sleep(LATE_S)
        return out

    def __getattr__(self, name):
        return getattr(self.one, name)


def _late_lane_shard(spec, cfgs, rank: int, rdv: str, world: int) -> dict:
    """A (2, 1) ('lanes', 'page') mesh whose page groups time out after
    ``LATE_TIMEOUT_S`` and whose first lane shard ends ``LATE_S`` after
    its run: the other rank waits that long in the lanes all-gather, which
    must not time out.  The state, or the error, and this rank's wall."""
    from repro_torch.core.array_sim import dist as D, sim
    inner, cut = sim._runner, D.TIMEOUT_S
    if rank == 0:
        sim._runner = lambda *a, **k: _Late(inner(*a, **k))
    D.TIMEOUT_S = LATE_TIMEOUT_S
    try:
        mesh = D.init_mesh((2, 1), ("lanes", "page"), "cpu", init_method=rdv,
                           rank=rank, world_size=world)
        run = _runner(spec, "horizon", mesh=mesh)
        t0 = time.time()
        try:
            return {"state": run(cfgs), "wall": time.time() - t0}
        except RuntimeError as e:
            return {"error": str(e), "wall": time.time() - t0}
    finally:
        sim._runner, D.TIMEOUT_S = inner, cut


def _env(**extra) -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                            os.environ.get("PYTHONPATH", "")]),
                **extra)


def _start(args: list, env: dict) -> subprocess.Popen:
    """This file run as a script with ``args``, its output kept."""
    return subprocess.Popen([sys.executable, __file__, *args], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs: dict) -> None:
    """Wait for every child by one deadline; kill what outlives it; fail
    on a child that failed, with its output."""
    deadline = time.time() + SPAWN_TIMEOUT_S
    logs = {}
    try:
        for name, p in procs.items():
            logs[name] = p.communicate(
                timeout=max(1.0, deadline - time.time()))[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = {name: p.returncode for name, p in procs.items() if p.returncode}
    assert not bad, (bad, "\n".join(logs.get(n, "")[-3000:] for n in bad))


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every child of this file, started at once: the ranks of a 2-rank
    and a 4-rank spawn (world size -> each rank's results), and where JAX
    is installed its two sides (``jax_ops``: the page-sharded ops;
    ``jax_runner``: the (2, 2) runner's lanes)."""
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(_spec(), f)
    procs = {}
    for world in (2, 4):
        out = tmp / f"world{world}"
        out.mkdir()
        rdv = f"file://{out / 'rendezvous'}"
        for r in range(world):
            procs[world, r] = _start(["rank", str(world), str(r), rdv,
                                      str(out), str(tmp / "spec.pkl")],
                                     _env())
    has_jax = importlib.util.find_spec("jax") is not None
    if has_jax:
        np.savez(tmp / "case.npz", **_op_cases())
        procs["jax_ops"] = _start(
            ["jax_ops", str(tmp / "case.npz"), str(tmp / "ops.npz")],
            _env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
        procs["jax_runner"] = _start(
            ["jax_runner", str(tmp / "runner.json")],
            _env(XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                           "--xla_disable_hlo_passes=algsimp"))
    _wait(procs)
    out = {world: [torch.load(tmp / f"world{world}" / f"{r}.pt",
                              weights_only=False) for r in range(world)]
           for world in (2, 4)}
    if has_jax:
        out["jax_ops"] = dict(np.load(tmp / "ops.npz"))
        with open(tmp / "runner.json") as f:
            out["jax_runner"] = json.load(f)
    return out


@pytest.fixture(scope="module")
def ranks(children):
    return children


@pytest.fixture(scope="module")
def jax_ops(children):
    pytest.importorskip("jax")
    return children["jax_ops"]


@pytest.fixture(scope="module")
def jax_runner(children):
    pytest.importorskip("jax")
    return children["jax_runner"]


# ------------------------------------------------------ the JAX sides ----

def _jax_ops(case_path: str, out_path: str) -> None:
    """The JAX package's page-sharded B1 / B2 on a 4-device ``shard_map``
    (``ops.set_backend("reference")``: the jnp bodies), lane by lane."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.kernels import ops as jops
    jops.set_backend("reference")
    case = dict(np.load(case_path))
    mesh = Mesh(np.array(jax.devices()[:4]), ("page",))
    rep = (P(), P(), P(), P())
    grant = jax.jit(shard_map(
        partial(jops.fifo_grant, vmax=VMAX["grant"], page_axis="page"),
        mesh=mesh, in_specs=rep, out_specs=(P(), P(), P()),
        check_rep=False))
    evict = jax.jit(shard_map(
        partial(jops.batched_evict, vmax=VMAX["evict"], page_axis="page"),
        mesh=mesh, in_specs=rep, out_specs=P(), check_rep=False))
    out = {k: [] for k in ("grant_mask", "grant_bytes", "grant_n",
                           "evict_fkey", "evict_ikey")}
    for i in range(int(case["L"])):
        a = lambda name: jnp.asarray(case[name][i])  # noqa: E731
        g = grant(a("key"), jnp.asarray(case["sizes"][i]), a("budget"),
                  a("pops"))
        for k, v in zip(("grant_mask", "grant_bytes", "grant_n"), g):
            out[k].append(np.asarray(v))
        for name in ("fkey", "ikey"):
            out[f"evict_{name}"].append(np.asarray(evict(
                a(name), jnp.asarray(case["sizes"][i]), a("ev"),
                a("need"))))
    np.savez(out_path, **{k: np.stack(v) for k, v in out.items()})


def _jax_runner(out_path: str) -> None:
    """The JAX package's runner over a (2, 2) ``('lanes', 'page')`` mesh of
    4 host devices at the tiny point, both steppers: each lane's
    result."""
    import jax
    from jax.sharding import Mesh
    from repro.core import array_sim as J
    from repro.core import workload as JW
    spec = J.compile_workload(*_tiny(JW))
    cfgs = J.stack_configs([J.make_config(spec, c, 700e6, p)
                            for p in POLICIES for c in CAPS])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("lanes", "page"))
    out = {}
    for stepper in STEPPERS:
        run = J.make_runner(spec, time_slice=0.01, policies=POLICIES,
                            stepper=stepper, mesh=mesh)
        states = jax.block_until_ready(run(cfgs))
        out[stepper] = [_result_row(J.result_from_state(
            jax.tree.map(lambda x: x[i], states), p, dt_ref=run.dt_ref))
            for i, (p, _c) in enumerate((p, c) for p in POLICIES
                                        for c in CAPS)]
    with open(out_path, "w") as f:
        json.dump(out, f)


def _result_row(r) -> dict:
    return {"total_loads": int(r.total_loads), "steps": int(r.steps),
            "slices_done": int(r.extras["slices_done"]),
            "churn_loads": int(r.extras["churn_loads"]),
            "total_io_bytes": float(r.total_io_bytes),
            "stream_times": [float(x) for x in r.stream_times]}


# ------------------------------------------------------------- the tests ----

OP_OUTPUTS = ("grant_mask", "grant_bytes", "grant_n", "evict_fkey",
              "evict_ikey")


@pytest.mark.parametrize("output", OP_OUTPUTS)
def test_rank_sharded_ops_equal_jax_shard_map_and_page_shards(
        output, ranks, jax_ops):
    """Every rank of the 4-rank page group computes the same answer, equal
    to JAX's page-sharded op under a 4-device ``shard_map`` and to the
    one-process ``page_shards=4`` path."""
    one = _port_ops(_op_cases(), page_shards=4)[output]
    for rank, res in enumerate(ranks[4]):
        np.testing.assert_array_equal(res["ops"][output], one,
                                      err_msg=f"rank {rank}")
    np.testing.assert_array_equal(one, jax_ops[output])


def test_the_integer_and_tie_cases_are_decided_as_the_oracles_decide():
    """The 2^24 lane evicts the 2^24 + 1 pages before any 2^24 one (an
    f32 cast would tie them), and the tie lane's grant takes equal keys
    by ascending index; both through the 4-shard split."""
    case = _op_cases()
    got = _port_ops(case, page_shards=4)
    assert np.float32(1 << 24) == np.float32((1 << 24) + 1)
    ev = got["evict_ikey"][4]
    assert ev.any() and (case["ikey"][4][ev] == (1 << 24) + 1).all()
    order = np.lexsort((np.arange(1024), -case["key"][5].astype(np.int64)))
    n = int(got["grant_n"][5])
    assert n > 0
    np.testing.assert_array_equal(np.flatnonzero(got["grant_mask"][5]),
                                  np.sort(order[:n]))


@pytest.mark.parametrize("stepper", STEPPERS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_device_mesh_runner_is_bit_equal_to_no_mesh(mesh, stepper, ranks):
    """Every state leaf on every rank equals ``mesh=None``: the lane shards
    all-gathered in lane order, the page row's all-gathered candidates
    giving the unsplit selections."""
    want = _plain(stepper)
    world = MESHES[mesh][2]
    for rank, res in enumerate(ranks[world]):
        assert _unequal(res["runs"][mesh, stepper], want) == [], rank
        assert res["page_axis", mesh] == ("page" if "x" in mesh else None)


def test_a_lane_shard_may_end_long_after_the_others(ranks):
    """The lanes all-gather waits for the slowest lane shard however long
    a page group's timeout is: with the page groups' cut to 1 s, the
    other rank waits 3 s for the late shard and both get the whole
    state, bit-equal to ``mesh=None``."""
    want = _plain("horizon")
    for rank, res in enumerate(ranks[2]):
        late = res["late"]
        assert "error" not in late, (rank, late.get("error"))
        assert _unequal(late["state"], want) == [], rank
        assert late["wall"] > LATE_S, (rank, late["wall"])


def test_telemetry_is_gathered_over_the_lanes_like_the_state(ranks):
    """``telemetry=True`` over the (2, 2) mesh: ``(state, telemetry)`` on
    every rank, both bit-equal to ``mesh=None``'s."""
    want = _runner(_spec(), "horizon", device="cpu",
                   telemetry=True)(_cfgs(_spec()))
    for rank, res in enumerate(ranks[4]):
        assert _unequal(res["tele"], want) == [], rank


@pytest.mark.parametrize("stepper", STEPPERS)
def test_each_lane_shard_keeps_its_own_stats(stepper, ranks):
    """A rank's ``runner.stats`` are its shard's, as a ``shard_map``
    device's loop is its own: those of a runner on its two lanes alone;
    under the horizon stepper the shards take different step counts."""
    lanes = [(p, c) for p in POLICIES for c in CAPS]
    steps = []
    for rank, res in enumerate(ranks[4]):
        alone = _runner(_spec(), stepper, device="cpu")
        alone(_cfgs(_spec(), lanes[2 * rank:2 * rank + 2]))
        assert res["stats"]["4", stepper] == alone.stats, rank
        steps.append(alone.stats["cheap_steps"])
    if stepper == "horizon":
        assert len(set(steps)) > 1, steps


@pytest.mark.parametrize("what", ["lanes", "sanitize", "axes"])
def test_device_mesh_refusals_are_the_jax_packages(what, ranks):
    """Lanes that do not divide, ``sanitize=True`` and three dimensions
    raise ``ValueError`` on every rank, with the JAX package's words."""
    words = {"lanes": "do not divide", "sanitize": "does not compose",
             "axes": "one-axis"}[what]
    for res in ranks[4]:
        assert words in res["refused"][what]


@pytest.mark.parametrize("stepper", STEPPERS)
def test_two_by_two_ranks_match_the_jax_shard_map_runner(stepper, ranks,
                                                         jax_runner):
    """The ``(2, 2)`` ranks against JAX's ``(2, 2)`` ``shard_map`` runner
    lane by lane: the integer results equal, the stream times to rtol
    1e-6 (``tests/test_torch_sim_cscan.py``'s whole-run rule)."""
    state = ranks[4][0]["runs"]["2x2", stepper]
    dt = _runner(_spec(), stepper, device="cpu").dt_ref
    lanes = [(p, c) for p in POLICIES for c in CAPS]
    for i, ((p, c), want) in enumerate(zip(lanes, jax_runner[stepper])):
        got = _result_row(T.result_from_state(state, p, dt_ref=dt, lane=i))
        for key in ("total_loads", "steps", "slices_done", "churn_loads",
                    "total_io_bytes"):
            assert got[key] == want[key], (p, c, key)
        np.testing.assert_allclose(got["stream_times"], want["stream_times"],
                                   rtol=1e-6)


def test_a_one_process_mesh_over_two_devices_is_refused():
    """A :class:`Mesh` that names different devices on its lane axis (or a
    page row) raises, naming the DeviceMesh form; over one device it
    runs."""
    spec = _spec()
    for mesh in (T.Mesh(["cpu", "meta"], ("lanes",)),
                 T.Mesh([["cpu"], ["meta"]], ("lanes", "page"))):
        with pytest.raises(NotImplementedError, match="DeviceMesh"):
            T.make_runner(spec, mesh=mesh)
    run = T.make_runner(spec, mesh=T.Mesh([["cpu", "cpu"]],
                                          ("lanes", "page")))
    assert run.page_axis == "page"


def test_init_mesh_checks_before_it_makes_a_group():
    """The shape must be the world and have one name a dimension; neither
    makes a group.  A page group's timeout is 60 s."""
    from repro_torch.core.array_sim.dist import TIMEOUT_S, init_mesh
    import torch.distributed as dist
    assert TIMEOUT_S == 60.0
    for kw, words in (
            (dict(shape=(2, 2), world_size=3), "not 3 ranks"),
            (dict(shape=(2, 2), names=("lanes",), world_size=4), "names")):
        with pytest.raises(ValueError, match=words):
            init_mesh(device_type="cpu", rank=0,
                      **{"names": ("lanes", "page")[:len(kw["shape"])], **kw})
    assert not dist.is_initialized()


def test_one_page_split_at_a_time():
    """``page_shards`` and ``page_group`` in one call are refused."""
    key = torch.zeros((1, 8))
    with pytest.raises(ValueError, match="one page split"):
        ops.batched_evict(key, torch.ones(8), torch.ones((1, 8), dtype=bool),
                          torch.ones(1), page_shards=2, page_group=object())


@pytest.mark.parametrize("call, rules", [
    ("dist.all_gather_into_tensor(out, x, group=group)", []),
    ("dist.all_gather_single(out, x, group=group)", ["step-collective"]),
    ("dist.barrier(group=group)", ["step-collective"]),
    ("dist.all_gather_object(out, x, group=group)", ["step-collective"]),
    ("torch.distributed.broadcast(x, 0, group=group)", ["step-collective"]),
], ids=["into_tensor", "single", "barrier", "object", "broadcast"])
def test_the_lint_tells_the_device_all_gather_from_host_collectives(call,
                                                                   rules):
    """In a step region the all-gather into a tensor passes and the group's
    size is host structure (``if`` on it is no read back); a collective
    that goes through or waits on the host is a finding."""
    from repro_torch.analysis import lint_source
    src = ("import torch\nimport torch.distributed as dist\n\n\n"
           "def f(x, out, group):\n"
           "    n = dist.get_world_size(group)\n"
           "    if x.shape[0] % n:\n"
           "        raise ValueError(n)\n"
           f"    {call}\n"
           "    return out\n")
    got = sorted({f.rule for f in lint_source(
        src, "repro_torch/kernels/example.py")})
    assert got == rules


if __name__ == "__main__":
    job = sys.argv[1]
    if job == "rank":
        _rank_main(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    elif job == "jax_ops":
        _jax_ops(sys.argv[2], sys.argv[3])
    elif job == "jax_runner":
        _jax_runner(sys.argv[2])
    else:
        raise SystemExit(f"unknown job {job!r}")
