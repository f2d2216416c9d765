"""The port's optimizer, train step, gradient compression, elastic
decisions and training driver (``repro_torch.train``,
``repro_torch.launch.train``) against the JAX package's, on the CPU:

* one ``adamw_update`` from the same params, grads and state equals JAX's:
  params, mu and nu within rtol 1e-6, ``step`` equal, ``lr`` and
  ``grad_norm`` within rtol 1e-6 (clipped and not, in warmup and on the
  cosine);
* ``lr_at`` over warmup and cosine within rtol 1e-6 (and 1e-6 of the
  peak rate at the cosine's end, where ``1 + cos`` cancels);
* accumulation over 2 microbatches equals the full batch (the JAX
  package's ``test_grad_accumulation_matches_full_batch``: loss rtol 1e-4,
  params atol 5e-4) and JAX's two-microbatch step (loss rtol 1e-5, params
  atol 5e-4, the same bar);
* ``compress_grads=True`` is the int8 round trip of the gradients before
  AdamW, bit for bit; ``compress_decompress`` and two ``ef_compress``
  steps equal JAX's leaf by leaf within rtol 1e-6;
* ``elastic``: equal answers;
* ``launch.train.run`` at smoke size: 4 steps straight equal, bit for bit,
  2 steps with an async checkpoint, a resume and 2 more steps, and the
  data position resumes exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.train import compression as JC  # noqa: E402
from repro.train import elastic as JE  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train.train_step import make_train_step as jmake_step  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import build_model, load_jax_params  # noqa: E402
from repro_torch.models import tree_paths  # noqa: E402
from repro_torch.train import compression as C  # noqa: E402
from repro_torch.train import elastic as E  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, scale=1.0):
    """A nested numpy tree of f32 leaves (unsorted keys, as a model's)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return {"w": {"up": f(8, 12), "down": f(12, 8)}, "b": f(12),
            "a": {"z": f(3, 4, 5), "table": f(16, 8)}}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree_paths(tree).items()}


def _close(got, want, rtol=RTOL, atol=0.0):
    got, want = _np(got), _np(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


CFGS = [O.OptimizerConfig(learning_rate=1e-3, warmup_steps=2,
                          total_steps=6),
        O.OptimizerConfig(learning_rate=3e-4, warmup_steps=1,
                          total_steps=4, clip_norm=1e6, weight_decay=0.0)]


@pytest.mark.parametrize("cfg", CFGS, ids=["clipped", "unclipped"])
def test_adamw_update_equals_the_reference(cfg):
    jcfg = JO.OptimizerConfig(**cfg.__dict__)
    p0 = _tree(0)
    jp, jst = jax.tree.map(jnp.asarray, p0), JO.init_opt_state(p0)
    tp = load_jax_params(p0, "cpu")
    tst = O.init_opt_state(tp)
    for i in range(5):                       # warmup, then the cosine
        g = _tree(10 + i, scale=3.0)
        jp, jst, jm = JO.adamw_update(jcfg, jp, jax.tree.map(jnp.asarray, g),
                                      jst)
        tp2, tst2, tm = O.adamw_update(cfg, tp, load_jax_params(g, "cpu"),
                                       tst)
        assert tp2 is tp and tst2 is tst          # in place
        assert int(tst.step) == int(jst.step) == i + 1
        assert tst.step.dtype == torch.int32
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
        _close(tp, jp)
        _close(tst.mu, jst.mu)
        _close(tst.nu, jst.nu)
    if cfg.clip_norm < 1e3:
        assert float(jm["grad_norm"]) > cfg.clip_norm   # the clip acted


def test_lr_at_over_warmup_and_cosine():
    """At the cosine's end ``1 + cos`` cancels: an ulp of ``cos`` is a
    larger share of the small rate there, so the bar is also absolute,
    RTOL times the peak rate."""
    cfg = O.OptimizerConfig(learning_rate=3e-4, warmup_steps=10,
                            total_steps=50)
    jcfg = JO.OptimizerConfig(**cfg.__dict__)
    for s in range(0, 60):
        got = O.lr_at(cfg, torch.tensor(s, dtype=torch.int32))
        want = JO.lr_at(jcfg, jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   atol=RTOL * cfg.learning_rate)


def test_global_norm_sums_in_jax_leaf_order():
    g = _tree(3)
    assert [k for k in sorted(tree_paths(g))] == \
        [k for k in tree_paths(_sorted(g))]
    np.testing.assert_allclose(float(O.global_norm(load_jax_params(g, "cpu"))),
                               float(JO.global_norm(g)), rtol=RTOL)
    assert [t.shape for t in O.leaves(load_jax_params(g, "cpu"))] == \
        [x.shape for x in jax.tree.leaves(g)]


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


# ---- the step, with accumulation ----

def _qwen2_smoke():
    jm = jbuild_model(jget_config("qwen2_1_5b", smoke=True))
    jp = jinit_params(jm.param_specs, jax.random.PRNGKey(1), jnp.float32)
    return jm, jax.tree.map(np.asarray, jp), build_model(
        get_config("qwen2_1_5b", smoke=True))


def test_accumulation_equals_the_full_batch_and_jax():
    jm, p0, tm = _qwen2_smoke()
    toks = np.random.default_rng(2).integers(0, 64, (4, 16)).astype(np.int32)
    cfg = O.OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                            total_steps=5)
    out = {}
    for mb in (1, 2):
        params = load_jax_params(p0, "cpu")
        step = make_train_step(tm, cfg, microbatches=mb)
        p, st, m = step(params, O.init_opt_state(params),
                        {"tokens": torch.from_numpy(toks)})
        assert p is params and not any(t.requires_grad
                                       for t in tree_paths(p).values())
        out[mb] = (p, st, m)
    (p1, _, m1), (p2, st2, m2) = out[1], out[2]
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    _close(p1, p2, rtol=0.0, atol=5e-4)
    assert set(m1) == {"loss", "aux", "grad_norm", "lr"}
    assert set(m2) == {"loss", "grad_norm", "lr"}

    jstep = jmake_step(jm, JO.OptimizerConfig(**cfg.__dict__),
                       microbatches=2)
    jp2, jst2, jm2 = jax.jit(jstep)(jax.tree.map(jnp.asarray, p0),
                                    JO.init_opt_state(p0),
                                    {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(jm2["grad_norm"]), rtol=1e-4)
    _close(p2, jp2, rtol=0.0, atol=5e-4)
    _close(st2.mu, jst2.mu, rtol=1e-3, atol=1e-6)


def test_compress_grads_is_the_round_trip_before_the_update():
    """``compress_grads=True`` is ``compress_decompress`` of the gradients,
    then AdamW: bit for bit the same as doing those by hand.  (Against
    JAX's step an element whose gradient lies an ulp from an int8 rounding
    boundary takes another level, and Adam's first step moves it by the
    whole rate; ``_q8`` itself is held to JAX's below.)"""
    _, p0, tm = _qwen2_smoke()
    toks = np.random.default_rng(4).integers(0, 64, (2, 16)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks)}
    cfg = O.OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                            total_steps=5)
    params = load_jax_params(p0, "cpu")
    p, _, met = make_train_step(tm, cfg, compress_grads=True)(
        params, O.init_opt_state(params), batch)

    by_hand = load_jax_params(p0, "cpu")
    live = O.tree_map(lambda t: t.clone().requires_grad_(True), by_hand)
    loss, _ = tm.train_loss(live, batch)
    grads = O.from_leaves(by_hand, torch.autograd.grad(loss,
                                                        O.leaves(live)))
    q = C.compress_decompress(grads)
    _, _, want = O.adamw_update(cfg, by_hand, q, O.init_opt_state(by_hand))
    assert torch.equal(met["grad_norm"], want["grad_norm"])
    for k, t in tree_paths(by_hand).items():
        assert torch.equal(tree_paths(p)[k], t), k


# ---- compression ----

def test_compress_decompress_and_error_feedback_match_leaf_by_leaf():
    g1, g2 = _tree(5, scale=0.01), _tree(6, scale=0.01)
    _close(C.compress_decompress(load_jax_params(g1, "cpu")),
           JC.compress_decompress(g1))
    tq, tr = C.ef_compress(load_jax_params(g1, "cpu"), None)
    jq, jr = JC.ef_compress(g1, None)
    _close(tq, jq)
    _close(tr, jr, atol=1e-9)
    tq, tr = C.ef_compress(load_jax_params(g2, "cpu"), tr)
    jq, jr = JC.ef_compress(g2, jr)
    _close(tq, jq)
    _close(tr, jr, atol=1e-9)
    assert max(float(np.abs(x).max()) for x in _np(tr).values()) > 0


# ---- elastic ----

def test_elastic_gives_the_reference_answers():
    assert [(m.shape, m.axes, m.chips, m.dp_degree)
            for m in E.CANDIDATE_MESHES] == \
        [(m.shape, m.axes, m.chips, m.dp_degree)
         for m in JE.CANDIDATE_MESHES]
    for healthy in (0, 63, 64, 100, 255, 256, 511, 512, 1000):
        got, want = E.plan_after_failure(healthy), \
            JE.plan_after_failure(healthy)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.shape, got.axes) == (want.shape, want.axes)
    for args in ((256, 32, 16, 1), (512, 32, 8, 2), (64, 16, 4, 3)):
        assert E.rebalance_microbatches(*args) == \
            JE.rebalance_microbatches(*args)
    with pytest.raises(ValueError):
        E.rebalance_microbatches(10, 2, 3, 1)
    assert E.reassign_data_ranges([3, 5, 7], [0, 1]) == \
        JE.reassign_data_ranges([3, 5, 7], [0, 1])


# ---- the driver ----

RUN = dict(smoke=True, batch=4, seq=32, lr=3e-3, device="cpu", log=None)


def test_run_resumes_bit_equal(tmp_path):
    straight = train_launch.run(steps=4, **RUN)
    ckpt = str(tmp_path / "ckpt")
    first = train_launch.run(steps=2, checkpoint_dir=ckpt,
                             checkpoint_every=2, **RUN)
    assert sorted(p.name for p in tmp_path.joinpath("ckpt").iterdir()) == \
        ["step_2"]
    resumed = train_launch.run(steps=4, checkpoint_dir=ckpt, resume=True,
                               checkpoint_every=100, **RUN)
    assert resumed["step0"] == 2
    assert first["losses"] + resumed["losses"] == straight["losses"]
    position = ("epoch", "shard_idx", "page", "tokens_consumed",
                "shard_order")
    assert {k: resumed["data"][k] for k in position} == \
        {k: straight["data"][k] for k in position}
    got, want = tree_paths(resumed["params"]), tree_paths(straight["params"])
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(O.leaves(resumed["opt_state"].mu),
                    O.leaves(straight["opt_state"].mu)):
        assert torch.equal(a, b)
    assert int(resumed["opt_state"].step) == 4
    assert straight["cache"]["misses"] >= 1
    assert all(np.isfinite(straight["grad_norms"]))


def test_main_takes_the_reference_flags_and_device():
    out = train_launch.main(["--smoke", "--steps", "2", "--batch", "2",
                             "--seq", "16", "--microbatches", "2",
                             "--cache-policy", "lru", "--device", "cpu"])
    assert len(out["losses"]) == 2 and out["cache"]["misses"] >= 1
