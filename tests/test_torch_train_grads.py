"""The port's gradients of ``Model.train_loss`` against ``jax.grad`` of the
JAX package's, at smoke widths on the CPU, f32: the LM builder's dense
family, MoE, vision stub and 5:1 ring (qwen2, granite, internvl2, gemma3)
here, the other three builders (seamless, zamba2, xlstm) in
``test_torch_train_grads_builders.py`` (two files, so that the suite's
workers share the JAX compilations).  Every leaf within atol = rtol = 1e-4
times its largest magnitude (``test_torch_models.py``'s ``_close_to_scale``).

The weights are the JAX package's draw from seed 0 with every stacked
matrix rescaled to its own fan-in (``models.layers.fan_in_rescale``, as
``chip_smoke.py`` draws them), carried across to the port.  At the
reference's own draw (``ParamSpec.fan_in_scale`` reads the layer count on
stacked specs: ROADMAP §C) the gradients are too ill-conditioned for that
bar: JAX's own gradient of a leaf moves by up to 2.4e-4 (gemma3) and
5.8e-4 (seamless) normwise between f32 and f64 weights, and zamba2's is
NaN (``test_torch_train_loss.py``).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    build_model, load_jax_params, tree_paths,
)
from repro_torch.models.layers import fan_in_rescale, unflatten  # noqa: E402

FAMILIES = ("qwen2_1_5b", "granite_moe_1b_a400m", "internvl2_26b",
            "gemma3_12b")
TOL = 1e-4
B, T = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def rescaled_pair(arch):
    """The JAX smoke model and the port's, with the same weights: JAX's
    draw from seed 0, each stacked matrix rescaled to its fan-in
    (numpy leaves)."""
    jm = jbuild_model(jget_config(arch, smoke=True))
    tm = build_model(get_config(arch, smoke=True))
    jp = jinit_params(jm.param_specs, jax.random.PRNGKey(0), jnp.float32)
    tp = fan_in_rescale(tm.param_specs,
                        load_jax_params(jax.tree.map(np.asarray, jp), "cpu"))
    return jm, tm, {k: v.numpy() for k, v in tree_paths(tp).items()}


def make_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    if cfg.is_encdec:
        return {"src_embeds": rng.standard_normal(
            (B, T, cfg.d_model)).astype(np.float32), "tgt_tokens": toks}
    if cfg.frontend == "vision":
        return {"tokens": toks, "patch_embeds": rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)}
    return {"tokens": toks}


def check_gradients(arch):
    """Every leaf's gradient of ``arch``'s loss against ``jax.grad``."""
    jm, tm, flat = rescaled_pair(arch)
    batch = make_batch(tm.cfg)
    jp = jax.tree.map(jnp.asarray, unflatten(flat))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(jp, batch)
    want = tree_paths(jax.tree.map(np.asarray, jgrads))

    live = {k: torch.from_numpy(v.copy()).requires_grad_(True)
            for k, v in flat.items()}
    loss, _ = tm.train_loss(unflatten(live),
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    got = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    assert set(got) == set(want)
    for path, w in want.items():
        assert np.isfinite(w).all(), path
        g = got[path].numpy()
        tol = TOL * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=path)


@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_equal_jax_grad(arch):
    check_gradients(arch)
