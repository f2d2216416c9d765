"""The port's training loss (``Model.train_loss``) against the JAX
package's, at smoke widths on the CPU, f32, the JAX weights carried across
by ``load_jax_params``:

* every architecture's loss within rtol 1e-5 of JAX's, the MoE's ``aux``
  metric within 1e-5, at the reference's own draw;
* the MoE's aux loss reaches the loss as ``0.01 * aux``; the vision stub's
  patch positions carry no loss;
* ``remat`` ``none`` / ``dots`` / ``full`` give equal losses and gradients
  (bit for bit: a checkpoint recomputes the same operations);
* a fault of the reference, asserted as a difference: at its own draw,
  zamba2's ``jax.grad`` is NaN in every leaf before the final norm
  (``ssd_chunked`` takes
  ``jnp.where(mask, exp(li), 0)``: ``exp`` overflows above the diagonal
  and its cotangent 0 * inf is NaN), where the port masks before the
  ``exp`` and its gradient is finite.

The gradients' parity with ``jax.grad`` is in ``test_torch_train_grads.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    build_model, load_jax_params, tree_paths,
)
from repro_torch.models import transformer as Tr  # noqa: E402
from repro_torch.models.layers import unflatten  # noqa: E402

LOSS_RTOL = AUX_TOL = 1e-5
B, T = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    # the suite runs one file per worker, several workers at once: intra-op
    # threads would only contend for the CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def smoke_pair(arch):
    """The JAX smoke model with weights from seed 0 (numpy leaves) and the
    port's model."""
    jm = jbuild_model(jget_config(arch, smoke=True))
    jp = jinit_params(jm.param_specs, jax.random.PRNGKey(0), jnp.float32)
    return jm, jax.tree.map(np.asarray, jp), build_model(
        get_config(arch, smoke=True))


def make_batch(cfg, seed=1):
    """A numpy batch of B rows of T tokens: the vision stub's patch
    embeddings before them, the encoder-decoder's T frames beside them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    if cfg.is_encdec:
        return {"src_embeds": rng.standard_normal(
            (B, T, cfg.d_model)).astype(np.float32), "tgt_tokens": toks}
    if cfg.frontend == "vision":
        return {"tokens": toks, "patch_embeds": rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)}
    return {"tokens": toks}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_equals_the_reference(arch):
    jm, jp, tm = smoke_pair(arch)
    batch = make_batch(tm.cfg)
    jloss, jmet = jax.jit(jm.train_loss)(jax.tree.map(jnp.asarray, jp),
                                         batch)
    loss, met = tm.train_loss(load_jax_params(jp, "cpu"), _torch(batch))
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert set(met) == set(jmet)
    if tm.cfg.moe:
        assert float(jmet["aux"]) > 0
        np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                                   atol=AUX_TOL, rtol=AUX_TOL)


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m",
                                  "llama4_scout_17b_a16e"])
def test_the_moe_aux_loss_reaches_the_loss(arch):
    _, jp, tm = smoke_pair(arch)
    params = load_jax_params(jp, "cpu")
    batch = _torch(make_batch(tm.cfg))
    loss, met = tm.train_loss(params, batch)
    assert float(met["aux"]) > 0
    # the cross entropy alone, from the head's logits of every position
    x, aux = Tr._lm_backbone(params, Tr._lm_embed_inputs(params, batch,
                                                         tm.cfg), tm.cfg)
    head = params.get("lm_head", params["embed"]["table"])
    xent = Tr._next_token_loss(x @ head.T, batch["tokens"])
    assert torch.equal(aux, met["aux"])
    assert torch.equal(loss, xent + 0.01 * aux)


def test_patch_positions_carry_no_loss():
    """internvl2: the loss is the same whatever the patch embeddings'
    positions predict; only the text's next tokens count."""
    _, jp, tm = smoke_pair("internvl2_26b")
    params = load_jax_params(jp, "cpu")
    batch = _torch(make_batch(tm.cfg))
    loss, _ = tm.train_loss(params, batch)
    x, _ = Tr._lm_backbone(params, Tr._lm_embed_inputs(params, batch,
                                                       tm.cfg), tm.cfg)
    head = params.get("lm_head", params["embed"]["table"])
    text = Tr._next_token_loss(x[:, tm.cfg.frontend_tokens:] @ head.T,
                               batch["tokens"])
    assert torch.equal(loss, text)


REMAT_ARCHS = ("qwen2_1_5b", "granite_moe_1b_a400m", "gemma3_12b",
               "seamless_m4t_large_v2", "zamba2_2_7b", "xlstm_350m")


def _loss_and_grads(model, params, batch):
    live = {k: v.detach().requires_grad_(True)
            for k, v in tree_paths(params).items()}
    loss, _ = model.train_loss(unflatten(live), batch)
    return loss, torch.autograd.grad(loss, list(live.values()))


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_changes_no_value(arch):
    _, jp, tm = smoke_pair(arch)
    params = load_jax_params(jp, "cpu")
    batch = _torch(make_batch(tm.cfg))
    runs = {mode: _loss_and_grads(
        build_model(dataclasses.replace(tm.cfg, remat=mode)), params, batch)
        for mode in ("none", "dots", "full")}
    loss0, grads0 = runs["none"]
    for mode in ("dots", "full"):
        loss, grads = runs[mode]
        assert torch.equal(loss, loss0), mode
        for g, g0 in zip(grads, grads0):
            assert torch.equal(g, g0), mode


def test_remat_dots_saves_only_the_matrix_products():
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    assert Tr._save_dots(None, aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert Tr._save_dots(None, aten.addmm.default) == \
        CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.exp.default, aten.softmax.int):
        assert Tr._save_dots(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


def test_reference_zamba2_gradient_is_nan_where_the_ports_is_finite():
    jm, jp, tm = smoke_pair("zamba2_2_7b")
    batch = make_batch(tm.cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.train_loss(p, batch)[0]))(jax.tree.map(jnp.asarray, jp))
    assert np.isfinite(float(jloss))
    jg = tree_paths(jax.tree.map(np.asarray, jgrads))
    assert all(np.isnan(g).any() for k, g in jg.items() if k != "ln_f")
    loss, grads = _loss_and_grads(tm, load_jax_params(jp, "cpu"),
                                  _torch(batch))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
