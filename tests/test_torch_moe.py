"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe``, on the CPU in f32 with the JAX weights carried
across, at both MoE smoke configs (granite: 4 experts top-2; llama4: 4
experts top-1):

* sorted and dense dispatch equal the JAX functions at atol = rtol = 1e-5
  of the output's scale, on an input whose tokens lean to the same
  experts, so that the sorted dispatch drops assignments past an
  expert's capacity (asserted);
* the aux loss equals the JAX one;
* with a capacity factor that leaves no drop, the port's sorted dispatch
  equals its dense one;
* the capacity is ``max(8, ceil(T k / E * cf))`` rounded up to 8.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import load_jax_params  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

ARCHS = ("granite_moe_1b_a400m", "llama4_scout_17b_a16e")
TOL = 1e-5


def _close_to_scale(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    scale = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=scale, rtol=tol)


def _setup(arch, seed=0, **replace):
    cfg_j = dataclasses.replace(jget_config(arch, smoke=True), **replace)
    cfg_t = dataclasses.replace(get_config(arch, smoke=True), **replace)
    jp = jinit_params(JM.moe_specs(cfg_j), jax.random.PRNGKey(seed),
                      jnp.float32)
    tp = load_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    return cfg_j, cfg_t, jp, tp


def _leaning(cfg, B=2, T=96, seed=1):
    """Tokens that share one direction: the router sends most of them to
    the same experts."""
    rng = np.random.default_rng(seed)
    common = rng.normal(0, 1, cfg.d_model)
    return (rng.normal(0, 1, (B, T, cfg.d_model)) + 3.0 * common).astype(
        np.float32)


def _drops(cfg, tp, x) -> int:
    """Assignments past an expert's capacity, over the rows of ``x``."""
    B, T, d = x.shape
    _, idx, _ = M._route(tp, torch.from_numpy(x).reshape(-1, d), cfg)
    counts = torch.nn.functional.one_hot(idx.reshape(B, -1),
                                         cfg.n_experts).sum(1)
    return int((counts - M.capacity(T, cfg)).clamp(min=0).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_sorted_and_dense_match_jax_where_tokens_drop(arch):
    cfg_j, cfg_t, jp, tp = _setup(arch)
    x = _leaning(cfg_t)
    assert _drops(cfg_t, tp, x) > 0          # the capacity is reached
    for jfn, tfn in ((JM.moe_ffn_sorted, M.moe_ffn_sorted),
                     (JM.moe_ffn_dense, M.moe_ffn_dense)):
        want, waux = jfn(jp, jnp.asarray(x), cfg_j)
        got, gaux = tfn(tp, torch.from_numpy(x), cfg_t)
        assert got.shape == x.shape and got.dtype == torch.float32
        _close_to_scale(got, want)
        np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-6)
    sorted_y = M.moe_ffn_sorted(tp, torch.from_numpy(x), cfg_t)[0]
    dense_y = M.moe_ffn_dense(tp, torch.from_numpy(x), cfg_t)[0]
    assert float((sorted_y - dense_y).abs().max()) > 1e-3   # drops show


@pytest.mark.parametrize("arch", ARCHS)
def test_sorted_equals_dense_without_drops(arch):
    """A capacity factor of E / k gives every expert room for every token
    of its row: nothing drops and the two dispatches agree."""
    cfg = get_config(arch, smoke=True)
    _, cfg_t, _, tp = _setup(arch, capacity_factor=cfg.n_experts / cfg.top_k)
    x = _leaning(cfg_t, seed=2)
    assert _drops(cfg_t, tp, x) == 0
    got, gaux = M.moe_ffn_sorted(tp, torch.from_numpy(x), cfg_t)
    want, waux = M.moe_ffn_dense(tp, torch.from_numpy(x), cfg_t)
    _close_to_scale(got, want)
    assert float(gaux) == float(waux)
    one, _ = M.moe_ffn(tp, torch.from_numpy(x), cfg_t)
    assert torch.equal(one, got)
    dense_cfg = dataclasses.replace(cfg_t, moe_impl="dense")
    assert torch.equal(M.moe_ffn(tp, torch.from_numpy(x), dense_cfg)[0],
                       want)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_matches_jax_on_a_balanced_input(arch):
    cfg_j, cfg_t, jp, tp = _setup(arch, seed=3)
    x = np.random.default_rng(4).normal(0, 1, (3, 40, cfg_t.d_model)).astype(
        np.float32)
    _, waux = JM.moe_ffn_sorted(jp, jnp.asarray(x), cfg_j)
    got, gaux = M.moe_ffn_sorted(tp, torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-6)
    assert gaux.dtype == torch.float32 and gaux.dim() == 0
    # Switch's loss is E * sum(mean prob * mean load): 1 when balanced
    assert 0.5 < float(gaux) < float(cfg_t.n_experts)


def test_capacity_rule():
    cfg = get_config("granite_moe_1b_a400m")            # E 32, k 8, cf 1.25
    assert M.capacity(4096, cfg) == 1280
    assert M.capacity(1, cfg) == 8                      # decode: no drop
    cfg = get_config("llama4_scout_17b_a16e")           # E 16, k 1
    assert M.capacity(4096, cfg) == 320
    assert M.capacity(13, dataclasses.replace(cfg, n_experts=4)) == 8
    assert M.capacity(100, dataclasses.replace(cfg, n_experts=4)) == 32
