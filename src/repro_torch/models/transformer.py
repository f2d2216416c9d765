"""Model assembly: the serving surface of three families (port of
``repro.models.transformer``).

* ``dense`` — decoder-only LM, a Python loop over the L stacked blocks
  (qwen2_1_5b, gemma_7b, deepseek_67b; gemma's embedding scale kept).
* ``hybrid`` (zamba2) — Mamba2 blocks; ONE shared attention+MLP block
  (zamba's parameter sharing) applied after every ``attn_every``-th layer,
  reading concat([h, emb]); the reference's ``lax.cond`` is an ``if``.
* ``ssm`` (xlstm) — groups of ``xlstm_slstm_every - 1`` chunked mLSTM
  blocks + 1 sequential sLSTM block.

:func:`build_model` returns a :class:`Model` whose ``prefill_logits``,
``serve_step`` and ``cache_specs`` keep the JAX names and signatures: a
params tree of tensors in the JAX layout (stacked leading layer axes), a
batch dict of ``tokens`` / ``token`` / ``pos``.  ``lax.scan`` over layers
is a Python loop.  ``serve_step`` updates the cache tensors **in place**
and returns the same dict.  Prefill reaches the port's kernels through
``blocked_attention``, ``mamba2_block`` and ``mlstm_block``.

The reference's ``_remat`` (activation checkpointing) and
``shardctx.constrain_batch`` (a sharding constraint) change no value of a
forward pass and have no counterpart here.  Training (``train_loss``) is
not ported yet (ROADMAP A.8); MoE, the 5:1 local:global ring, the vision
stub and the encoder-decoder raise ``NotImplementedError`` (ROADMAP A.10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from ..configs.base import ArchConfig
from . import attention as A
from . import ssm as S
from . import xlstm as X
from .layers import (
    ParamSpec, embed_tokens, embedding_specs, gated_mlp, gated_mlp_specs,
    layer, rms_norm,
)


def _stack_specs(specs: Any, n: int) -> Any:
    """Prepend a layer dimension to every ParamSpec in a tree."""
    if isinstance(specs, ParamSpec):
        return ParamSpec(
            (n,) + specs.shape, ("layers",) + specs.logical, specs.init, specs.scale
        )
    return {k: _stack_specs(v, n) for k, v in specs.items()}


@dataclass
class Model:
    cfg: ArchConfig
    param_specs: Any
    train_loss: Callable          # (params, batch) -> (loss, metrics)
    prefill_logits: Callable      # (params, batch) -> logits (B, 1, V)
    serve_step: Callable          # (params, cache, batch) -> (logits, cache)
    cache_specs: Callable         # (batch, seq) -> dict of TensorSpec


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet "
                               f"(ROADMAP {item})")


def _no_training(params, batch):
    raise _not_ported("training (train_loss)", "A.8")


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family == "audio" or cfg.is_encdec:
        raise _not_ported("the encoder-decoder family", "A.10")
    if cfg.family == "hybrid":
        return _build_hybrid(cfg)
    if cfg.family == "ssm":
        return _build_xlstm(cfg)
    if cfg.moe:
        raise _not_ported("the MoE FFN", "A.10")
    if cfg.local_global_ratio > 0:
        raise _not_ported("the 5:1 local:global attention ring", "A.10")
    if cfg.frontend is not None:
        raise _not_ported("the vision frontend stub", "A.10")
    return _build_lm(cfg)


def _pos(batch) -> int:
    return int(batch["pos"])


def _head_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,vd->...v")``."""
    return x @ head.T


# ------------------------------------------------------------------ LM ----

def _block_specs(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln_attn": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "attn": A.attn_specs(cfg),
        "ln_ffn": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "mlp": gated_mlp_specs(cfg.d_model, cfg.d_ff),
    }


def _block_apply(params, x, cfg: ArchConfig, window: Optional[int]):
    h = rms_norm(x, params["ln_attn"], cfg.norm_eps)
    x = x + A.mha_train(params["attn"], h, cfg, window=window)
    h = rms_norm(x, params["ln_ffn"], cfg.norm_eps)
    return x + gated_mlp(params["mlp"], h, cfg.ffn_act)


def _block_decode(params, x, k, v, pos: int, cfg: ArchConfig,
                  window: Optional[int]):
    h = rms_norm(x, params["ln_attn"], cfg.norm_eps)
    y, k, v = A.mha_decode(params["attn"], h, k, v, pos, cfg, window=window)
    x = x + y
    h = rms_norm(x, params["ln_ffn"], cfg.norm_eps)
    return x + gated_mlp(params["mlp"], h, cfg.ffn_act)


def _build_lm(cfg: ArchConfig) -> Model:
    specs: Dict[str, Any] = {
        "embed": embedding_specs(cfg.padded_vocab, cfg.d_model),
        "ln_f": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "layers": _stack_specs(_block_specs(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec(
            (cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), scale=1.0
        )

    def embed(params, tokens):
        x = embed_tokens(params["embed"], tokens)
        if cfg.name.startswith("gemma"):   # gemma embed scaling, in x's type
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def head(params):
        return params.get("lm_head", params["embed"]["table"])

    def prefill_logits(params, batch):
        x = embed(params, batch["tokens"])
        for i in range(cfg.n_layers):
            x = _block_apply(layer(params["layers"], i), x, cfg,
                             cfg.sliding_window)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return _head_logits(x[:, -1:], head(params))

    def cache_specs(batch: int, seq: int):
        return A.kv_cache_specs(cfg, batch, seq)

    def serve_step(params, cache, batch):
        pos = _pos(batch)
        x = embed(params, batch["token"])
        for i in range(cfg.n_layers):
            x = _block_decode(layer(params["layers"], i), x, cache["k"][i],
                              cache["v"][i], pos, cfg, cfg.sliding_window)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return _head_logits(x, head(params)), cache

    return Model(cfg, specs, _no_training, prefill_logits, serve_step,
                 cache_specs)


# ----------------------------------------------------------- hybrid (zamba)

def _shared_attn_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """Zamba2 shared block: attention over concat([h, emb]) (2d) -> d."""
    d2 = 2 * cfg.d_model
    dh = d2 // cfg.n_heads
    return {
        "ln": ParamSpec((d2,), ("embed",), init="zeros"),
        "wq": ParamSpec((d2, cfg.n_heads * dh), ("embed", "q_dim")),
        "wk": ParamSpec((d2, cfg.n_kv_heads * dh), ("embed", "q_dim")),
        "wv": ParamSpec((d2, cfg.n_kv_heads * dh), ("embed", "q_dim")),
        "wo": ParamSpec((cfg.n_heads * dh, cfg.d_model), ("q_dim", "embed")),
        "ln_ffn": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "mlp": gated_mlp_specs(cfg.d_model, cfg.d_ff),
    }


def _shared_attn_apply(p, x, emb, cfg: ArchConfig, kv=None,
                       pos: Optional[int] = None):
    """Prefill (``kv=None``, through ``blocked_attention``) or decode
    (``kv=(k, v)`` cache slices, the new K/V written at ``pos`` in
    place)."""
    d2 = 2 * cfg.d_model
    dh = d2 // cfg.n_heads
    hk = cfg.n_kv_heads
    h = rms_norm(torch.cat([x, emb], dim=-1), p["ln"], cfg.norm_eps)
    b, t, _ = h.shape
    q = (h @ p["wq"]).reshape(b, t, cfg.n_heads, dh)
    k = (h @ p["wk"]).reshape(b, t, hk, dh)
    v = (h @ p["wv"]).reshape(b, t, hk, dh)
    if kv is None:
        positions = torch.arange(t, device=x.device)[None, :]
        q = A.apply_rope(q, positions, cfg.rope_theta)
        k = A.apply_rope(k, positions, cfg.rope_theta)
        out = A.blocked_attention(q, A._expand_kv(k, cfg.n_heads),
                                  A._expand_kv(v, cfg.n_heads), causal=True)
    else:
        ck, cv = kv
        positions = torch.full((b, 1), pos, device=x.device)
        q = A.apply_rope(q, positions, cfg.rope_theta)
        k = A.apply_rope(k, positions, cfg.rope_theta)
        ck[:, pos] = k[:, 0].to(ck.dtype)
        cv[:, pos] = v[:, 0].to(cv.dtype)
        kf = A._expand_kv(ck, cfg.n_heads).float()
        vf = A._expand_kv(cv, cfg.n_heads).float()
        scores = torch.einsum("bqhd,bshd->bhqs", q.float(), kf) * dh ** -0.5
        valid = torch.arange(kf.shape[1], device=x.device) <= pos
        scores = scores.masked_fill(~valid, A.NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqs,bshd->bqhd", probs, vf).to(x.dtype)
    x = x + out.reshape(b, t, cfg.n_heads * dh) @ p["wo"]
    hh = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    return x + gated_mlp(p["mlp"], hh, cfg.ffn_act)


def _build_hybrid(cfg: ArchConfig) -> Model:
    specs = {
        "embed": embedding_specs(cfg.padded_vocab, cfg.d_model),
        "mamba": _stack_specs(S.mamba2_specs(cfg), cfg.n_layers),
        "shared_attn": _shared_attn_specs(cfg),
        "ln_f": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
    }
    every = max(1, cfg.attn_every)

    def prefill_logits(params, batch):
        x = embed_tokens(params["embed"], batch["tokens"])
        emb = x
        for i in range(cfg.n_layers):
            x = x + S.mamba2_block(layer(params["mamba"], i), x, cfg)
            if i % every == every - 1:
                x = _shared_attn_apply(params["shared_attn"], x, emb, cfg)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return _head_logits(x[:, -1:], params["embed"]["table"])

    n_uses = cfg.n_layers // every
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_head_dim
    d2h = 2 * cfg.d_model // cfg.n_heads

    def cache_specs(batch: int, seq: int):
        return {
            "mamba_h": A.TensorSpec(
                (cfg.n_layers, batch, nh, cfg.ssm_head_dim, cfg.ssm_state),
                torch.float32),
            "mamba_conv": A.TensorSpec(
                (cfg.n_layers, batch, cfg.ssm_conv - 1, di + 2 * cfg.ssm_state),
                torch.bfloat16),
            "attn_k": A.TensorSpec(
                (n_uses, batch, seq, cfg.n_kv_heads, d2h), torch.bfloat16),
            "attn_v": A.TensorSpec(
                (n_uses, batch, seq, cfg.n_kv_heads, d2h), torch.bfloat16),
        }

    def serve_step(params, cache, batch):
        pos = _pos(batch)
        x = embed_tokens(params["embed"], batch["token"])
        emb = x
        mh, mc = cache["mamba_h"], cache["mamba_conv"]
        # the reference groups the layers by attention use; the cache of
        # use u holds the shared block's K/V after layer (u+1)*every - 1
        for u in range(n_uses):
            for i in range(u * every, (u + 1) * every):
                y, h, c = S.mamba2_decode_step(layer(params["mamba"], i), x,
                                               mh[i], mc[i], cfg)
                x = x + y
                mh[i], mc[i] = h, c
            x = _shared_attn_apply(params["shared_attn"], x, emb, cfg,
                                   kv=(cache["attn_k"][u], cache["attn_v"][u]),
                                   pos=pos)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return _head_logits(x, params["embed"]["table"]), cache

    return Model(cfg, specs, _no_training, prefill_logits, serve_step,
                 cache_specs)


# ------------------------------------------------------------- xLSTM -------

def _build_xlstm(cfg: ArchConfig) -> Model:
    period = max(2, cfg.xlstm_slstm_every)          # e.g. 8 => 7 mLSTM + 1 sLSTM
    n_groups = cfg.n_layers // period
    n_m = period - 1
    m_block = {
        "ln": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "m": X.mlstm_specs(cfg),
    }
    s_block = {
        "ln": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "s": X.slstm_specs(cfg),
    }
    specs = {
        "embed": embedding_specs(cfg.padded_vocab, cfg.d_model),
        "mlstm": _stack_specs(_stack_specs(m_block, n_m), n_groups),
        "slstm": _stack_specs(s_block, n_groups),
        "ln_f": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
    }

    def prefill_logits(params, batch):
        x = embed_tokens(params["embed"], batch["tokens"])
        for g in range(n_groups):
            for j in range(n_m):
                lp = layer(params["mlstm"], g, j)
                h = rms_norm(x, lp["ln"], cfg.norm_eps)
                x = x + X.mlstm_block(lp["m"], h, cfg)
            sp = layer(params["slstm"], g)
            h = rms_norm(x, sp["ln"], cfg.norm_eps)
            x = x + X.slstm_block(sp["s"], h, cfg)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return _head_logits(x[:, -1:], params["embed"]["table"])

    di = 2 * cfg.d_model
    K = di // cfg.n_heads
    dh = cfg.d_model // cfg.n_heads

    def cache_specs(batch: int, seq: int):
        del seq  # recurrent state: O(1) in context length
        f32 = torch.float32
        hs = (n_groups, batch, cfg.n_heads, dh)
        return {
            "mC": A.TensorSpec((n_groups, n_m, batch, cfg.n_heads, K, K), f32),
            "mN": A.TensorSpec((n_groups, n_m, batch, cfg.n_heads, K), f32),
            "sc": A.TensorSpec(hs, f32),
            "sn": A.TensorSpec(hs, f32),
            "sh": A.TensorSpec(hs, f32),
            "sm": A.TensorSpec(hs, f32),
        }

    def serve_step(params, cache, batch):
        x = embed_tokens(params["embed"], batch["token"])
        for g in range(n_groups):
            for j in range(n_m):
                lp = layer(params["mlstm"], g, j)
                h = rms_norm(x, lp["ln"], cfg.norm_eps)
                y, C, n = X.mlstm_decode_step(lp["m"], h, cache["mC"][g, j],
                                              cache["mN"][g, j], cfg)
                x = x + y
                cache["mC"][g, j], cache["mN"][g, j] = C, n
            sp = layer(params["slstm"], g)
            h = rms_norm(x, sp["ln"], cfg.norm_eps)
            st = {s: cache[f"s{s}"][g] for s in "cnhm"}
            y, st = X.slstm_decode_step(sp["s"], h, st, cfg)
            x = x + y
            for s in "cnhm":
                cache[f"s{s}"][g] = st[s]
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return _head_logits(x, params["embed"]["table"]), cache

    return Model(cfg, specs, _no_training, prefill_logits, serve_step,
                 cache_specs)
