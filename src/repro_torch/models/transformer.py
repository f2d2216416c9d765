"""Model assembly: the serving surface of every family (port of
``repro.models.transformer``).

* ``dense | moe | vlm`` — decoder-only LM, a Python loop over the L
  stacked blocks (qwen2_1_5b, gemma_7b, deepseek_67b; the MoE FFN of
  granite_moe_1b_a400m and llama4_scout_17b_a16e, ``models.moe``; the
  vision stub of internvl2_26b, whose precomputed ``patch_embeds`` are
  prepended to the text).  gemma3_12b's 5:1 local:global pattern is two
  loops, groups of 5 sliding-window layers and 1 global layer, and its
  decode keeps the local layers' K/V in ring buffers of the window's
  length (``mha_decode(ring=True)``).
* ``audio`` (seamless_m4t_large_v2) — encoder-decoder: a bidirectional
  encoder over precomputed frame embeddings (the stub frontend), a causal
  decoder with cross-attention to the encoder's output.  Decode reads the
  cross K/V from the cache (``cache["cross"]``), filled by the caller.
* ``hybrid`` (zamba2) — Mamba2 blocks; ONE shared attention+MLP block
  (zamba's parameter sharing) applied after every ``attn_every``-th layer,
  reading concat([h, emb]); the reference's ``lax.cond`` is an ``if``.
* ``ssm`` (xlstm) — groups of ``xlstm_slstm_every - 1`` chunked mLSTM
  blocks + 1 sequential sLSTM block.

:func:`build_model` returns a :class:`Model` whose ``prefill_logits``,
``serve_step``, ``cache_specs`` and ``train_loss`` keep the JAX names and
signatures: a params tree of tensors in the JAX layout (stacked leading
layer axes), a batch dict of ``tokens`` / ``token`` / ``pos``
(``patch_embeds``, ``src_embeds`` / ``tgt_tokens``).  ``lax.scan`` over
layers is a Python loop.  ``serve_step`` updates the cache tensors **in
place** and returns the same dict.  Prefill and training reach the port's
kernels through ``blocked_attention``, ``mamba2_block`` and
``mlstm_block``; under autograd on the card those run the kernel forward
and the plain version's VJP backward (``kernels.autograd``).

``train_loss(params, batch) -> (loss, metrics)`` is next-token cross
entropy in f32 (:func:`_xent`, the last position masked), plus ``0.01 *
aux`` for an MoE, whose load-balancing losses the LM backbone sums;
``prefill_logits`` ignores them.  The vision stub's patch positions carry
no loss.  Training applies ``cfg.remat`` to each layer as the reference's
``_remat`` does (:func:`_remat`: ``torch.utils.checkpoint``, non-reentrant);
serving runs no checkpoint.  ``shardctx.constrain_batch`` is called at
the JAX package's two block boundaries; on one card it returns its input.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ..configs.base import ArchConfig
from . import attention as A
from . import moe as M
from . import ssm as S
from . import xlstm as X
from .layers import (
    ParamSpec, embed_tokens, embedding_specs, gated_mlp, gated_mlp_specs,
    layer, rms_norm,
)
from .shardctx import constrain_batch


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


#: the matrix products whose outputs ``remat="dots"`` keeps (JAX's
#: ``checkpoint_dots_with_no_batch_dims``: a batched product is recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, mode: str) -> Callable:
    """Activation checkpointing of one layer: ``"full"`` keeps the
    layer's inputs and recomputes the rest in the backward, ``"dots"``
    also keeps the outputs of 2-D matrix products, ``"none"`` returns
    ``fn``.  No value changes."""
    if mode == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if mode == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=ctx)
    return fn


def _xent(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
          ) -> torch.Tensor:
    """Mean next-token cross entropy over ``mask``: logsumexp and the gold
    logit in f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def _next_token_loss(logits: torch.Tensor, tokens: torch.Tensor
                     ) -> torch.Tensor:
    """:func:`_xent` of ``logits`` ``(B, T, V)`` against ``tokens``
    shifted by one, the last position padded and masked."""
    labels = F.pad(tokens[:, 1:], (0, 1))
    mask = F.pad(torch.ones(tokens[:, 1:].shape, dtype=torch.float32,
                            device=tokens.device), (0, 1))
    return _xent(logits, labels, mask)


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family == "audio" or cfg.is_encdec:
        return _build_encdec(cfg)
    if cfg.family == "hybrid":
        return _build_hybrid(cfg)
    if cfg.family == "ssm":
        return _build_xlstm(cfg)
    return _build_lm(cfg)


def _pos(batch) -> int:
    return int(batch["pos"])


def _head_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,vd->...v")``."""
    return x @ head.T


# ------------------------------------------------------------------ LM ----

def _block_specs(cfg: ArchConfig) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        "ln_attn": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "attn": A.attn_specs(cfg),
        "ln_ffn": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
    }
    if cfg.moe:
        specs["moe"] = M.moe_specs(cfg)
    else:
        specs["mlp"] = gated_mlp_specs(cfg.d_model, cfg.d_ff)
    return specs


def _ffn(params, h, cfg: ArchConfig
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN: the MoE with its aux loss, or the gated MLP with
    none (``None``: serving adds no operation for it)."""
    if cfg.moe:
        return M.moe_ffn(params["moe"], h, cfg)
    return gated_mlp(params["mlp"], h, cfg.ffn_act), None


def _block_apply(params, x, cfg: ArchConfig, window: Optional[int]):
    """``(x, aux or None)`` after one block."""
    x = constrain_batch(x)
    h = rms_norm(x, params["ln_attn"], cfg.norm_eps)
    x = x + A.mha_train(params["attn"], h, cfg, window=window)
    x = constrain_batch(x)
    h = rms_norm(x, params["ln_ffn"], cfg.norm_eps)
    y, aux = _ffn(params, h, cfg)
    return x + y, aux


def _block_decode(params, x, k, v, pos: int, cfg: ArchConfig,
                  window: Optional[int], ring: bool = False):
    h = rms_norm(x, params["ln_attn"], cfg.norm_eps)
    y, k, v = A.mha_decode(params["attn"], h, k, v, pos, cfg, window=window,
                           ring=ring)
    x = x + y
    h = rms_norm(x, params["ln_ffn"], cfg.norm_eps)
    return x + _ffn(params, h, cfg)[0]


def _lm_specs(cfg: ArchConfig) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        "embed": embedding_specs(cfg.padded_vocab, cfg.d_model),
        "ln_f": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
    }
    ratio = cfg.local_global_ratio
    if ratio > 0:
        n_groups = cfg.n_layers // (ratio + 1)
        specs["local"] = _stack_specs(_stack_specs(_block_specs(cfg), ratio),
                                      n_groups)
        specs["global"] = _stack_specs(_block_specs(cfg), n_groups)
    else:
        specs["layers"] = _stack_specs(_block_specs(cfg), cfg.n_layers)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec(
            (cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), scale=1.0
        )
    return specs


def _gemma_scale(x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """gemma's embedding scale, in x's type."""
    if cfg.name.startswith("gemma"):
        return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                                device=x.device)
    return x


def _lm_embed_inputs(params, batch, cfg: ArchConfig) -> torch.Tensor:
    x = embed_tokens(params["embed"], batch["tokens"])
    if cfg.frontend == "vision":
        # stub frontend: precomputed patch embeddings prepended to the text
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return _gemma_scale(x, cfg)


def _lm_backbone(params, x, cfg: ArchConfig, remat: str = "none"):
    """``(normed x, the MoE's aux losses summed in f32, in the
    reference's order, or None without an MoE)``; each block checkpointed
    as ``remat`` says."""
    ratio = cfg.local_global_ratio
    local = _remat(lambda lp, xx: _block_apply(lp, xx, cfg,
                                               cfg.sliding_window), remat)
    glob = _remat(lambda lp, xx: _block_apply(lp, xx, cfg, None), remat)
    if ratio > 0:
        blocks = [(local, ("local", g, j)) if j < ratio
                  else (glob, ("global", g))
                  for g in range(cfg.n_layers // (ratio + 1))
                  for j in range(ratio + 1)]
    else:
        blocks = [(local, ("layers", i)) for i in range(cfg.n_layers)]
    aux = None
    for fn, (name, *idx) in blocks:
        x, a = fn(layer(params[name], *idx), x)
        if a is not None:
            aux = a if aux is None else aux + a
    return rms_norm(x, params["ln_f"], cfg.norm_eps), aux


def _build_lm(cfg: ArchConfig) -> Model:
    specs = _lm_specs(cfg)
    ratio = cfg.local_global_ratio

    def head(params):
        return params.get("lm_head", params["embed"]["table"])

    def train_loss(params, batch):
        x, aux = _lm_backbone(params, _lm_embed_inputs(params, batch, cfg),
                              cfg, cfg.remat)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        tokens = batch["tokens"]
        pre = x.shape[1] - tokens.shape[1]  # frontend positions carry no loss
        loss = _next_token_loss(_head_logits(x[:, pre:], head(params)),
                                tokens) + 0.01 * aux
        return loss, {"loss": loss, "aux": aux}

    def prefill_logits(params, batch):
        x, _ = _lm_backbone(params, _lm_embed_inputs(params, batch, cfg), cfg)
        return _head_logits(x[:, -1:], head(params))

    def cache_specs(batch: int, seq: int):
        if ratio > 0:
            g = cfg.n_layers // (ratio + 1)
            w = min(cfg.sliding_window or seq, seq)
            return {
                "local": A.kv_cache_specs(cfg, batch, w, n_layers=g * ratio),
                "global": A.kv_cache_specs(cfg, batch, seq, n_layers=g),
            }
        return A.kv_cache_specs(cfg, batch, seq)

    def serve_step(params, cache, batch):
        pos = _pos(batch)
        x = _gemma_scale(embed_tokens(params["embed"], batch["token"]), cfg)
        if ratio > 0:
            # ring-buffer local caches: write slot pos % window, RoPE at the
            # absolute position (mha_decode's ring semantics)
            lk, lv = cache["local"]["k"], cache["local"]["v"]
            gk, gv = cache["global"]["k"], cache["global"]["v"]
            for g in range(cfg.n_layers // (ratio + 1)):
                for j in range(ratio):
                    i = g * ratio + j
                    x = _block_decode(layer(params["local"], g, j), x, lk[i],
                                      lv[i], pos, cfg, None, ring=True)
                x = _block_decode(layer(params["global"], g), x, gk[g], gv[g],
                                  pos, cfg, None)
        else:
            for i in range(cfg.n_layers):
                x = _block_decode(layer(params["layers"], i), x, cache["k"][i],
                                  cache["v"][i], pos, cfg, cfg.sliding_window)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return _head_logits(x, head(params)), cache

    return Model(cfg, specs, train_loss, prefill_logits, serve_step,
                 cache_specs)


# ------------------------------------------------------- encoder-decoder ---

#: encoder frames of the serving cache (the stub frontend's length)
ENC_FRAMES = 4096


def _build_encdec(cfg: ArchConfig) -> Model:
    enc_block = {
        "ln_attn": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "attn": A.attn_specs(cfg),
        "ln_ffn": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "mlp": gated_mlp_specs(cfg.d_model, cfg.d_ff),
    }
    dec_block = {
        **enc_block,
        "ln_cross": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "cross": A.attn_specs(cfg),
    }
    specs = {
        "embed": embedding_specs(cfg.padded_vocab, cfg.d_model),
        "encoder": _stack_specs(enc_block, cfg.encoder_layers),
        "decoder": _stack_specs(dec_block, cfg.n_layers),
        "ln_enc": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "ln_f": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
    }

    def enc_layer(x, lp):
        h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        x = x + A.mha_train(lp["attn"], h, cfg, causal=False)
        h = rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
        return x + gated_mlp(lp["mlp"], h, cfg.ffn_act)

    def dec_layer(x, lp, enc):
        h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        x = x + A.mha_train(lp["attn"], h, cfg, causal=True)
        h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        x = x + A.mha_train(lp["cross"], h, cfg, kv_src=enc, causal=False)
        h = rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
        return x + gated_mlp(lp["mlp"], h, cfg.ffn_act)

    def encode(params, src, remat: str = "none"):
        fn = _remat(enc_layer, remat)
        x = src
        for i in range(cfg.encoder_layers):
            x = fn(x, layer(params["encoder"], i))
        return rms_norm(x, params["ln_enc"], cfg.norm_eps)

    def decode_train(params, x, enc, remat: str = "none"):
        fn = _remat(dec_layer, remat)
        for i in range(cfg.n_layers):
            x = fn(x, layer(params["decoder"], i), enc)
        return rms_norm(x, params["ln_f"], cfg.norm_eps)

    def train_loss(params, batch):
        table = params["embed"]["table"]
        enc = encode(params, batch["src_embeds"].to(table.dtype), cfg.remat)
        tgt = batch["tgt_tokens"]
        x = decode_train(params, embed_tokens(params["embed"], tgt), enc,
                         cfg.remat)
        loss = _next_token_loss(_head_logits(x, table), tgt)
        return loss, {"loss": loss}

    def prefill_logits(params, batch):
        table = params["embed"]["table"]
        enc = encode(params, batch["src_embeds"].to(table.dtype))
        x = decode_train(params, embed_tokens(params["embed"],
                                              batch["tgt_tokens"]), enc)
        return _head_logits(x[:, -1:], table)

    def cache_specs(batch: int, seq: int):
        return {
            "self": A.kv_cache_specs(cfg, batch, seq),
            "cross": A.kv_cache_specs(cfg, batch, ENC_FRAMES),
            "enc_done": A.TensorSpec((), torch.int32),
        }

    def serve_step(params, cache, batch):
        pos = _pos(batch)
        x = embed_tokens(params["embed"], batch["token"])
        sk, sv = cache["self"]["k"], cache["self"]["v"]
        ck, cv = cache["cross"]["k"], cache["cross"]["v"]
        for i in range(cfg.n_layers):
            x = _block_decode_encdec(layer(params["decoder"], i), x, sk[i],
                                     sv[i], ck[i], cv[i], pos, cfg)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return _head_logits(x, params["embed"]["table"]), cache

    model = Model(cfg, specs, train_loss, prefill_logits, serve_step,
                  cache_specs)
    model.encode = encode
    return model


def encdec_cross_kv(params, enc: torch.Tensor, cfg: ArchConfig):
    """The decoder's cross K/V of every layer from the encoder's output
    ``enc`` ``(B, S, d)`` (``Model.encode``): ``(k, v)``, each ``(L, B, S,
    Hk, Dh)``, what ``serve_step`` reads from ``cache["cross"]`` (no
    RoPE, as ``mha_train(kv_src=...)`` projects them)."""
    ks, vs = [], []
    for i in range(cfg.n_layers):
        _, k, v = A._project_qkv(layer(params["decoder"], i)["cross"], enc,
                                 enc, cfg)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def _block_decode_encdec(p, x, k, v, ck, cv, pos: int, cfg: ArchConfig):
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    y, _, _ = A.mha_decode(p["attn"], h, k, v, pos, cfg)
    x = x + y
    # cross-attention against the precomputed encoder K/V (no cache update)
    h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
    b = x.shape[0]
    dh = cfg.head_dim_
    q = (h @ p["cross"]["wq"]).reshape(b, 1, cfg.n_heads, dh)
    kf = A._expand_kv(ck, cfg.n_heads).float()
    vf = A._expand_kv(cv, cfg.n_heads).float()
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), kf) * dh ** -0.5
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs, vf)
    out = out.to(x.dtype).reshape(b, 1, cfg.n_heads * dh)
    x = x + out @ p["cross"]["wo"]
    h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    return x + gated_mlp(p["mlp"], h, cfg.ffn_act)


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

    def hybrid_layer(x, lp, shared, emb, use_attn: bool):
        x = x + S.mamba2_block(lp, x, cfg)
        if use_attn:
            x = _shared_attn_apply(shared, x, emb, cfg)
        return x

    def backbone(params, x, remat: str = "none"):
        fn = _remat(hybrid_layer, remat)
        emb = x
        for i in range(cfg.n_layers):
            x = fn(x, layer(params["mamba"], i), params["shared_attn"], emb,
                   i % every == every - 1)
        return rms_norm(x, params["ln_f"], cfg.norm_eps)

    def train_loss(params, batch):
        tokens = batch["tokens"]
        x = backbone(params, embed_tokens(params["embed"], tokens), cfg.remat)
        loss = _next_token_loss(_head_logits(x, params["embed"]["table"]),
                                tokens)
        return loss, {"loss": loss}

    def prefill_logits(params, batch):
        x = backbone(params, embed_tokens(params["embed"], batch["tokens"]))
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

    return Model(cfg, specs, train_loss, prefill_logits, serve_step,
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

    def mlayer(x, lp):
        return x + X.mlstm_block(lp["m"], rms_norm(x, lp["ln"], cfg.norm_eps),
                                 cfg)

    def backbone(params, x, remat: str = "none"):
        mfn = _remat(mlayer, remat)        # the reference remats the mLSTMs
        for g in range(n_groups):
            for j in range(n_m):
                x = mfn(x, layer(params["mlstm"], g, j))
            sp = layer(params["slstm"], g)
            h = rms_norm(x, sp["ln"], cfg.norm_eps)
            x = x + X.slstm_block(sp["s"], h, cfg)
        return rms_norm(x, params["ln_f"], cfg.norm_eps)

    def train_loss(params, batch):
        tokens = batch["tokens"]
        x = backbone(params, embed_tokens(params["embed"], tokens), cfg.remat)
        loss = _next_token_loss(_head_logits(x, params["embed"]["table"]),
                                tokens)
        return loss, {"loss": loss}

    def prefill_logits(params, batch):
        x = backbone(params, embed_tokens(params["embed"], batch["tokens"]))
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

    return Model(cfg, specs, train_loss, prefill_logits, serve_step,
                 cache_specs)
