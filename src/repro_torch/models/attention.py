"""Grouped-query attention: prefill (``blocked_attention`` through the
flash-attention kernel) and decode against a contiguous KV cache (port of
``repro.models.attention``).

``blocked_attention`` keeps the JAX package's name and signature and hands
the work to :func:`repro_torch.kernels.ops.flash_attention`, which takes
GQA K/V as given: on a CUDA tensor the hand-written kernel
(``kernels/csrc/flash_attention.cu``), on a CPU tensor its plain version,
the JAX function's own query-block formulation.  The JAX package computes
this function with its jnp path and never calls its Pallas kernel; the
port calls its kernel here.

``mha_decode`` is plain PyTorch, as it is jnp in the reference.  It writes
the new token's K/V into the cache tensors **in place** and returns them;
the reference returns updated copies.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from .layers import ParamSpec, apply_rope

NEG_INF = -1e30


class TensorSpec(NamedTuple):
    """Shape and dtype of a cache leaf (the JAX ``ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def attn_specs(cfg: ArchConfig, cross: bool = False) -> Dict[str, ParamSpec]:
    d, dh = cfg.d_model, cfg.head_dim_
    h, hk = cfg.n_heads, cfg.n_kv_heads
    specs = {
        "wq": ParamSpec((d, h * dh), ("embed", "q_dim")),
        "wk": ParamSpec((d, hk * dh), ("embed", "q_dim")),
        "wv": ParamSpec((d, hk * dh), ("embed", "q_dim")),
        "wo": ParamSpec((h * dh, d), ("q_dim", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h * dh,), ("q_dim",), init="zeros")
        specs["bk"] = ParamSpec((hk * dh,), ("q_dim",), init="zeros")
        specs["bv"] = ParamSpec((hk * dh,), ("q_dim",), init="zeros")
    return specs


def _project_qkv(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    kv_src: torch.Tensor,
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dh = cfg.head_dim_
    q = x @ params["wq"]
    k = kv_src @ params["wk"]
    v = kv_src @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(*q.shape[:-1], cfg.n_heads, dh)
    k = k.reshape(*k.shape[:-1], cfg.n_kv_heads, dh)
    v = v.reshape(*v.shape[:-1], cfg.n_kv_heads, dh)
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hk, Dh) -> (B, S, H, Dh) by GQA group broadcast."""
    hk = k.shape[-2]
    if hk == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // hk, dim=-2)


def blocked_attention(
    q: torch.Tensor,            # (B, T, H, Dh)
    k: torch.Tensor,            # (B, S, Hk, Dh) — GQA heads, NOT expanded
    v: torch.Tensor,            # (B, S, Hk, Dh)
    causal: bool,
    window: Optional[int] = None,   # None = unbounded
    q_offset: int = 0,
    block: int = 512,
) -> torch.Tensor:
    """Causal / windowed attention with query ``t`` at position
    ``q_offset + t`` and key ``s`` at ``s``.  ``block`` is the query-block
    length of the plain version (the JAX function's scan); the kernel
    tiles on its own."""
    del block
    return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window, offset=q_offset)


def mha_train(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,                      # (B, T, d)
    cfg: ArchConfig,
    positions: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    causal: bool = True,
    kv_src: Optional[torch.Tensor] = None,  # cross-attention source
    rope: bool = True,
) -> torch.Tensor:
    b, t, _ = x.shape
    src = kv_src if kv_src is not None else x
    q, k, v = _project_qkv(params, x, src, cfg)
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    if rope and kv_src is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = blocked_attention(q, k, v, causal=causal and kv_src is None,
                            window=window)
    out = out.reshape(b, t, cfg.n_heads * cfg.head_dim_)
    return out @ params["wo"]


# ---------------------------------------------------------------------------
# decode path (one new token, contiguous KV cache)
# ---------------------------------------------------------------------------

def kv_cache_specs(
    cfg: ArchConfig, batch: int, max_len: int, n_layers: Optional[int] = None,
    dtype: torch.dtype = torch.bfloat16,
):
    """``{"k", "v"}`` as :class:`TensorSpec` (the JAX ``ShapeDtypeStruct``)
    of shape ``(L, batch, max_len, Hk, Dh)``."""
    L = n_layers if n_layers is not None else cfg.n_layers
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": TensorSpec(shape, dtype), "v": TensorSpec(shape, dtype)}


def mha_decode(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,                    # (B, 1, d) new token activations
    layer_k: torch.Tensor,              # (B, S, Hk, Dh)
    layer_v: torch.Tensor,
    pos: int,                           # absolute position of the new token
    cfg: ArchConfig,
    window: Optional[int] = None,
    ring: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against a contiguous cache; writes the new K/V at
    ``pos`` in place and returns ``(y, layer_k, layer_v)``.

    With ``ring=True`` the cache holds only the last S positions (the 5:1
    pattern's local layers): the write slot is ``pos % S`` and the slots
    below ``min(pos + 1, S)`` are valid.  RoPE is applied at the absolute
    position when K is written, so reads need no re-rotation."""
    b = x.shape[0]
    dh = cfg.head_dim_
    hk = cfg.n_kv_heads
    g = cfg.n_heads // hk
    q, k_new, v_new = _project_qkv(params, x, x, cfg)
    positions = torch.full((b, 1), pos, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    s = layer_k.shape[1]
    slot = pos % s if ring else pos
    layer_k[:, slot] = k_new[:, 0].to(layer_k.dtype)
    layer_v[:, slot] = v_new[:, 0].to(layer_v.dtype)
    kpos = torch.arange(s, device=x.device)
    if ring:
        valid = kpos < min(pos + 1, s)
    else:
        valid = kpos <= pos
        if window is not None:
            valid &= (pos - kpos) < window
    # grouped GQA: never expand KV heads
    qg = q.reshape(b, hk, g, dh).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, layer_k.float()) * dh ** -0.5
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, layer_v.float())
    out = out.to(x.dtype).reshape(b, 1, cfg.n_heads * dh)
    return out @ params["wo"], layer_k, layer_v
