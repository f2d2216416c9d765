"""Mixture-of-Experts FFN with sorted capacity dispatch (port of
``repro.models.moe``).

Two implementations of one parameter layout:

* ``sorted`` (the default): per batch row, the T * k (token, expert)
  assignments are sorted by expert with a **stable** sort, each expert
  keeps the first ``cap`` of them (``cap = max(8, ceil(T k / E * cf))``
  rounded up to 8), the rest drop Switch-style (they contribute zero),
  the kept tokens run as ``(B, E, cap, d)`` grouped products and come back
  by a scatter-add weighted by their gates;
* ``dense``: every expert on every token, combined with the routing
  weights (E times the work; the oracle of the tests).

The expert and router products are ``torch.matmul`` / ``einsum``, as the
JAX package computes them with ``jnp.einsum`` outside any Pallas kernel.
The reference's ``_constrain_experts`` pins the expert axis to a mesh
axis (a sharding constraint); the port calls ``shardctx.constrain_experts``
at the same two places, which on one card returns its input (the dry
run's counter reads each as an all-to-all over "model").
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import ParamSpec
from .shardctx import constrain_experts


def moe_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), ("embed", "experts")),
        "w_gate": ParamSpec((e, d, ff), ("experts", "embed", "mlp")),
        "w_up": ParamSpec((e, d, ff), ("experts", "embed", "mlp")),
        "w_down": ParamSpec((e, ff, d), ("experts", "mlp", "embed")),
    }


def _route(params: Mapping[str, torch.Tensor], x: torch.Tensor,
           cfg: ArchConfig):
    """``(gates (S, k) f32, expert ids (S, k), probs (S, E) f32)``: the
    top-k of the router's softmax in f32 (ties to the lower expert id, as
    ``lax.top_k``), the gates renormalised to sum to one."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    idx = order[:, :cfg.top_k]
    gates = probs.gather(1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _one_hot(idx: torch.Tensor, e: int) -> torch.Tensor:
    """``F.one_hot(idx, e)`` in f32 as a comparison, the same operators on
    every device (``F.one_hot`` checks its range on the host on the CPU
    and decomposes differently on the meta device)."""
    return (idx[..., None] == torch.arange(e, device=idx.device)).float()


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, e: int, k: int
              ) -> torch.Tensor:
    """Switch's load-balancing loss ``E * sum(mean prob * mean load)``."""
    me = probs.mean(dim=0)
    ce = _one_hot(idx, e).sum(1).mean(dim=0) / k
    return e * torch.sum(me * ce)


def _expert_ffn(params, xe: torch.Tensor, act: str) -> torch.Tensor:
    """``(B, E, cap, d)`` through each expert's gated MLP."""
    h_gate = torch.einsum("becd,edf->becf", xe, params["w_gate"])
    h_up = torch.einsum("becd,edf->becf", xe, params["w_up"])
    if act == "geglu":
        h = F.gelu(h_gate, approximate="tanh") * h_up
    else:
        h = F.silu(h_gate) * h_up
    return torch.einsum("becf,efd->becd", h, params["w_down"])


def capacity(T: int, cfg: ArchConfig) -> int:
    """Slots of each expert for a row of ``T`` tokens."""
    cap = int(math.ceil(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, ((cap + 7) // 8) * 8)


def moe_ffn_sorted(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                   cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` ``(B, T, d)`` (or ``(..., d)``: the leading dims are rows) ->
    ``(y in x's dtype, aux loss f32)``.  Dispatch per batch row; the
    assignments past an expert's capacity drop."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xr = x.reshape(-1, orig_shape[-2], d) if x.dim() > 2 else x[None]
    B, T, _ = xr.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(T, cfg)
    gates, idx, probs = _route(params, xr.reshape(-1, d), cfg)
    aux = _aux_loss(probs, idx, e, k)
    flat_e = idx.reshape(B, T * k)
    flat_g = gates.reshape(B, T * k)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    order = torch.sort(flat_e, dim=1, stable=True)[1]
    se = flat_e.gather(1, order)                             # (B, T k)
    st = flat_t[order]
    sg = flat_g.gather(1, order)
    counts = torch.zeros((B, e), dtype=se.dtype, device=x.device)
    counts.scatter_add_(1, se, torch.ones_like(se))          # (B, E)
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(T * k, device=x.device) - starts.gather(1, se)
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, torch.full_like(se, e * cap))
    rows = torch.arange(B, device=x.device)[:, None]
    xd = torch.zeros((B, e * cap + 1, d), dtype=xr.dtype, device=x.device)
    xd[rows, slot] = xr[rows, st] * keep[..., None].to(xr.dtype)
    xe = constrain_experts(xd[:, :e * cap].reshape(B, e, cap, d))
    ye = constrain_experts(_expert_ffn(params, xe, cfg.ffn_act))
    y_slots = torch.cat([ye.reshape(B, e * cap, d),
                         torch.zeros((B, 1, d), dtype=ye.dtype,
                                     device=x.device)], dim=1)
    y_tok = y_slots[rows, slot] * (sg * keep).to(ye.dtype)[..., None]
    y = torch.zeros((B, T, d), dtype=ye.dtype, device=x.device)
    y.index_put_((rows.expand(B, T * k), st.expand(B, T * k)), y_tok,
                 accumulate=True)
    return y.reshape(orig_shape).to(x.dtype), aux.float()


def moe_ffn_dense(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                  cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The oracle: every expert on every token, combined with the gates."""
    orig_shape = x.shape
    xf = x.reshape(-1, orig_shape[-1])
    e = cfg.n_experts
    gates, idx, probs = _route(params, xf, cfg)
    combine = torch.zeros((xf.shape[0], e), dtype=torch.float32,
                          device=x.device)
    for j in range(cfg.top_k):
        combine = combine + _one_hot(idx[:, j], e) * gates[:, j:j + 1]
    ye = _expert_ffn(params, xf[None, None].expand(1, e, -1, -1),
                     cfg.ffn_act)[0]                          # (E, S, d)
    y = torch.einsum("esd,se->sd", ye.float(), combine)
    aux = _aux_loss(probs, idx, e, cfg.top_k)
    return y.reshape(orig_shape).to(x.dtype), aux.float()


def moe_ffn(params, x, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe_impl == "dense":
        return moe_ffn_dense(params, x, cfg)
    return moe_ffn_sorted(params, x, cfg)
