"""xLSTM blocks: chunkwise-parallel mLSTM + sequential sLSTM (port of
``repro.models.xlstm``; arXiv:2405.04517).

``mlstm_block`` runs its chunked gated linear attention through
:func:`repro_torch.kernels.ops.mlstm_chunked`: on a CUDA tensor the
hand-written kernel (``kernels/csrc/mlstm.cu``), on a CPU tensor its plain
version, :func:`gla_chunked` (the JAX function's formulation, re-exported
here from :mod:`repro_torch.kernels.ref`).  The JAX package computes it
with its jnp ``gla_chunked`` and never calls its Pallas kernel; the port
calls its kernel here.

sLSTM has a true sequential dependency through its block-diagonal
recurrent weights: ``slstm_block`` is a Python loop over time, as the
reference's is a ``lax.scan``.  Both carry O(1) state for decode.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops
from ..kernels.ref import gla_chunked
from .layers import ParamSpec

__all__ = ["gla_chunked", "mlstm_specs", "mlstm_block", "mlstm_decode_step",
           "slstm_specs", "slstm_block", "slstm_decode_step"]


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def mlstm_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    di = 2 * d  # proj factor 2
    h = cfg.n_heads
    return {
        "w_up": ParamSpec((d, 2 * di), ("embed", "mlp")),
        "wq": ParamSpec((di, di), ("mlp", "q_dim")),
        "wk": ParamSpec((di, di), ("mlp", "q_dim")),
        "wv": ParamSpec((di, di), ("mlp", "q_dim")),
        "w_if": ParamSpec((di, 2 * h), ("mlp", None), init="zeros"),
        "b_if": ParamSpec((2 * h,), (None,), init="zeros"),
        "w_down": ParamSpec((di, d), ("mlp", "embed")),
    }


def _mlstm_inputs(params, x, cfg: ArchConfig):
    """q, k, v ``(B, T, H, di/H)``, the forget decay ``a`` and the input
    gate ``i`` (``(B, T, H)`` f32) and the output gate's ``z``."""
    b, t, d = x.shape
    h = cfg.n_heads
    di = 2 * d
    up = x @ params["w_up"]
    xi, z = up.chunk(2, dim=-1)
    q = (xi @ params["wq"]).reshape(b, t, h, di // h)
    k = (xi @ params["wk"]).reshape(b, t, h, di // h)
    v = (xi @ params["wv"]).reshape(b, t, h, di // h)
    gates = xi @ params["w_if"] + params["b_if"]
    ig, fg = gates.chunk(2, dim=-1)                     # (B,T,H) each
    a = torch.sigmoid(fg.float())                       # forget in (0,1)
    i = torch.exp(torch.clamp(ig.float(), -10.0, 10.0))
    return q, k, v, a, i, z


def mlstm_block(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    b, t, d = x.shape
    q, k, v, a, i, z = _mlstm_inputs(params, x, cfg)
    y = ops.mlstm_chunked(q, k, v, a.contiguous(), i.contiguous())
    y = y.reshape(b, t, 2 * d) * F.silu(z)
    return y @ params["w_down"]


def mlstm_decode_step(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,                        # (B,1,d)
    C: torch.Tensor, n: torch.Tensor,       # (B,H,K,P), (B,H,K)
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, _, d = x.shape
    di = 2 * d
    q, k, v, a, i, z = _mlstm_inputs(params, x, cfg)
    q, k, v, a, i = q[:, 0], k[:, 0], v[:, 0], a[:, 0], i[:, 0]
    C = C * a[:, :, None, None] + i[:, :, None, None] * torch.einsum(
        "bhk,bhp->bhkp", k.float(), v.float())
    n = n * a[:, :, None] + i[:, :, None] * k.float()
    qs = q.float() * ((di // cfg.n_heads) ** -0.5)
    num = torch.einsum("bhk,bhkp->bhp", qs, C)
    den = torch.clamp(torch.einsum("bhk,bhk->bh", qs, n).abs(), min=1.0)
    y = (num / den[..., None]).reshape(b, 1, di).to(x.dtype)
    y = y * F.silu(z)
    return y @ params["w_down"], C, n


# ---------------------------------------------------------------------------
# sLSTM block (sequential; block-diagonal recurrence per head)
# ---------------------------------------------------------------------------

def slstm_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    ff = ((4 * d // 3) + 127) // 128 * 128
    return {
        "w_in": ParamSpec((d, 4 * d), ("embed", "mlp")),      # z,i,f,o inputs
        "r": ParamSpec((4, h, dh, dh), (None, None, None, None), scale=0.1),
        "b": ParamSpec((4 * d,), (None,), init="zeros"),
        "ff_gate": ParamSpec((d, ff), ("embed", "mlp")),
        "ff_up": ParamSpec((d, ff), ("embed", "mlp")),
        "ff_down": ParamSpec((ff, d), ("mlp", "embed")),
    }


def _slstm_cell(params, xt, state, cfg: ArchConfig):
    """xt: (B, 4d) precomputed input proj; state: dict of (B,H,dh)."""
    h_heads = state["h"]
    b, H, dh = h_heads.shape
    # the four recurrent products at once: (4, B, H, dh)
    rec = torch.einsum("bhd,ghde->gbhe", h_heads, params["r"].to(h_heads.dtype))
    zi, ii, fi, oi = (xt + params["b"]).chunk(4, dim=-1)
    shape = (b, H, dh)
    z = torch.tanh(zi.reshape(shape).float() + rec[0])
    it = ii.reshape(shape).float() + rec[1]
    ft = fi.reshape(shape).float() + rec[2]
    o = torch.sigmoid(oi.reshape(shape).float() + rec[3])
    m = torch.maximum(ft + state["m"], it)                 # stabiliser
    i = torch.exp(it - m)
    f = torch.exp(ft + state["m"] - m)
    c = f * state["c"] + i * z
    n = f * state["n"] + i
    hh = o * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": hh, "m": m}


def _slstm_ffn(params, y: torch.Tensor) -> torch.Tensor:
    """Post-block gated FFN (proj factor 4/3, GeGLU)."""
    g = F.gelu(y @ params["ff_gate"], approximate="tanh")
    u = y @ params["ff_up"]
    return (g * u) @ params["ff_down"]


def slstm_block(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    b, t, d = x.shape
    H = cfg.n_heads
    dh = d // H
    xin = x @ params["w_in"]                               # (B,T,4d)
    f32 = dict(dtype=torch.float32, device=x.device)
    state = {
        "c": torch.zeros((b, H, dh), **f32),
        "n": torch.zeros((b, H, dh), **f32),
        "h": torch.zeros((b, H, dh), **f32),
        "m": torch.full((b, H, dh), -1e9, **f32),
    }
    hs = []
    for step in range(t):
        state = _slstm_cell(params, xin[:, step], state, cfg)
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).reshape(b, t, d).to(x.dtype)
    return _slstm_ffn(params, y)


def slstm_decode_step(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,                         # (B,1,d)
    state: Dict[str, torch.Tensor],
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b, _, d = x.shape
    xt = (x @ params["w_in"])[:, 0]
    new = _slstm_cell(params, xt, state, cfg)
    y = new["h"].reshape(b, 1, d).to(x.dtype)
    return _slstm_ffn(params, y), new
