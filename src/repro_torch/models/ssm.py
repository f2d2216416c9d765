"""Mamba2 (SSD) blocks (port of ``repro.models.ssm``).

``mamba2_block`` runs its chunked selective scan through
:func:`repro_torch.kernels.ops.mamba2_scan`: on a CUDA tensor the
hand-written kernel (``kernels/csrc/mamba2_scan.cu``), on a CPU tensor its
plain version, :func:`ssd_chunked` (the JAX function's formulation,
re-exported here from :mod:`repro_torch.kernels.ref`).  The JAX package
computes the scan with its jnp ``ssd_chunked`` and never calls its Pallas
kernel; the port calls its kernel here.

State convention: h has shape (B, H, dh, N) with N = ssm_state; scalar
per-head decay a_t = exp(dt_t * A) (A < 0), input B_t/C_t shared across
heads (ngroups=1, as in Mamba2 / Zamba2).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops
from ..kernels.ref import ssd_chunked
from .layers import ParamSpec

__all__ = ["mamba2_specs", "mamba2_block", "mamba2_decode_step",
           "ssd_chunked"]


def mamba2_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    return {
        # z (gate), x, B, C, dt  in one fused projection
        "in_proj": ParamSpec((d, 2 * di + 2 * n + nh), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.ssm_conv, di + 2 * n), ("conv", "mlp"), scale=0.5),
        "A_log": ParamSpec((nh,), ("state",), init="zeros"),
        "D": ParamSpec((nh,), ("state",), init="ones"),
        "dt_bias": ParamSpec((nh,), ("state",), init="zeros"),
        "norm_w": ParamSpec((di,), ("mlp",), init="zeros"),
        "out_proj": ParamSpec((di, d), ("mlp", "embed")),
    }


def _split_proj(proj: torch.Tensor, cfg: ArchConfig):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    z, xs, b, c, dt = torch.split(proj, [di, di, n, n, nh], dim=-1)
    return z, xs, b, c, dt, di, n, nh


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C); w: (K, C) depthwise causal conv."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):  # tiny static K (4)
        out = out + xp[:, i: i + x.shape[1], :] * w[i]
    return out


def _gated_norm_out(params, y, z, x, cfg: ArchConfig) -> torch.Tensor:
    """Gated RMSNorm (Mamba2) and the output projection."""
    yf = y.float() * F.silu(z.float())
    var = yf.square().mean(dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + cfg.norm_eps) * (1.0 + params["norm_w"])
    return yf.to(x.dtype) @ params["out_proj"]


def mamba2_block(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,                    # (B, T, d)
    cfg: ArchConfig,
) -> torch.Tensor:
    proj = x @ params["in_proj"]
    z, xs, b, c, dt, di, n, nh = _split_proj(proj, cfg)
    conv_in = torch.cat([xs, b, c], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"]))
    xs, b, c = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt + params["dt_bias"])             # (B,T,H)
    A = -torch.exp(params["A_log"].float())             # (H,) negative
    a = torch.exp(dt * A)                               # per-step decay
    xh = xs.reshape(*xs.shape[:-1], nh, cfg.ssm_head_dim)
    xh = xh * dt[..., None]                             # dt-scaled input
    y = ops.mamba2_scan(xh.contiguous(), a.contiguous(), b.contiguous(),
                        c.contiguous())
    y = y + xh * params["D"][:, None]
    y = y.reshape(*x.shape[:-1], di)
    return _gated_norm_out(params, y, z, x, cfg)


def mamba2_decode_step(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,                    # (B, 1, d)
    state: torch.Tensor,                # (B, H, P, N)
    conv_state: torch.Tensor,           # (B, K-1, di+2N)
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrent step: O(1) in context length.  Returns new
    state tensors (nothing is written in place)."""
    proj = x @ params["in_proj"]
    z, xs, b, c, dt, di, n, nh = _split_proj(proj, cfg)
    conv_in = torch.cat([xs, b, c], dim=-1)             # (B,1,C)
    window = torch.cat([conv_state.to(conv_in.dtype), conv_in], dim=1)
    conv_out = F.silu(
        torch.einsum("bkc,kc->bc", window, params["conv_w"]))[:, None, :]
    new_conv_state = window[:, 1:].to(conv_state.dtype)
    xs, b, c = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())
    a = torch.exp(dt * A)                               # (B,1,H)
    xh = xs.reshape(*xs.shape[:-1], nh, cfg.ssm_head_dim) * dt[..., None]
    # h = a h + B x^T ; y = C . h
    h = state * a[:, 0, :, None, None] + torch.einsum(
        "bk,bhp->bhpk", b[:, 0].float(), xh[:, 0].float())
    y = torch.einsum("bk,bhpk->bhp", c[:, 0].float(), h)
    y = y[:, None] + xh * params["D"][:, None]
    y = y.reshape(*x.shape[:-1], di)
    return _gated_norm_out(params, y, z, x, cfg), h, new_conv_state
