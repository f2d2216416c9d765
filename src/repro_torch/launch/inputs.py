"""Meta stand-ins and spec trees for every (arch x shape) cell (port of
``repro.launch.inputs``).

``input_specs`` builds a cell's batch as ``meta`` tensors (shapes and
dtypes, no storage: the JAX ``ShapeDtypeStruct``\\ s); ``cell_shardings``
builds the (params, batch, cache?) spec trees a mesh's rules give, each
spec a tuple of mesh axis names or ``None`` per dimension
(``configs.base.logical_to_spec``).  Nothing here allocates device memory.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig, ShapeConfig, mesh_rules
from ..models.layers import param_shardings, tree_paths, unflatten

ENC_SRC_LEN = 4096  # serving-time encoder length for the enc-dec arch


def _axis(a):
    """A spec entry as a JAX ``PartitionSpec`` stores it: a one-name tuple
    is the name."""
    return a[0] if isinstance(a, tuple) and len(a) == 1 else a


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Abstract model inputs for one cell (a batch dict of meta tensors)."""
    B, T = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            p = cfg.frontend_tokens
            return {"tokens": _meta((B, T - p), i32),
                    "patch_embeds": _meta((B, p, cfg.d_model),
                                          torch.bfloat16)}
        if cfg.is_encdec:
            return {"src_embeds": _meta((B, T, cfg.d_model), torch.bfloat16),
                    "tgt_tokens": _meta((B, T), i32)}
        return {"tokens": _meta((B, T), i32)}
    # decode: one new token against a cache of length T
    return {"token": _meta((B, 1), i32), "pos": _meta((), i32)}


def batch_shardings(cfg: ArchConfig, shape: ShapeConfig, rules) -> Dict[str, Any]:
    dp = _axis(rules["batch"])
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            return {"tokens": (dp,), "patch_embeds": (dp,)}
        if cfg.is_encdec:
            return {"src_embeds": (dp,), "tgt_tokens": (dp,)}
        return {"tokens": (dp,)}
    return {"token": (dp,), "pos": ()}


def cache_shardings(cfg: ArchConfig, shape: ShapeConfig, rules,
                    cache_tree) -> Any:
    """Specs for the serve cache tree, matched by leaf name and rank."""
    dp = _axis(rules["batch"])
    kvs = _axis(rules["kv_seq"])

    def spec_for(name: str, nd: int) -> Tuple:
        if name in ("k", "v", "attn_k", "attn_v"):
            if nd == 5:
                return (None, dp, kvs, None, None)
            return (dp, kvs, None, None)
        if name == "mamba_h":            # (L, B, H, P, N)
            return (None, dp, "model", None, None)
        if name == "mamba_conv":         # (L, B, K-1, C)
            return (None, dp, None, "model")
        if name in ("mC",):              # (G, nm, B, H, K, K)
            return (None, None, dp, None, "model", None)
        if name in ("mN",):              # (G, nm, B, H, K)
            return (None, None, dp, None, "model")
        if name in ("sc", "sn", "sh", "sm"):  # (G, B, H, dh)
            return (None, dp, None, None)
        return (None,) * nd

    return unflatten({path: spec_for(path.rsplit("/", 1)[-1],
                                     len(leaf.shape))
                      for path, leaf in tree_paths(cache_tree).items()})


def cell_mode(cfg: ArchConfig, shape: ShapeConfig) -> str:
    if shape.kind == "decode":
        return "decode_long" if shape.global_batch == 1 else "decode"
    return "train"


def cell_shardings(cfg: ArchConfig, shape: ShapeConfig, model, mesh,
                   cache_tree: Optional[Any] = None):
    """(param_specs, batch_specs, cache_specs?) spec trees."""
    rules = mesh_rules(cell_mode(cfg, shape), mesh.axis_names)
    p_specs = param_shardings(model.param_specs, rules, mesh=mesh)
    b_specs = batch_shardings(cfg, shape, rules)
    c_specs = (cache_shardings(cfg, shape, rules, cache_tree)
               if cache_tree is not None else None)
    return p_specs, b_specs, c_specs
