"""Architecture / shape configuration system (copy of ``repro.configs.base``).

Every assigned architecture has a ``configs/<id>.py`` exporting ``CONFIG``
(exact published dimensions) and ``SMOKE_CONFIG`` (reduced same-family
config for CPU tests), held field by field equal to the JAX package's.
Input shapes come from the shared SHAPES registry.  Vocab sizes are padded
to a multiple of 256 (Megatron-style padding).

``mesh_rules`` and ``logical_to_spec`` are the JAX package's sharding
rules, copied for the dry run (``launch/dryrun.py``), which prices each
cell per card under the reference's pod and multi-pod meshes: a spec is a
tuple with one entry per dimension, each a mesh axis name, a tuple of
them, or ``None`` (the JAX ``PartitionSpec``'s entries).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

VOCAB_PAD = 256


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    # ---- attention pattern ----
    sliding_window: Optional[int] = None
    local_global_ratio: int = 0       # gemma3: 5 (5 local : 1 global)
    qkv_bias: bool = False
    # ---- ffn ----
    ffn_act: str = "swiglu"           # swiglu | geglu
    # ---- MoE ----
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ---- SSM / hybrid ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0               # zamba2: shared attn block cadence
    # ---- xLSTM ----
    xlstm_slstm_every: int = 0        # 1-in-N blocks are sLSTM
    # ---- encoder-decoder ----
    encoder_layers: int = 0
    # ---- frontend stub ----
    frontend: Optional[str] = None    # vision | audio
    frontend_tokens: int = 256        # patches / frames provided pre-embedded
    # ---- misc ----
    tie_embeddings: bool = True
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: str = "none"               # none | dots | full
    moe_impl: str = "sorted"          # sorted (production) | dense (oracle)
    note: str = ""

    # ------------------------------------------------------------- derived
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic serving path exists (SSM / hybrid / sliding-window)."""
        return (
            self.family in ("ssm", "hybrid")
            or (self.sliding_window is not None and self.local_global_ratio > 0)
        )

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, L = self.d_model, self.n_layers
        dh = self.head_dim_
        attn = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) + (self.n_heads * dh) * d
        if self.moe:
            ff = 3 * d * self.d_ff * self.n_experts
        elif self.d_ff > 0:
            mult = 3 if self.ffn_act in ("swiglu", "geglu") else 2
            ff = mult * d * self.d_ff
        else:
            ff = 0
        if self.family == "ssm":       # xLSTM-style blocks
            inner = 2 * d
            block = 2 * d * inner + inner * d + inner * 3  # projections+gates
            body = L * block
        elif self.family == "hybrid":  # mamba2 blocks + shared attn
            inner = self.ssm_expand * d
            mamba = 2 * d * inner + inner * d + inner * (2 * self.ssm_state)
            n_attn_uses = L // max(1, self.attn_every)
            body = L * mamba + (attn + 3 * d * self.d_ff)  # one shared block
            del n_attn_uses
        else:
            body = L * (attn + ff)
        emb = self.padded_vocab * d
        enc = self.encoder_layers * (attn + ff)
        return body + emb + enc

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if not self.moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        dh = self.head_dim_
        attn = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) + (self.n_heads * dh) * d
        ff_active = 3 * d * self.d_ff * self.top_k
        return L * (attn + ff_active) + self.padded_vocab * d


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS: List[str] = [
    "internvl2_26b",
    "seamless_m4t_large_v2",
    "gemma3_12b",
    "deepseek_67b",
    "qwen2_1_5b",
    "gemma_7b",
    "granite_moe_1b_a400m",
    "llama4_scout_17b_a16e",
    "zamba2_2_7b",
    "xlstm_350m",
]


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def cell_is_skipped(cfg: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    """Return a skip reason for (arch, shape), or None if the cell runs.

    ``long_500k`` requires a sub-quadratic serving path; pure full-attention
    archs skip it.
    """
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return "long_500k skipped: pure full-attention architecture"
    return None


# ---------------------------------------------------------------------------
# Logical-axis sharding rules
# ---------------------------------------------------------------------------

def mesh_rules(mode: str, mesh_axis_names: Sequence[str]) -> Dict[str, Any]:
    """Logical axis -> mesh axes, per run mode (``train`` | ``decode`` |
    ``decode_long``).

    ``batch`` spreads over the pure-DP axes ("pod","data"); ``kv_seq`` is the
    decode KV-cache sequence dim: sharded over "model" so huge caches fit,
    except in long_500k where batch=1 cannot use "data", so the cache
    spreads over both.  Embed/mlp/heads follow standard Megatron TP; in
    training the weights' output dims shard over ("model", "data") (FSDP).
    """
    has_pod = "pod" in mesh_axis_names
    dp: Any = ("pod", "data") if has_pod else ("data",)
    fsdp = ("model", "data") if mode == "train" else "model"
    rules: Dict[str, Any] = {
        "batch": dp,
        "vocab": "model",
        "embed": None,
        "layers": None,
        "heads": "model",
        "kv_heads": None,     # replicated unless divisible — set per arch
        "q_dim": fsdp,        # flattened H*dh projections
        "mlp": fsdp,
        "experts": "model",
        "expert_cap": None,
        "seq": None,
        "kv_seq": None,
        "state": None,
        "conv": None,
    }
    if mode == "decode":
        rules["kv_seq"] = "model"
    if mode == "decode_long":
        # batch=1: KV pages spread over data AND model
        rules["batch"] = None
        rules["kv_seq"] = ("data", "model")
        rules["heads"] = "model"
    return rules


def logical_to_spec(logical: Sequence[Optional[str]],
                    rules: Mapping[str, Any]) -> Tuple:
    """Translate logical axis names to a spec (the JAX ``PartitionSpec``'s
    entries as a tuple).

    A mesh axis may appear only once per tensor: when a later logical axis
    requests an already-used mesh axis, the used *component* is dropped
    (e.g. MoE (experts->model, mlp->(model,data)) yields (model, ..., data)).
    """
    out = []
    used: set = set()
    for name in logical:
        axis = rules.get(name) if name is not None else None
        if axis is not None:
            flat = (axis,) if isinstance(axis, str) else tuple(axis)
            keep = tuple(a for a in flat if a not in used)
            used.update(keep)
            axis = None if not keep else (keep[0] if len(keep) == 1 else keep)
        out.append(axis)
    return tuple(out)
