"""Zamba2-2.7B [arXiv:2411.15242]: Mamba2 backbone + ONE shared attention
block applied every 6 layers over concat([h, emb]) (parameter sharing)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2_2_7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, attn_every=6,
    ffn_act="swiglu", remat="dots",
    note="long_500k RUNS: O(1) SSM state; shared-attn KV pages over data axis",
)

SMOKE_CONFIG = ArchConfig(
    name="zamba2_2_7b_smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4, attn_every=2,
)
