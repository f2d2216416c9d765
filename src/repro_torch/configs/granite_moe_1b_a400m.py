"""Granite-3.0-1B-A400M [hf:ibm-granite]: 32 experts, top-8, d_ff=512/expert."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite_moe_1b_a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    moe=True, n_experts=32, top_k=8, capacity_factor=1.25,
    ffn_act="swiglu", remat="full",
    note="long_500k SKIPPED: pure full attention",
)

SMOKE_CONFIG = ArchConfig(
    name="granite_moe_1b_a400m_smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab_size=512, moe=True, n_experts=4, top_k=2,
)
