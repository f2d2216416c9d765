"""Llama4-Scout-17B-16E [hf:meta-llama; unverified]: MoE 16 experts top-1,
early fusion (text path modeled; fusion frontend out of assignment scope)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4_scout_17b_a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    moe=True, n_experts=16, top_k=1, capacity_factor=1.25,
    ffn_act="swiglu", rope_theta=5e5, tie_embeddings=False, remat="full",
    note="long_500k SKIPPED: full attention in this implementation",
)

SMOKE_CONFIG = ArchConfig(
    name="llama4_scout_17b_a16e_smoke", family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=64, vocab_size=512, moe=True, n_experts=4, top_k=1,
    tie_embeddings=False,
)
