"""Gemma-7B [arXiv:2403.08295]: GeGLU, head_dim=256, MHA (kv=16)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma_7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    d_ff=24576, vocab_size=256000, head_dim=256,
    ffn_act="geglu", rope_theta=1e4, remat="dots",
    note="long_500k SKIPPED: pure full attention",
)

SMOKE_CONFIG = ArchConfig(
    name="gemma_7b_smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=192, vocab_size=512, head_dim=32, ffn_act="geglu",
)
