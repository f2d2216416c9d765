"""Qwen2-1.5B [arXiv:2407.10671]: GQA kv=2, QKV bias."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_1_5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, ffn_act="swiglu", rope_theta=1e6,
    note="long_500k SKIPPED: pure full attention",
)

SMOKE_CONFIG = ArchConfig(
    name="qwen2_1_5b_smoke", family="dense",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
    d_ff=96, vocab_size=512, qkv_bias=True,
)
