"""DeepSeek-67B [arXiv:2401.02954]: llama-arch dense, 95L, GQA kv=8."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek_67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=102400,
    ffn_act="swiglu", rope_theta=1e4, tie_embeddings=False, remat="dots",
    note="long_500k SKIPPED: pure full attention",
)

SMOKE_CONFIG = ArchConfig(
    name="deepseek_67b_smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab_size=512, tie_embeddings=False,
)
