"""Gemma3-12B [hf:google/gemma-3; unverified]: 5:1 local:global attention,
sliding window 1024, head_dim 256, GeGLU, 262k vocab, 128k context."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3_12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab_size=262144, head_dim=256,
    sliding_window=1024, local_global_ratio=5,
    ffn_act="geglu", rope_theta=1e6, remat="dots",
    note="long_500k RUNS: sliding-window dominant (5:1) keeps decode caches "
         "O(window) for 5/6 of layers; global layers page over data axis",
)

SMOKE_CONFIG = ArchConfig(
    name="gemma3_12b_smoke", family="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16,
    sliding_window=16, local_global_ratio=5, ffn_act="geglu",
)
