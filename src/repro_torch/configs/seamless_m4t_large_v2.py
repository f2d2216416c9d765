"""SeamlessM4T-large-v2 [arXiv:2308.11596]: encoder-decoder; speech frontend
is a stub (frame embeddings arrive precomputed). 24L enc + 24L dec."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless_m4t_large_v2", family="audio",
    n_layers=24, encoder_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    ffn_act="swiglu", frontend="audio", frontend_tokens=4096,
    remat="dots",
    note="audio frontend is a stub: input_specs provides frame embeddings",
)

SMOKE_CONFIG = ArchConfig(
    name="seamless_m4t_large_v2_smoke", family="audio",
    n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, frontend="audio", frontend_tokens=16,
)
