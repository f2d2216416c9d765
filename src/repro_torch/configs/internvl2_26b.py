"""InternVL2-26B [arXiv:2404.16821]: InternViT frontend (stub) + InternLM2-20B
backbone. Backbone dims per assignment; vision patches arrive pre-embedded."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2_26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92553,
    ffn_act="swiglu", rope_theta=1e6, frontend="vision", frontend_tokens=256,
    tie_embeddings=False, remat="dots",
    note="vision frontend is a stub: input_specs provides patch embeddings",
)

SMOKE_CONFIG = ArchConfig(
    name="internvl2_26b_smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    ffn_act="swiglu", frontend="vision", frontend_tokens=8,
    tie_embeddings=False,
)
