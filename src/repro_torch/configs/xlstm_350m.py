"""xLSTM-350M [arXiv:2405.04517; unverified]: xLSTM[7:1] — 7 chunked mLSTM
blocks per 1 sequential sLSTM block; d_ff=0 (blocks carry own projections)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm_350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    xlstm_slstm_every=8, remat="dots",
    note="long_500k RUNS: O(1) recurrent state. Paged-KV integration "
         "inapplicable (no KV cache) — PBM applies via the data pipeline only "
         "(DESIGN.md §5)",
)

SMOKE_CONFIG = ArchConfig(
    name="xlstm_350m_smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=512, xlstm_slstm_every=2,
)
