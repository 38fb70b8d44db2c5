"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000. Griffin-style RG-LRU + local attention, 1 attention : 2
recurrent [arXiv:2402.19427]. Sub-quadratic => ``long_500k`` runs.
26 layers = 8 units x (rglru, rglru, sliding) + 2 rglru tail.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    pattern=("rglru", "rglru", "sliding"),
    window=2048,
    rope_theta=10_000.0,
    tie_embeddings=True,
    logits_chunk=512,
)

SMOKE = ArchConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=3,
    d_model=96,
    n_heads=2,
    n_kv_heads=1,
    d_ff=192,
    vocab=512,
    head_dim=48,
    pattern=("rglru", "rglru", "sliding"),
    window=32,
    tie_embeddings=True,
    remat="none",
)
