"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064. RoPE + SwiGLU + GQA [arXiv:2412.08905]. Pure full attention =>
skip long_500k.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200064,
    pattern=("full",),
    rope_theta=10_000.0,
    tie_embeddings=True,
    logits_chunk=512,
)

SMOKE = ArchConfig(
    name="phi4-mini-smoke",
    family="dense",
    n_layers=4,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=256,
    vocab=640,
    pattern=("full",),
    tie_embeddings=True,
    remat="none",
)
