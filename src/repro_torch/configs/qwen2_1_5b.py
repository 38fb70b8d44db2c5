"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

GQA with QKV bias [arXiv:2407.10671]. Pure full attention => skip long_500k.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    pattern=("full",),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    logits_chunk=512,
)

SMOKE = ArchConfig(
    name="qwen2-1.5b-smoke",
    family="dense",
    n_layers=4,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=288,
    vocab=512,
    pattern=("full",),
    qkv_bias=True,
    tie_embeddings=True,
    remat="none",
)
