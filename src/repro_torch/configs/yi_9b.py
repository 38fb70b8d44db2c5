"""yi-9b [dense]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

Llama-architecture GQA decoder [arXiv:2403.04652]. Pure full attention —
``long_500k`` is skipped per the assignment (sub-quadratic required).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    pattern=("full",),
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    logits_chunk=512,
)

SMOKE = ArchConfig(
    name="yi-9b-smoke",
    family="dense",
    n_layers=4,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=352,
    vocab=512,
    pattern=("full",),
    tie_embeddings=False,
    remat="none",
)
