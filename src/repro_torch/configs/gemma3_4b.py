"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention pattern, 128k context, head_dim=256
[hf:google/gemma-3-*-pt]. Mostly-local attention => ``long_500k`` decode runs
(global layers are O(seq) per decoded token); see DESIGN.md.
34 layers = 5 units x (5 sliding + 1 full) + 4 sliding tail.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab=262144,
    head_dim=256,
    pattern=("sliding",) * 5 + ("full",),
    window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    logits_chunk=512,
    microbatches=2,  # dense fp32 embed-grad of the 262k vocab: fits 16GiB HBM this way
)

SMOKE = ArchConfig(
    name="gemma3-4b-smoke",
    family="dense",
    n_layers=6,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=1024,
    head_dim=32,
    pattern=("sliding",) * 2 + ("full",),
    window=64,
    tie_embeddings=True,
    remat="none",
)
