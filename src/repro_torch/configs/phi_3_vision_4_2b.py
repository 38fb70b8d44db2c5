"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (GQA kv=32, i.e. MHA)
d_ff=8192 vocab=32064. phi3-mini text backbone + CLIP vision frontend STUBBED:
``input_specs()`` supplies precomputed patch/text embeddings (B, S, d) for
train/prefill; decode consumes tokens via the embed table
[hf:microsoft/Phi-3-vision-128k-instruct]. Pure full attention => skip
long_500k.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    pattern=("full",),
    frontend="vision",
    input_kind="embeddings",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="phi3v-smoke",
    family="vlm",
    n_layers=3,
    d_model=96,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    pattern=("full",),
    frontend="vision",
    input_kind="embeddings",
    tie_embeddings=True,
    remat="none",
)
