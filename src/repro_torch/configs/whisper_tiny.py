"""whisper-tiny [audio]: 4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865.

Encoder-decoder with conv audio frontend STUBBED per the assignment —
``input_specs()`` supplies precomputed frame embeddings (B, S, d) to the
encoder [arXiv:2212.04356]. Sinusoidal positions (rope_theta=0). Vocab 51865
padded to 51968 for TP divisibility. Full attention + fixed encoder context =>
skip long_500k.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    pattern=("full",),
    encoder_layers=4,
    frontend="audio",
    rope_theta=0.0,  # sinusoidal absolute positions
    tie_embeddings=True,
    remat="full",  # 32k-frame attention scores dominate memory otherwise
    attn_parallelism="ddp",
    fsdp=False,
)

SMOKE = ArchConfig(
    name="whisper-tiny-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=128,
    vocab=384,
    pattern=("full",),
    encoder_layers=2,
    frontend="audio",
    rope_theta=0.0,
    tie_embeddings=True,
    remat="none",
)
