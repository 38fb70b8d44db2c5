"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304.

Alternating mLSTM / sLSTM blocks [arXiv:2405.04517]; attention-free so blocks
carry their own projections (d_ff=0 => no separate FFN). O(1) decode state =>
``long_500k`` runs.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=("mlstm", "slstm"),
    tie_embeddings=True,
    attn_parallelism="ddp",
    fsdp=False,
)

SMOKE = ArchConfig(
    name="xlstm-350m-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab=512,
    pattern=("mlstm", "slstm"),
    tie_embeddings=True,
    remat="none",
)
