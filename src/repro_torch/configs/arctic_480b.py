"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + *dense SwiGLU residual* branch
[hf:Snowflake/snowflake-arctic-base]. Pure full attention => skip long_500k.
56 heads don't divide the 16-way model axis => attention runs in
sequence-parallel (SP) mode (see distributed/sharding.py).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    pattern=("full",),
    ffn_kind="moe",
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    moe_dff=4864,
    rope_theta=10_000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    optimizer="adafactor",
)

SMOKE = ArchConfig(
    name="arctic-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab=512,
    pattern=("full",),
    ffn_kind="moe",
    n_experts=4,
    top_k=2,
    moe_dense_residual=True,
    moe_dff=160,
    tie_embeddings=False,
    remat="none",
)
