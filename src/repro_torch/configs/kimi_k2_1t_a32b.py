"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) vocab=163840,
MoE 384 experts top-8 (+1 shared), expert d_ff=2048, first layer dense
[arXiv:2501.kimi2]. Trillion-param MoE; bf16 params + Adafactor states so the
256-chip dry-run fits HBM (see DESIGN.md). Pure full attention => skip
long_500k.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=112,
    pattern=("full",),
    ffn_kind="moe",
    n_experts=384,
    top_k=8,
    n_shared_experts=1,
    moe_dff=2048,
    first_k_dense=1,
    rope_theta=50_000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    optimizer="adafactor",
    logits_chunk=512,
)

SMOKE = ArchConfig(
    name="kimi-k2-smoke",
    family="moe",
    n_layers=3,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    head_dim=16,
    pattern=("full",),
    ffn_kind="moe",
    n_experts=8,
    top_k=2,
    n_shared_experts=1,
    moe_dff=128,
    first_k_dense=1,
    tie_embeddings=False,
    remat="none",
)
