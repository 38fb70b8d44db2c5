"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

PEAKS = {
    "bf16_flops": 989e12,
    "fp32_flops": 67e12,
    "hbm_bytes_s": 3.35e12,
    "hbm_bytes": 80e9,
}
