"""Analytic cost model: MODEL_FLOPS and memory footprints per (arch, cell).

A copy of ``repro.models.costs`` (pure Python; the port never imports the
JAX package). ``chip_smoke.py`` reads each train step's model FLOPs here.

MODEL_FLOPS follows the assignment's definition — 6*N*D for training (N =
params, D = tokens) and 2*N*D for inference, with N_active for MoE. The
compiled-HLO FLOPs exceed this by (a) attention O(S^2) terms, (b) remat
recompute, (c) vocabulary softmax; the dry-run reports the ratio so the waste
is visible (§Roofline).
"""
from __future__ import annotations

from typing import Dict

from .config import ArchConfig, ShapeCell


def model_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.seq_len * cell.global_batch
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.seq_len * cell.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * cell.global_batch


def attention_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    """Quadratic attention extra (not in 6ND): QK^T and PV matmuls."""
    kinds = list(cfg.pattern) * cfg.n_units + list(cfg.tail_kinds)
    hd = cfg.resolved_head_dim
    total = 0.0
    for kind in kinds:
        if kind not in ("full", "sliding"):
            continue
        S = cell.seq_len
        eff = min(cfg.window, S) if kind == "sliding" else S
        if cell.kind == "decode":
            per_seq = 2 * 2 * eff * cfg.n_heads * hd  # one query token
            mult = 1.0
        else:
            per_seq = 2 * 2 * S * eff * cfg.n_heads * hd * 0.5  # causal half
            mult = 3.0 if cell.kind == "train" else 1.0  # fwd+bwd
        total += per_seq * mult * cell.global_batch
    return total


def param_bytes(cfg: ArchConfig) -> int:
    bpp = 2 if cfg.param_dtype == "bfloat16" else 4
    return cfg.param_count() * bpp


def kv_cache_bytes(cfg: ArchConfig, cell: ShapeCell) -> int:
    kinds = list(cfg.pattern) * cfg.n_units + list(cfg.tail_kinds)
    hd = cfg.resolved_head_dim
    total = 0
    for kind in kinds:
        if kind == "full":
            L = cell.seq_len
        elif kind == "sliding":
            L = min(cfg.window, cell.seq_len)
        else:  # recurrent state: O(1)
            if kind == "mlstm":
                di = 2 * cfg.d_model
                total += cell.global_batch * (di // cfg.n_heads) ** 2 * cfg.n_heads * 4
            else:
                total += cell.global_batch * cfg.d_model * 4 * 4
            continue
        total += 2 * cell.global_batch * L * cfg.n_kv_heads * hd * 2  # bf16 K+V
    return total


def decode_hbm_bytes(cfg: ArchConfig, cell: ShapeCell) -> int:
    """Decode is memory-bound: every step streams params + the KV cache."""
    return param_bytes(cfg) + kv_cache_bytes(cfg, cell)


def summarize(cfg: ArchConfig, cell: ShapeCell) -> Dict[str, float]:
    return {
        "params": float(cfg.param_count()),
        "active_params": float(cfg.active_param_count()),
        "model_flops": model_flops(cfg, cell),
        "attention_flops": attention_flops(cfg, cell),
        "param_bytes": float(param_bytes(cfg)),
        "kv_cache_bytes": float(kv_cache_bytes(cfg, cell)),
    }
