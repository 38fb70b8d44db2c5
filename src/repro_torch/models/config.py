"""Architecture configuration for the unified model family.

One ``ArchConfig`` describes any of the 10 assigned architectures (plus the
reduced smoke variants). The model is a sequence of *blocks*; blocks repeat in
a ``pattern`` unit that is stacked and ``lax.scan``-ed (HLO size independent
of depth). Supported mixer kinds:

  - "full"    : global causal GQA attention (RoPE, optional QKV bias)
  - "sliding" : local sliding-window GQA attention
  - "mlstm"   : xLSTM matrix-memory block (attention-free)
  - "slstm"   : xLSTM scalar-memory block (attention-free)
  - "rglru"   : RG-LRU gated linear recurrence (Griffin/RecurrentGemma)

FFN kinds: "swiglu" (dense) or "moe" (top-k routed experts, optional dense
residual branch and shared experts).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None
    pattern: Tuple[str, ...] = ("full",)
    window: int = 1024
    qkv_bias: bool = False

    # FFN / MoE
    ffn_kind: str = "swiglu"  # swiglu | moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False  # Arctic: dense SwiGLU in parallel
    n_shared_experts: int = 0  # Kimi: always-on shared expert(s)
    moe_dff: int = 0  # expert FFN width (defaults to d_ff)
    first_k_dense: int = 0  # leading layers use dense FFN (Kimi: 1)

    # Encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0  # fixed encoder context if > 0

    # Modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None
    input_kind: str = "tokens"  # tokens | embeddings

    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True

    # numerics / perf knobs
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    optimizer: str = "adamw"  # adamw | adafactor | sgdm (dry-run train_step)
    attn_parallelism: str = "auto"  # auto (context-parallel ZeRO-3) | head (TP)
    fsdp: bool = True  # False: replicate params (small archs — kills gathers)
    microbatches: int = 1  # gradient accumulation (python-unrolled: honest HLO)
    opt_state_dtype: str = "float32"  # bfloat16 halves optimizer-state traffic
    grad_spec_constraint: bool = False  # constrain grads to param specs (RS)
    remat: str = "full"  # none | dots | full
    attention_impl: str = "xla"  # xla | blocked | pallas
    attention_block_q: int = 512
    attention_block_kv: int = 1024
    scan_layers: bool = True
    logits_chunk: int = 0  # >0: chunked cross-entropy (§Perf lever)

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0 and not self.scan_layers:
            pass  # tail handled at build time

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so TP sharding always divides
        (whisper's 51865 is the only assigned vocab that needs it)."""
        return _round_up(self.vocab, 256)

    @property
    def resolved_moe_dff(self) -> int:
        return self.moe_dff if self.moe_dff else self.d_ff

    @property
    def n_units(self) -> int:
        body = self.n_layers - self.first_k_dense
        return body // len(self.pattern)

    @property
    def tail_kinds(self) -> Tuple[str, ...]:
        body = self.n_layers - self.first_k_dense
        return self.pattern[: body % len(self.pattern)]

    @property
    def is_attention_free(self) -> bool:
        kinds = set(self.pattern) | set(self.tail_kinds)
        return kinds.isdisjoint({"full", "sliding"})

    @property
    def has_full_attention_only(self) -> bool:
        kinds = set(self.pattern) | set(self.tail_kinds)
        return kinds == {"full"}

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs: SSM / hybrid / mostly-local attention."""
        kinds = set(self.pattern) | set(self.tail_kinds)
        if not kinds & {"full", "sliding"}:
            return True  # attention-free
        if "full" not in kinds:
            return True  # local attention only
        # mostly-local patterns (gemma3's 5:1) qualify for decode-only shapes
        n_full = sum(1 for k in self.pattern if k == "full")
        return n_full / len(self.pattern) <= 0.25

    # -- parameter counting (for 6ND roofline + memory budgeting) ----------
    def param_count(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        kinds = list(self.pattern) * self.n_units + list(self.tail_kinds)
        kinds = ["full"] * 0 + kinds  # body kinds
        total = self.padded_vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.padded_vocab * d
        dense_ffn = 3 * d * self.d_ff
        moe_ffn = self.n_experts * 3 * d * self.resolved_moe_dff + d * self.n_experts
        if self.n_shared_experts:
            moe_ffn += self.n_shared_experts * 3 * d * self.resolved_moe_dff
        if self.moe_dense_residual:
            moe_ffn += dense_ffn

        def mixer_params(kind: str) -> int:
            if kind in ("full", "sliding"):
                p = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
                if self.qkv_bias:
                    p += (n_q + 2 * n_kv) * hd
                return p
            if kind == "mlstm":
                dp = 2 * d  # up-projection factor 2
                return 2 * d * dp + 3 * dp * (dp // 1) // max(1, 1) + dp * d  # approx
            if kind == "slstm":
                return 4 * d * d + 2 * d * (self.d_ff if self.d_ff else 3 * d)
            if kind == "rglru":
                dr = int(1.0 * d)
                return 2 * d * dr + 2 * dr * dr // max(1, self.n_heads) + dr * d
            raise ValueError(kind)

        for i in range(self.first_k_dense):
            total += mixer_params(self.pattern[0] if self.pattern else "full") + dense_ffn + 2 * d
        for kind in kinds:
            ffn = dense_ffn if self.ffn_kind == "swiglu" else moe_ffn
            total += mixer_params(kind) + ffn + 2 * d
        for _ in range(self.encoder_layers):
            # encoder self-attn + cross-attn K/V live in decoder; count enc
            total += mixer_params("full") + dense_ffn + 2 * d
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared instead of all)."""
        if self.ffn_kind != "moe":
            return self.param_count()
        d = self.d_model
        all_moe = self.n_experts * 3 * d * self.resolved_moe_dff
        active_moe = (self.top_k + self.n_shared_experts) * 3 * d * self.resolved_moe_dff
        n_moe_layers = self.n_units * len(self.pattern) + len(self.tail_kinds)
        return int(self.param_count() - n_moe_layers * (all_moe - active_moe))


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (shape) cell: what to lower and at what size."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)


def shape_cell(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(name)
