"""Deterministic synthetic data pipeline: a copy of ``repro.data.pipeline``.

Produces language-model batches (tokens/targets shifted by one) from a
Zipf-distributed synthetic corpus with document packing, in numpy, from a
seed: the same seed gives the JAX package's batches exactly. Each call
returns the *global* batch; the trainer copies it to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    doc_len_mean: int = 512
    eos_id: int = 1

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        # Zipf-ish unigram distribution over the vocab
        ranks = np.arange(2, self.vocab)  # ids 0 (pad) and 1 (eos) reserved
        probs = 1.0 / ranks.astype(np.float64)
        self._probs = probs / probs.sum()
        self._ids = ranks

    def _document(self) -> np.ndarray:
        n = max(8, int(self._rng.exponential(self.doc_len_mean)))
        toks = self._rng.choice(self._ids, size=n, p=self._probs)
        return np.concatenate([toks, [self.eos_id]])

    def next_batch(self) -> Dict[str, np.ndarray]:
        need = self.seq_len + 1
        rows = []
        for _ in range(self.batch):
            buf = []
            total = 0
            while total < need:
                d = self._document()
                buf.append(d)
                total += len(d)
            row = np.concatenate(buf)[:need]
            rows.append(row)
        arr = np.stack(rows).astype(np.int32)
        return {"tokens": arr[:, :-1], "targets": arr[:, 1:]}


def make_batch(cfg: ArchConfig, seq_len: int, batch: int, *, seed: int = 0,
               kind: str = "train") -> Dict[str, np.ndarray]:
    """One batch matching ``input_specs`` for any arch/frontend."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal((batch, seq_len, cfg.d_model)).astype(np.float32)
        out["tokens"] = rng.integers(2, cfg.vocab, (batch, seq_len)).astype(np.int32)
    elif cfg.input_kind == "embeddings":
        out["embeds"] = rng.standard_normal((batch, seq_len, cfg.d_model)).astype(np.float32)
    else:
        gen = SyntheticTokens(cfg.vocab, seq_len, batch, seed=seed)
        b = gen.next_batch()
        out["tokens"] = b["tokens"]
        if kind == "train":
            out["targets"] = b["targets"]
            return out
    if kind == "train":
        rng2 = np.random.default_rng(seed + 1)
        out["targets"] = rng2.integers(2, cfg.vocab, (batch, seq_len)).astype(np.int32)
    return out


def batch_iterator(cfg: ArchConfig, seq_len: int, batch: int, *, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = 0
    while True:
        yield make_batch(cfg, seq_len, batch, seed=seed + step)
        step += 1
