"""Token traffic from a seed: a frozen copy of the port's synthetic corpus
(``repro_torch/data/pipeline.py`` ``SyntheticTokens``: documents of
exponential length, ids drawn from a Zipf-like law over the vocabulary,
ids 0 and 1 reserved, each document closed by the end id, packed into rows
of ``seq_len + 1``), and the pools of batches a run draws from it.

A traffic file (``bench/traffic/<name>.json``) gives the kind (``train``
or ``prefill``), the batch, the sequence length, the draw (``doc_len_mean``,
``eos_id``) and ``pool``, how many distinct batches a run makes before its
window and then takes in turn.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


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


def pool(traffic: dict, vocab: int, seed: int) -> List[Dict[str, np.ndarray]]:
    """``traffic["pool"]`` distinct batches of ``tokens`` and ``targets``
    (batch, seq_len) int32, every row drawn anew from the seed. The one
    generator and loop there are: a Zipf draw, one client in a closed loop."""
    draw = traffic["draw"]
    if draw["law"] != "zipf" or traffic["loop"] != {"kind": "closed", "clients": 1}:
        raise ValueError(f"traffic this harness cannot make: draw {draw!r}, "
                         f"loop {traffic['loop']!r}")
    gen = SyntheticTokens(vocab, traffic["seq_len"], traffic["batch"],
                          seed=np.random.SeedSequence([seed, 0x7A1F]).generate_state(1)[0],
                          doc_len_mean=draw["doc_len_mean"], eos_id=draw["eos_id"])
    return [gen.next_batch() for _ in range(traffic["pool"])]
