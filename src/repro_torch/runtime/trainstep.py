"""Serving steps: the port of ``make_prefill_step`` and ``make_serve_step``
of ``repro.runtime.trainstep``. (The train step, its optimizers and the
sharding specs are not ported yet: ROADMAP.md, Queue A.)"""
from __future__ import annotations

from typing import Dict

import torch

from ..models.model import Model, decode_step, prefill


def make_prefill_step(model: Model, cache_len: int):
    def prefill_step(batch: Dict[str, torch.Tensor]):
        return prefill(model, batch, cache_len)

    return prefill_step


def make_serve_step(model: Model):
    """One decode step: greedy-sample next token from logits."""

    def serve_step(cache, tokens: torch.Tensor):
        new_cache, logits = decode_step(model, cache, tokens)
        next_tok = torch.argmax(logits[:, -1, : model.cfg.vocab], dim=-1)
        return new_cache, next_tok[:, None], logits

    return serve_step
