"""Train, prefill and serve steps: the port of ``repro.runtime.trainstep``.

``make_train_step`` returns ``(state, batch) -> (state, metrics)``: the loss
and its gradients (in the masters' dtype with one microbatch, as
``jax.grad``'s; summed in float32 over ``cfg.microbatches`` and divided by
their number, as the JAX step accumulates), then one optimizer update.
The JAX step is a pure function; here the state is updated in place (the
parameters, the optimizer's states and ``step``) and returned. The sharding
specs and ``grad_spec_constraint`` are not ported: one card, no mesh
(ROADMAP.md, Queue A item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from ..models.config import ArchConfig
from ..models.model import Model, decode_step, loss_fn, param_leaves, prefill
from ..optim.optimizers import Leaves, Optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer's states and the step."""
    model: Model
    opt_state: Leaves
    step: int

    @property
    def params(self) -> Leaves:
        """The parameters as leaves of the JAX params pytree."""
        return param_leaves(self.model)


def make_train_step(cfg: ArchConfig, optimizer: Optimizer
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, object]]]:
    """The train step. ``cfg.microbatches`` sets the gradient accumulation;
    the loss itself follows the model's own config. Metrics: ``loss`` and
    ``grad_norm`` (float32 scalar tensors on the model's device, the norm
    before clipping) and ``step`` (the step this update was)."""
    mb = max(1, cfg.microbatches)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        params = state.params
        model.zero_grad(set_to_none=True)
        acc = {}
        if mb == 1:
            loss = loss_fn(model, batch)
            loss.backward()
            loss = loss.detach()
        else:
            # the gradients accumulate in float32, g_1 + g_2 + ..., in order,
            # then divided by mb, as the JAX sum: a float32 master's in its
            # .grad, another's (bfloat16) in a float32 accumulator its .grad
            # is added to after each microbatch
            loss = torch.zeros((), dtype=torch.float32, device=model.embed.device)
            for i in range(mb):
                b_i = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                       for k, v in batch.items()}
                l_i = loss_fn(model, b_i)
                l_i.backward()
                loss = loss + l_i.detach()
                for ps in params.values():
                    for p in ps:
                        if p.dtype != torch.float32:
                            acc[p] = (p.grad.float() if p not in acc
                                      else acc[p].add_(p.grad.float()))
                            p.grad = None
            n = torch.full((), mb, dtype=torch.float32, device=loss.device)
            loss = loss / n
            for ps in params.values():
                for p in ps:
                    (acc[p] if p in acc else p.grad).div_(n)
        grads = {k: [acc.get(p, p.grad) for p in ps] for k, ps in params.items()}
        grad_norm = global_norm(grads)
        optimizer.update(grads, state.opt_state, params, state.step)
        del grads, acc
        model.zero_grad(set_to_none=True)
        metrics = {"loss": loss, "grad_norm": grad_norm, "step": state.step}
        state.step += 1
        return state, metrics

    return train_step


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
