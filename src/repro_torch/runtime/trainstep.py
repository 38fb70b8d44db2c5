"""Train, prefill and serve steps and the parameter sharding specs: the
port of ``repro.runtime.trainstep``.

``make_train_step`` returns ``(state, batch) -> (state, metrics)``: the loss
and its gradients (in the masters' dtype with one microbatch, as
``jax.grad``'s; summed in float32 over ``cfg.microbatches`` and divided by
their number, as the JAX step accumulates), then one optimizer update.
The JAX step is a pure function; here the state is updated in place (the
parameters, the optimizer's states and ``step``) and returned.

:func:`param_specs` and :func:`state_specs` are the JAX rules (FSDP over
``data``, TP / EP over ``model``) resolved per leaf path of the JAX pytree
(``models.param_leaves``' keys, the optimizer states' ``m/<path>``,
``<path>/vr``): a spec is a tuple of axis names, ``None`` or tuples (a
``PartitionSpec``'s entries), a stacked ``units/...`` leaf's with JAX's
leading unit dim; :func:`unit_spec` drops it for the port's per-unit
tensor. On a mesh (``zero``, ``repro_torch.distributed.zero``) the step
runs this rank's share of the compute (its rows, and its block of the
sequence, heads or experts where the model's view splits them): each
microbatch's loss times the rank's share of the split (``frac``), the
gradients reduced into the shards by the gathers' backward (one
reduce-scatter with ``cfg.grad_spec_constraint``, else an all-reduce and
a slice: the same numbers), the reported loss summed over the split's
ranks, the norm and the optimizer's sums over the splitting mesh dims.

:func:`place_on_mesh` places a serving model (drawn meshless, or carried
from the JAX package by ``repro_torch.interop.model_from_jax``) on a mesh:
this rank's blocks of its parameters in :func:`param_specs`, the ``gather``
hook, the ``view`` and the batch's ``rows``, the trainer's ZeRO-3 storage
without gradients. ``make_prefill_step`` and ``make_serve_step`` then run
it unchanged, on this rank's rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..distributed import zero as Z
from ..distributed.sharding import ShardingPlan, Spec, make_plan, rank_view
from ..models.config import ArchConfig
from ..models.model import Model, _jax_path, decode_step, loss_fn, param_leaves, prefill
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


# ---------------------------------------------------------------------------
# Parameter sharding rules (FSDP over "data", TP/EP over "model")
# ---------------------------------------------------------------------------


def _param_spec(plan: ShardingPlan, names: Tuple[str, ...], shape: Tuple[int, ...]) -> Spec:
    if plan.mesh is None:
        return ()
    name = names[-1]
    # leading stacked-unit dim of the JAX pytree
    off = 1 if "units" in names else 0
    body = shape[off:]
    dims: list = [None] * len(shape)

    def md(size):
        return plan.model_dim(size)

    def fs(size):
        return plan.fsdp_dim(size)

    if name in ("vr", "vc"):  # adafactor factored stats: tiny, replicate
        return tuple(dims)
    if name == "embed" and len(body) == 2:
        dims[off:] = [md(body[0]), fs(body[1])]
    elif name == "head" and len(body) == 2:
        dims[off:] = [fs(body[0]), md(body[1])]
    elif name in ("wq", "wk", "wv", "w_in", "w_up", "w_x", "w_gate", "w_rec_in",
                  "router", "w_a", "w_i") and len(body) == 2:
        dims[off:] = [fs(body[0]), md(body[1])]
    elif name in ("wo", "w_out", "w_down") and len(body) == 2:
        dims[off:] = [md(body[0]), fs(body[1])]
    elif name == "w_in" and len(body) == 3:  # MoE experts (E, d, 2f)
        dims[off:] = [md(body[0]), fs(body[1]), None]
    elif name == "w_out" and len(body) == 3:  # MoE experts (E, f, d)
        dims[off:] = [md(body[0]), None, fs(body[1])]
    elif name in ("bq", "bk", "bv", "lam") and len(body) == 1:
        dims[off] = md(body[0])
    # norms / scales / small recurrent blocks stay replicated
    return tuple(dims)


def leaf_spec(cfg: ArchConfig, plan: ShardingPlan, path: str, shape: Tuple[int, ...]) -> Spec:
    """The JAX spec of the leaf at ``path`` of (JAX, stacked) ``shape``."""
    names = tuple(path.split("/"))
    if not cfg.fsdp:
        # replicate everything except the (possibly huge) vocab-dim tensors
        if names[-1] in ("embed", "head") and plan.mesh is not None:
            return _param_spec(plan, names, shape)
        return ()
    return _param_spec(plan, names, shape)


def _stacked(path: str) -> bool:
    return "units" in path.split("/")


def param_specs(cfg: ArchConfig, plan: ShardingPlan, leaves: Leaves) -> Dict[str, Spec]:
    """The spec of every leaf of ``leaves`` (a leaf path to its tensors, of
    any device, ``meta`` too), as the JAX ``param_specs`` gives it for the
    JAX leaf (a ``units/...`` leaf stacks its tensors on a new first dim)."""
    out = {}
    for path, ts in leaves.items():
        shape = tuple(ts[0].shape)
        out[path] = leaf_spec(cfg, plan, path,
                              (len(ts),) + shape if _stacked(path) else shape)
    return out


def unit_spec(path: str, spec: Spec) -> Spec:
    """The spec of one of the port's tensors of leaf ``path``: a stacked
    leaf's spec less its unit dim."""
    return tuple(spec[1:]) if _stacked(path) else tuple(spec)


def tensor_specs(cfg: ArchConfig, plan: ShardingPlan):
    """``specs(path, shape)``: the spec of one of the port's tensors of
    leaf ``path`` and per-unit ``shape`` (:func:`leaf_spec` of the stacked
    JAX leaf, less its unit dim)."""
    def specs(path: str, shape: Tuple[int, ...]) -> Spec:
        stacked = (cfg.n_units,) + tuple(shape) if _stacked(path) else tuple(shape)
        return unit_spec(path, leaf_spec(cfg, plan, path, stacked))

    return specs


def place_on_mesh(model: Model, mesh: Any, global_batch: int) -> Model:
    """``model`` (whole, serving, on its device) placed on ``mesh`` for
    serving a global batch of ``global_batch`` rows, in place: the plan of
    ``cfg.attn_parallelism`` (as the trainer makes it), each parameter cut
    to this rank's block of its :func:`param_specs` spec, the ``gather``
    hook, the ``view`` at this rank's coordinate and the batch's ``rows``
    (``zero.MeshSplit``). Every rank of the mesh calls it with the same
    model. A mesh on another device type than the model's raises, as the
    ``Trainer`` does."""
    cfg = model.cfg
    dev = model.embed.device.type
    if mesh.device_type != dev:
        raise ValueError(
            f"the mesh is on {mesh.device_type!r} devices but the model on {dev!r}: a cuda "
            f"mesh (NCCL, or gloo) serves on cuda, a cpu mesh (gloo) on the cpu")
    if not Z.in_mesh(mesh):
        raise ValueError(f"this rank is not in the mesh {mesh}")
    plan = make_plan(mesh, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                     prefer=cfg.attn_parallelism, global_batch=global_batch)
    rows = Z.MeshSplit(mesh, plan.batch(global_batch) or (), global_batch, 1,
                       plan.shape.model_axis)
    zero = Z.Zero(mesh, rows, tensor_specs(cfg, plan), cfg.grad_spec_constraint)
    zero.place(model, lambda name: _jax_path(cfg, name))
    model.gather = zero.gather
    model.view = rank_view(plan, mesh)
    model.rows = rows
    return model


@dataclasses.dataclass
class StateSpecs:
    params: Dict[str, Spec]
    opt_state: Dict[str, Spec]
    step: Spec = ()


def state_specs(cfg: ArchConfig, plan: ShardingPlan, state: Any) -> StateSpecs:
    """The specs of a ``TrainState`` (or anything with ``params`` and
    ``opt_state`` leaves): the optimizer states inherit their parameters'
    rules by name (ZeRO), Adafactor's ``vr`` / ``vc`` / ``v`` replicated,
    as the JAX ``state_specs``."""
    return StateSpecs(params=param_specs(cfg, plan, state.params),
                      opt_state=param_specs(cfg, plan, state.opt_state))


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def make_train_step(cfg: ArchConfig, optimizer: Optimizer, zero: Optional[Any] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, object]]]:
    """The train step. ``cfg.microbatches`` sets the gradient accumulation;
    the loss itself follows the model's own config. Metrics: ``loss`` and
    ``grad_norm`` (float32 scalar tensors on the model's device, the norm
    before clipping) and ``step`` (the step this update was). With
    ``zero`` (a mesh trainer's ``Zero``) the batch is this rank's rows,
    the model holds this rank's shards and runs its share."""
    mb = max(1, cfg.microbatches)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        params = state.params
        model.zero_grad(set_to_none=True)
        acc = {}
        if mb == 1:
            loss = loss_fn(model, batch)
            (loss if zero is None else loss * zero.split.frac).backward()
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
                (l_i if zero is None else l_i * zero.split.frac).backward()
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
        if zero is None:
            grad_norm = global_norm(grads)
            optimizer.update(grads, state.opt_state, params, state.step)
        else:
            loss = zero.split.sum(loss * zero.split.frac)
            placed = zero.placed_leaves(model, params)
            grad_norm = global_norm(grads, placed)
            optimizer.update(grads, state.opt_state, params, state.step, placed=placed)
        del grads, acc
        model.zero_grad(set_to_none=True)
        metrics = {"loss": loss, "grad_norm": grad_norm, "step": state.step}
        state.step += 1
        return state, metrics

    return train_step


def make_prefill_step(model: Model, cache_len: int):
    """``batch -> (cache, last-position logits)``; on a mesh the batch is
    this rank's rows (:func:`place_on_mesh`)."""
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
