"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped, the rest of a run is driven at
smoke size on the CPU, and one fault is planted in the program at a time.
One chip: no exchange between chips to leave out."""
import pytest
import torch

import bench_smoke as S
from bench.harness import cli


def _run(cell, seed=2**32 + 3):
    w = S.MAN.cell(cell)
    return cli.run_cell(S.MAN, cell, seed, 0.2, False, "cpu", cfgfile=S.config(w["config"]),
                        traffic=S.traffic(cell))


def _unchanged_state(mp):
    """The optimizer's update returns the state as it was."""
    import repro_torch.runtime.trainer as tr
    from repro_torch.optim.optimizers import Optimizer

    make = tr.make_optimizer

    def broken(*a, **kw):
        opt = make(*a, **kw)
        return Optimizer(opt.name, opt.init, lambda grads, state, params, step, placed=None:
                         (params, state))

    mp.setattr(tr, "make_optimizer", broken)


def _half_batch(mp):
    """The loss of the first half of the rows, the mean taken over them."""
    import repro_torch.runtime.trainstep as ts

    loss_fn = ts.loss_fn
    mp.setattr(ts, "loss_fn", lambda model, batch: loss_fn(
        model, {k: v[: v.shape[0] // 2] for k, v in batch.items()}))


def _loss_altered(mp):
    """The step's loss altered by 1% where it is produced."""
    import repro_torch.runtime.trainstep as ts

    loss_fn = ts.loss_fn
    mp.setattr(ts, "loss_fn", lambda model, batch: loss_fn(model, batch) * 1.01)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _loss_altered],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("cell", S.cells("train"))
def test_a_broken_training_step_is_not_correct(cell, fault, monkeypatch):
    assert _run(cell)["correct"] is True
    fault(monkeypatch)
    r = _run(cell)
    assert r["correct"] is False, r["compared"]


def _mixers_unchanged(mp):
    """Every layer's mixer leaves the residual stream as it was."""
    from repro_torch.models.model import Block

    state = Block._mixer_state
    mp.setattr(Block, "_mixer_state", lambda self, x, cache_len, split=None: (
        lambda out: (torch.zeros_like(out[0]), out[1]))(state(self, x, cache_len, split)))


def _prefill_wrapped(mp, change):
    import repro_torch.launch.serve as sv

    make = sv.make_prefill_step

    def broken(model, cache_len):
        step = make(model, cache_len)
        return lambda batch: change(step, batch)

    mp.setattr(sv, "make_prefill_step", broken)


def _half_prompts(mp):
    """Only the first half of the prompts is prefilled; the rest take its
    results."""
    def change(step, batch):
        B = batch["tokens"].shape[0]
        cache, logits = step({k: v[: B // 2] for k, v in batch.items()})
        return cache, torch.cat([logits, logits], dim=0)[:B]

    _prefill_wrapped(mp, change)


def _token_altered(mp):
    """The first prompt's served token is not its best one."""
    def change(step, batch):
        cache, logits = step(batch)
        logits = logits.clone()
        row = logits[0, -1]
        row[row.argmax()] = row.min() - 1
        return cache, logits

    _prefill_wrapped(mp, change)


@pytest.mark.parametrize("fault", [_mixers_unchanged, _half_prompts, _token_altered],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("cell", S.cells("prefill"))
def test_a_broken_prefill_is_not_correct(cell, fault, monkeypatch):
    assert _run(cell)["correct"] is True
    fault(monkeypatch)
    r = _run(cell)
    assert r["correct"] is False, r["compared"]
