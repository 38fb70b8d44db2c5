"""The system under test, ``repro_torch``, as the benchmark drives it.

Everything the harness takes from the program is here: the architecture
config by its name (with the configuration file's overrides, held to the
file's ``run`` sizes), the trainer and its step (``Trainer.run``, whose
feed is the benchmark's pool of batches), the serving model and
``launch.serve.generate``, and the optimizer's state after a step. Nothing
else of the program is read, and nothing the program made reaches the
reference: the weights and the batches come from the benchmark.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import weights

#: ``run`` keys held against an attribute of a different name
_ATTR = {"head_dim": "resolved_head_dim"}


def arch_config(cfgfile: dict):
    """The port's ``ArchConfig`` of the configuration file: ``arch`` with
    ``overrides``; every key of ``run`` must read the same on it."""
    from repro_torch.configs import get_config

    over = dict(cfgfile.get("overrides", {}))
    if "pattern" in over:
        over["pattern"] = tuple(over["pattern"])
    cfg = get_config(cfgfile["arch"], **over)
    bad = []
    for key, want in cfgfile["run"].items():
        have = getattr(cfg, _ATTR.get(key, key))
        if isinstance(have, tuple):
            have = list(have)
        if have != want:
            bad.append(f"{key}: program {have!r}, file {want!r}")
    if bad:
        raise ValueError("the program's config departs from the configuration file: "
                         + "; ".join(bad))
    return cfg


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


class TrainDriver:
    """``repro_torch.runtime.Trainer`` on the configuration, its weights
    replaced by the benchmark's and its feed by the pool; :meth:`step` is
    one ``Trainer.run(1)`` (the step, then the loss read back)."""

    def __init__(self, cfgfile: dict, traffic: dict, spec, seed: int, device,
                 pool: List[Dict[str, np.ndarray]]):
        from repro_torch.runtime import Trainer, TrainerConfig

        self.cfg = arch_config(cfgfile)
        opt = traffic["optimizer"]
        tcfg = TrainerConfig(seq_len=traffic["seq_len"], global_batch=traffic["batch"],
                             optimizer=opt["name"], peak_lr=opt["peak_lr"],
                             warmup=opt["warmup"], total_steps=opt["total_steps"])
        self.trainer = Trainer(self.cfg, tcfg, device=device)
        self.device = self.trainer.device
        self.spec, self.seed, self.opt = spec, seed, opt
        weights.load_into(self.trainer.state.model.named_parameters(), spec, seed)
        self.trainer._data = itertools.cycle(pool)

    def step(self) -> float:
        return self.trainer.run(1)["losses"][0]

    def first_grads(self) -> Dict[str, float]:
        """Each parameter's gradient norm as AdamW took it in the first
        step, from its first moment: m / (1 - b1)."""
        from repro_torch.models.model import param_leaves

        st = self.trainer.state
        names = {id(p): n for n, p in st.model.named_parameters()}
        out = {}
        with torch.no_grad():
            for path, ps in param_leaves(st.model).items():
                for p, m in zip(ps, st.opt_state[f"m/{path}"]):
                    out[names[id(p)]] = float(torch.linalg.vector_norm(m.float())
                                              / (1 - self.opt["b1"]))
        return out

    def change(self) -> Dict[str, float]:
        """Each parameter's distance from the drawn weights."""
        named = dict(self.trainer.state.model.named_parameters())
        with torch.no_grad():
            return {n: float(torch.linalg.vector_norm(named[n].float() - w))
                    for n, w in weights.draw(self.spec, self.seed, self.device)}

    def free(self) -> None:
        del self.trainer


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Served:
    """What one request gave back: the first tokens (B,) on the host and
    the prefill's last-position logits (B, padded vocab)."""
    tokens: torch.Tensor
    logits: torch.Tensor


class PrefillDriver:
    """A serving ``repro_torch.models.model.Model`` of the configuration
    holding the benchmark's weights (in the dtypes the model serves them);
    :meth:`request` is one ``launch.serve.generate(model, prompts, 0)``:
    the prefill and its first token on the host."""

    def __init__(self, cfgfile: dict, traffic: dict, spec, seed: int, device,
                 pool: List[Dict[str, np.ndarray]]):
        from repro_torch.models.model import Model

        self.cfg = arch_config(cfgfile)
        self.device = torch.device(device)
        with torch.inference_mode():
            self.model = Model(self.cfg, device=self.device)
            weights.load_into(self.model.named_parameters(), spec, seed)
        self.prompts = [torch.from_numpy(b["tokens"]).long().to(self.device) for b in pool]

    def request(self, i: int) -> Tuple[float, Served]:
        """Request ``i`` (the pool's batch ``i`` modulo its size): seconds
        from its submission to its first tokens on the host, and what it
        gave back."""
        from repro_torch.launch.serve import generate

        prompts = self.prompts[i % len(self.prompts)]
        with torch.inference_mode():
            t0 = time.perf_counter()
            toks, rec = generate(self.model, prompts, 0)
            first = toks[:, 0].cpu()
            t1 = time.perf_counter()
        return t1 - t0, Served(first, rec["logits"][:, -1])

    def free(self) -> None:
        del self.model


def driver(kind: str):
    return {"train": TrainDriver, "prefill": PrefillDriver}[kind]


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device: Optional[torch.device]) -> None:
    import gc

    gc.collect()
    if device is not None and device.type == "cuda":
        torch.cuda.empty_cache()
