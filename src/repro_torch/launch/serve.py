"""Serving launcher: prefill a batch of prompts, decode N tokens greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
        --batch 8 --prompt-len 2048 --decode-steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \
        --batch 8 --prompt-len 2048 --decode-steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
        --batch 8 --prompt-len 1500 --decode-steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch kimi-k2-1t-a32b \
        --smoke --device cpu

The port of ``repro.launch.serve``: the same flags and defaults, plus
``--device`` (default ``cuda``; it raises when torch sees no GPU).
``--arch`` is one of ``repro_torch.configs.ALIASES``: recurrentgemma-2b,
qwen2-1.5b, gemma3-4b, xlstm-350m, yi-9b, phi4-mini-3.8b,
phi-3-vision-4.2b (whose prompts enter as embeddings, built from the
prompt tokens as the JAX launcher builds them; it decodes tokens) or
whisper-tiny (whose encoder takes ``--prompt-len`` frames of bf16 normals
beside the prompt tokens, as the JAX launcher draws them: the audio
frontend is a stub), or the MoE models arctic-480b and kimi-k2-1t-a32b
(at full depth neither fits one card; ``chip_smoke.py`` serves them at
full width and two layers). Weights, prompts and frames come from a
``torch.Generator`` seeded with ``--seed``. A
first run of the same prefill and decode builds any kernel and warms up,
and is reported apart; then the timed prefill and decode run. On the card
every RG-LRU layer's prefill scan is the CUDA kernel, a decode step runs
no kernel, and under the default ``attention_impl="xla"`` the other models
launch none at all (their attention is the plain grouped einsum and the
xLSTM mixers plain torch, as the JAX model's; whisper's encoder and
cross-attention never take the blocked path); a config with
``attention_impl="blocked"`` launches the flash kernel once per attention
layer a prefill. The launches of every kernel wrapper are printed.

Serving on a mesh: ``repro_torch.runtime.place_on_mesh(model, mesh,
global_batch)`` on every rank of a ``DeviceMesh`` (as JAX's launcher, this
one takes no mesh flag), then :func:`generate` with the global batch's
prompts on every rank: each rank serves its rows and its share of the
model, and every rank gets the whole batch's tokens.
"""
from __future__ import annotations

import argparse
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..distributed import parallel as P
from ..kernels import launch_counts
from ..models.model import Model, _whole
from ..obs.clock import wall
from ..runtime import make_prefill_step, make_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def audio_frames(cfg, batch: int, frames: int,
                 generator: torch.Generator) -> torch.Tensor:
    """An encoder model's stubbed audio input: (batch, frames, d_model)
    standard normals in bf16, drawn in float32 on ``generator``'s device
    (the JAX launcher draws ``jax.random.normal`` in bf16)."""
    return torch.randn((batch, frames, cfg.d_model), generator=generator,
                       device=generator.device).to(torch.bfloat16)


def prompt_batch(model: Model, prompts: torch.Tensor,
                 frames: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The prefill batch of prompt tokens (B, S): ``{"tokens": prompts}``;
    for an ``embeddings`` model ``{"embeds": ...}``, as the JAX launcher
    builds them: the tokens' rows of the table in bf16 times sqrt(d_model),
    a float32 product (JAX promotes bf16 times a numpy scalar to float32);
    the model casts them to its compute dtype. An encoder model's batch is
    ``{"frames", "tokens"}``: ``frames`` (B, T, d) as given, else S frames
    of :func:`audio_frames` from a generator on the prompts' device seeded
    with 0 (the JAX launcher ties the frames' length to the prompt's)."""
    cfg = model.cfg
    if cfg.encoder_layers:
        if frames is None:
            gen = torch.Generator(device=prompts.device).manual_seed(0)
            frames = audio_frames(cfg, prompts.shape[0], prompts.shape[1], gen)
        return {"frames": frames, "tokens": prompts}
    if cfg.input_kind != "embeddings":
        return {"tokens": prompts}
    with _whole(model, [model]):  # the whole table on a mesh
        rows = F.embedding(prompts, model.embed.to(torch.bfloat16))
    return {"embeds": rows.float() * math.sqrt(cfg.d_model)}


def generate(model: Model, prompts: torch.Tensor, steps: int,
             frames: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, object]]:
    """Prefill ``prompts`` (B, S) (:func:`prompt_batch`, with an encoder
    model's ``frames``) with a cache of S + steps + 8 positions, as the
    JAX launcher sizes it, then ``steps`` greedy decode steps.

    Returns the tokens (B, steps + 1) (the prefill's argmax, then one per
    step) and a record: wall seconds of the prefill and of the decode loop
    (each ends in a device sync), the RG-LRU kernel launches in each
    (``prefill_launches``, ``decode_launches``) and those of every kernel
    wrapper (``prefill_kernel_launches``, ``decode_kernel_launches``, by
    wrapper name), the prefill's last-position logits and the last decode
    step's logits.

    On a mesh (a model placed by ``runtime.place_on_mesh``) ``prompts`` and
    ``frames`` are the global batch's: each rank serves its rows, and the
    tokens and both logits are gathered over the batch's mesh dims, so
    every rank returns the whole batch's. The record then also holds the
    collectives of the prefill and of the decode loop by kind
    (``prefill_collectives``, ``decode_collectives``: [calls, bytes of this
    rank's inputs], ``distributed.parallel.COUNTS``) and ``rows``, this
    rank's slice of the batch.
    """
    rows = model.rows
    B = prompts.shape[0]
    if rows is not None:
        prompts = rows.rows(prompts)
        frames = rows.rows(frames) if frames is not None else None
    prefill_step = make_prefill_step(model, prompts.shape[1] + steps + 8)
    serve_step = make_serve_step(model)
    vocab = model.cfg.vocab
    dev = prompts.device
    batch = prompt_batch(model, prompts, frames)
    _sync(dev)
    P.reset_counts()
    k0, t0 = launch_counts(), wall()
    cache, logits = prefill_step(batch)
    tok = torch.argmax(logits[:, -1, :vocab], dim=-1)[:, None]
    _sync(dev)
    k1, t1 = launch_counts(), wall()
    c1 = {k: list(v) for k, v in P.COUNTS.items()}
    P.reset_counts()
    outs = [tok]
    last_logits = logits
    for _ in range(steps):
        cache, tok, last_logits = serve_step(cache, tok)
        outs.append(tok)
    _sync(dev)
    k2, t2 = launch_counts(), wall()
    c2 = {k: list(v) for k, v in P.COUNTS.items()}
    pre = {k: k1[k] - k0[k] for k in k0}
    dec = {k: k2[k] - k1[k] for k in k0}
    toks = torch.cat(outs, dim=1)
    rec = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
           "prefill_launches": pre["rglru_scan"], "decode_launches": dec["rglru_scan"],
           "prefill_kernel_launches": pre, "decode_kernel_launches": dec,
           "logits": logits, "last_logits": last_logits}
    if rows is not None:
        toks, rec["logits"], rec["last_logits"] = (
            rows.gather(t.contiguous()) for t in (toks, logits, last_logits))
        per = B // rows.blocks
        rec.update(prefill_collectives=c1, decode_collectives=c2,
                   rows=(rows.block * per, (rows.block + 1) * per))
    return toks, rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from ..configs import get_config, get_smoke
    from ..core.torch_solve import resolve_device
    from ..models import init_params

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    B, S, steps = args.batch, args.prompt_len, args.decode_steps
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    with torch.inference_mode():
        model = init_params(cfg, gen)
        prompts = torch.randint(2, cfg.vocab, (B, S), generator=gen, device=dev)
        frames = audio_frames(cfg, B, S, gen) if cfg.encoder_layers else None
        t0 = wall()
        generate(model, prompts, steps, frames)
        warm_s = wall() - t0
        toks, rec = generate(model, prompts, steps, frames)
    print(f"{cfg.name} on {dev}: warm-up (a first prefill and decode, kernel "
          f"build included) {warm_s:.2f}s")
    print(f"prefill {B}x{S}: {rec['prefill_s']:.3f}s "
          f"({B * S / rec['prefill_s']:.1f} tok/s)")
    print(f"decode {steps} steps: {rec['decode_s']:.3f}s "
          f"({B * steps / rec['decode_s']:.1f} tok/s)")
    print(f"rglru_scan kernel launches: prefill {rec['prefill_launches']}, "
          f"decode {rec['decode_launches']}")
    for phase in ("prefill", "decode"):
        counts = rec[f"{phase}_kernel_launches"]
        print(f"kernel launches in {phase}: "
              + ", ".join(f"{k} {n}" for k, n in counts.items()))
    for b in range(min(B, 4)):
        print(f"  seq{b}: {toks[b][:16].tolist()}{'...' if steps > 15 else ''}")


if __name__ == "__main__":
    main()
