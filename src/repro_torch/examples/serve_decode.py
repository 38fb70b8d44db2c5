"""Serving example: prefill a batch of prompts, then batched greedy decode
with the KV-cache/recurrent-state serve step.

The twin of the JAX package's ``examples/serve_decode.py`` (B 4, S 32, 16
steps, the smoke config), through ``repro_torch.launch.serve.generate``.
On the card recurrentgemma-2b's prefill runs the RG-LRU scan kernel.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode [arch] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_smoke
from repro_torch.core.torch_solve import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import init_params


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="recurrentgemma-2b")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch)
    B, S, steps = 4, 32, 16
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        model = init_params(cfg, gen)
        prompts = torch.randint(2, cfg.vocab, (B, S), generator=gen, device=dev)
        toks, rec = generate(model, prompts, steps)
    print(f"prefill {B}x{S} in {rec['prefill_s']:.2f}s")
    print(f"decoded {steps} tokens/seq in {rec['decode_s']:.2f}s "
          f"({B * steps / rec['decode_s']:.1f} tok/s batched on {dev})")
    print(f"rglru_scan kernel launches: prefill {rec['prefill_launches']}, "
          f"decode {rec['decode_launches']}")
    for b in range(B):
        print(f"  seq{b}: {toks[b].tolist()}")


if __name__ == "__main__":
    main()
