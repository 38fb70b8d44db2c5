"""Training launcher, single-job mode.

    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \
        --batch 2 --seq-len 2048 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --batch 8 --seq-len 2048 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \
        --smoke --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \
        --batch 8 --seq-len 2048 --steps 3

The port of ``repro.launch.train``'s single-job mode: the same flags and
defaults, plus ``--device`` (default ``cuda``; it raises when torch sees no
GPU). ``--arch`` is recurrentgemma-2b, qwen2-1.5b, gemma3-4b (which
accumulates its gradients over ``microbatches=2``) or xlstm-350m. Weights come from a
``torch.Generator`` seeded with the trainer's seed (0), data from the
synthetic pipeline. It prints the parameter count, the steps, the first and
last loss, steps/s and tokens/s (wall time of ``Trainer.run``, kernel
builds and warm-up included), and the launches of every kernel wrapper
(qwen2-1.5b, gemma3-4b and xlstm-350m launch none). ``--scheduler`` (the OEF-scheduled
multi-tenant mode) and ``--mesh`` are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step, then auto-recover")
    ap.add_argument("--mesh", type=str, default=None, help="not ported yet")
    # scheduler mode
    ap.add_argument("--scheduler", type=str, default=None,
                    choices=["oef-coop", "oef-noncoop"], help="not ported yet")
    ap.add_argument("--tenants", type=str, default="qwen2-1.5b,gemma3-4b,xlstm-350m")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    if args.scheduler:
        raise NotImplementedError(
            "--scheduler (OEF-scheduled multi-tenant training) is not ported to "
            "repro_torch yet (ROADMAP.md, Queue A item 5)")
    if args.mesh:
        raise NotImplementedError(
            "--mesh is not ported to repro_torch yet: it trains on one card "
            "(ROADMAP.md, Queue A item 8)")
    if not args.arch:
        ap.error("--arch required")
    run_single(args)


def run_single(args) -> dict:
    from ..configs import get_config, get_smoke
    from ..kernels import launch_counts
    from ..runtime import Trainer, TrainerConfig
    from ..runtime.trainer import SimulatedFailure

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix=f"oef-train-{cfg.name}-")
    t = Trainer(cfg, TrainerConfig(seq_len=args.seq_len, global_batch=args.batch,
                                   peak_lr=args.lr, total_steps=args.steps,
                                   ckpt_dir=ckpt, ckpt_every=args.ckpt_every),
                device=args.device)
    print(f"training {cfg.name} on {t.device}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch} x {args.seq_len} tokens, ckpt -> {ckpt}")
    before = launch_counts()
    try:
        out = t.run(args.steps, fail_at=args.fail_at)
    except SimulatedFailure as e:
        print(f"!! {e} — recovering from checkpoint")
        step = t.restore_latest()
        print(f"   restored step {step}; resuming")
        out = t.run(args.steps - step)
    rate = out["steps"] / max(out["seconds"], 1e-9)
    print(f"done: step {out['final_step']}, "
          f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, "
          f"{rate:.2f} steps/s, {rate * args.batch * args.seq_len:.1f} tokens/s")
    after = launch_counts()
    print("kernel launches: " + ", ".join(f"{k} {after[k] - before[k]}" for k in after))
    return out


if __name__ == "__main__":
    main()
