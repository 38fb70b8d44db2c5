"""Optimizers of the port (``repro.optim`` without the int8 gradient
compression, which needs a mesh: ROADMAP.md, Queue A item 8)."""
from .optimizers import (  # noqa: F401
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    make_optimizer,
    sgdm,
)
