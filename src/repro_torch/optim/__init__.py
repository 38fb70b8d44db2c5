"""Optimizers of the port and the int8 error-feedback gradient compression
(``repro.optim``)."""
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
from .compress import ef_int8_compress, ef_int8_decompress  # noqa: F401
