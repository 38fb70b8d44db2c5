"""Architecture configs the port runs (exact) + reduced smoke variants.

A copy of ``repro.configs`` for the architectures the port serves and
trains: ``get_config(name)`` returns the full config, ``get_smoke(name)``
the reduced same-family variant for CPU tests. ``ALL_ARCHS`` lists them:
every architecture of the JAX package. A name outside them raises
``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ArchConfig

ALL_ARCHS: List[str] = [
    "yi_9b",
    "gemma3_4b",
    "qwen2_1_5b",
    "phi4_mini_3_8b",
    "xlstm_350m",
    "recurrentgemma_2b",
    "phi_3_vision_4_2b",
    "whisper_tiny",
    "arctic_480b",
    "kimi_k2_1t_a32b",
]

# canonical dashed ids -> module names
ALIASES: Dict[str, str] = {
    "yi-9b": "yi_9b",
    "gemma3-4b": "gemma3_4b",
    "qwen2-1.5b": "qwen2_1_5b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "xlstm-350m": "xlstm_350m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "whisper-tiny": "whisper_tiny",
    "arctic-480b": "arctic_480b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
}


def _module(name: str):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ALL_ARCHS:
        raise KeyError(f"unknown architecture {name!r} (known: {', '.join(sorted(ALIASES))})")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str, **overrides) -> ArchConfig:
    cfg = _module(name).CONFIG
    if overrides:
        import dataclasses

        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_smoke(name: str, **overrides) -> ArchConfig:
    cfg = _module(name).SMOKE
    if overrides:
        import dataclasses

        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
